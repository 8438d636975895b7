"""Per-cell sharding policy, and which leaves shard on which axis.

Training (the JAX package's ``apply_policy``, ``train_microbatches`` and
``batch_shardings``; ``apply_policy`` and ``train_microbatches`` read only
``mesh.shape`` and ``mesh.axis_names``):

  train_4k     batch → (pod, data); heads → model; grad accumulation so
               the per-device microbatch is a few samples.
  prefill_32k  batch → (pod, data); the emitted KV cache seq → model.
  decode_32k   batch → (pod, data); KV cache seq → model (int8 cache);
               the decode's softmax statistics combine over "model".
  long_500k    batch = 1: KV cache seq → every axis.

The placement the port gives the two training axes (``train_param_specs``)
keeps the JAX package's math and chooses where tensors live: "pod" and
"data" are data parallel — each rank takes its rows of the global batch,
parameters and optimizer state are replicated across them and the grads
are reduced over them once a step; "model" is head parallel, the serve
mesh's split below — the q/k/v projections shard on their output (head)
axis and everything else is replicated. Where the KV heads are fewer
than the axis (gemma2-2b's 4 on the production meshes' 16), k/v are
replicated as the JAX package places them (``kv_replicated``), and their
votes are summed over "model". The JAX package's FSDP of the
weights over "data" and its "model" split of d_ff, vocab and experts
change only memory and are not ported yet.

The serve mesh is 1-D ("model",) (launch/mesh.py). Only the attention head
axis shards: the q/k/v projections column-wise (the fused packed ``wqkv``
packed shard-major first, ``serve.engine.pack_weights(tp=)``) and the KV
page pools (k/v and, under kv_cache_quant, their per-(token, head) scale
pools) on the KVp axis. Everything else — embeddings, norms, the
o-projection, FFN/MoE/mamba weights, lane-indexed SSM state — stays
replicated: Boolean weights are 1-bit, so the replicated bytes are cheap,
and each rank's page-pool bytes (the decode bound) still shrink by the
shard count. ``wo`` is replicated on purpose: it is applied after an
all-gather of the head activations (``models.attention._wo_project``), so
its fan-in sums in the unsharded order; a row-sharded ``wo`` summed across
ranks would reassociate it, and ``sign()`` turns those ulps into token
flips.

A spec tree has the structure of its tree, with a placement along the
"model" axis (``torch.distributed.tensor.Shard(dim)`` / ``Replicate()``) a
leaf, the JAX package's ``PartitionSpec`` leaves translated; a
``PackedBool`` leaf's spec describes its ``bits``. ``shard_tree`` takes
one rank's slice of every leaf as a plain local tensor: the kernels take
raw pointers, not DTensors. The JAX package's ``named`` is
``distributed.placement.named``, which pairs each spec with its mesh for
``place`` and ``gather_tree``.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core import PackedBool
from repro_torch.core.optimizer import tree_map
from repro_torch.distributed.placement import BatchRows
from repro_torch.models import ModelConfig, block_roles

from .mesh import mesh_batch_axes
from .shapes import ShapeDef


def apply_policy(cfg: ModelConfig, shape: ShapeDef, mesh) -> ModelConfig:
    b_axes = mesh_batch_axes(mesh)
    batch_shards = 1
    for a in b_axes:
        batch_shards *= mesh.shape[a]

    common = dict(use_sharding_constraints=True)
    if shape.kind in ("train", "prefill"):
        return cfg.scaled(
            batch_axes=b_axes,
            cache_seq_axes=("model",) if shape.kind == "prefill" else (),
            moe_groups=min(batch_shards, shape.global_batch),
            **common,
        )
    if shape.name == "long_500k":
        return cfg.scaled(
            batch_axes=(),
            cache_seq_axes=tuple(mesh.axis_names),
            kv_cache_quant=False,
            moe_groups=1,
            **common,
        )
    # decode_32k
    return cfg.scaled(
        batch_axes=b_axes,
        cache_seq_axes=("model",),
        kv_cache_quant=True,
        moe_groups=1,
        **common,
    )


def train_microbatches(cfg: ModelConfig, shape: ShapeDef, mesh) -> int:
    """Grad-accumulation factor: target per-device microbatch by size tier."""
    b_axes = mesh_batch_axes(mesh)
    shards = 1
    for a in b_axes:
        shards *= mesh.shape[a]
    if cfg.d_model >= 5120:
        per_dev = 1
    elif cfg.d_model >= 4096:
        per_dev = 2
    else:
        per_dev = 4
    mb = max(1, shape.global_batch // (shards * per_dev))
    while shape.global_batch % (mb * shards) and mb > 1:
        mb -= 1
    return mb


def train_state_specs(params, opt_state, specs=None):
    """Placement tree of a training state ``{"params", "opt"}``: an
    optimizer-state leaf shaped like its parameter (Boolean accumulators,
    Adam moments, EF residuals) is placed as the parameter, the per-leaf
    scalars and step counters are replicated."""
    specs = train_param_specs(params) if specs is None else specs

    def walk(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, dict) and node.keys() == params.keys():
            return tree_map(lambda t, p, sp: sp if t.dim() == p.dim()
                            else Replicate(), node, params, specs)
        return tree_map(lambda _: Replicate(), node)

    return {"params": specs, "opt": walk(opt_state)}


def batch_shardings(cfg: ModelConfig, mesh, batch_specs):
    """Each batch leaf's ``BatchRows`` over ``cfg.batch_axes``."""
    return {k: BatchRows(mesh, tuple(cfg.batch_axes))
            for k in batch_specs}


_ATTN_COL = ("wq", "wk", "wv", "wqkv")


def _replicated(node):
    if isinstance(node, dict):
        return {k: _replicated(v) for k, v in node.items()}
    return Replicate()


def _last_axis(leaf) -> Shard:
    nd = (leaf.bits if isinstance(leaf, PackedBool) else leaf).dim()
    return Shard(nd - 1)


def serve_param_specs(params):
    """Placement tree (the structure of ``params``) for serve-time TP.

    Attention nodes are found by structure (a dict holding ``wo`` beside
    ``wq`` or ``wqkv``; mamba, FFN and MoE nodes never do): the q/k/v
    weights and biases shard on their OUTPUT (head) axis; every other leaf,
    ``wo`` included, is replicated."""
    def proj(node):
        return {k: (_last_axis(v) if k in ("w", "b") else _replicated(v))
                for k, v in node.items()}

    def walk(node):
        if not isinstance(node, dict):
            return Replicate()
        is_attn = "wo" in node and ("wq" in node or "wqkv" in node)
        return {k: (proj(v) if is_attn and k in _ATTN_COL else walk(v))
                for k, v in node.items()}

    return walk(params)


def kv_replicated(cfg: ModelConfig, tp: int) -> bool:
    """Whether a "model" axis of ``tp`` ranks replicates the k/v
    projections in training: its KV heads do not split over it
    (``ModelConfig.kv_heads_padded`` leaves KV heads fewer than the axis
    unpadded, "replicated over the model axis instead")."""
    return tp > 1 and cfg.kv_heads_padded() % tp != 0


def train_param_specs(params, replicate_kv: bool = False):
    """Placement tree for head-parallel training: ``serve_param_specs``'s,
    with the k/v weights and biases replicated under ``replicate_kv``
    (``kv_replicated``: every rank computes all KV heads and reads those
    its q heads need; their votes are summed over "model")."""
    specs = serve_param_specs(params)
    if not replicate_kv:
        return specs

    def walk(node, sp):
        if not isinstance(node, dict):
            return sp
        is_attn = "wo" in node and "wq" in node
        return {k: (_replicated(v) if is_attn and k in ("wk", "wv")
                    else walk(v, sp[k])) for k, v in node.items()}

    return walk(params, specs)


def serve_pool_specs(cfg: ModelConfig, pool):
    """Placement tree for a ``paged_pool_init`` tree under serve-time TP:
    attention pool leaves (G, n_pages, page, KVp[, hd]) shard on the KVp
    axis (dim 3); lane-indexed SSM state stays replicated."""
    out = {}
    for i, role in enumerate(block_roles(cfg)):
        blk = pool[f"b{i}"]
        out[f"b{i}"] = (_replicated(blk) if role["mixer"] == "mamba"
                        else {k: Shard(3) for k in blk})
    return out


def shard_tree(tree, specs, rank: int, tp: int):
    """Rank ``rank``'s local slice of every leaf of ``tree`` under
    ``specs``: a ``Shard(d)`` leaf's contiguous d-slice ``rank`` of ``tp``
    (a copy, so the whole leaf can free), a ``Replicate()`` leaf as it is.
    ``tp == 1`` returns the leaves themselves."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], rank, tp) for k, v in tree.items()}
    if tp == 1 or not isinstance(specs, Shard):
        return tree
    t = tree.bits if isinstance(tree, PackedBool) else tree
    n = t.shape[specs.dim]
    if n % tp:
        raise ValueError(f"shard_tree: axis {specs.dim} of {n} does not "
                         f"split {tp} ways")
    local = t.narrow(specs.dim, rank * (n // tp), n // tp) \
        .clone(memory_format=torch.contiguous_format)
    return PackedBool(local, tree.k) if isinstance(tree, PackedBool) \
        else local
