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

The prefill and decode steps take the training placement of the params
(``train_param_specs``, no optimizer state; ``train.make_prefill_step`` /
``make_decode_step(shardings=)``), as the JAX package's dry run gives
its prefill and decode the specs of ``lm_init``, and the cache the JAX
package's ``cache_init`` specs (``cache_specs``): an attention block's
rows over ``cfg.cache_seq_axes`` and its batch over ``cfg.batch_axes``,
every KV head on every rank; a mamba block's state over the batch and
d_inner over "model".

The placement the port gives a training state (``train_param_specs``) is
the JAX package's (``lm_init``'s specs): FSDP of every large weight over
"data" (its non-"model" dim: each data rank holds a slice, a layer
group's slices are all-gathered per microbatch inside the group's remat
and their grads reduce-scattered, ``distributed.fsdp_gather``), and the
"model" split of the attention heads (q/k/v columns), of d_ff (the FFN's
gate/up columns and down rows), of the mamba d_inner (in_x / in_z /
dt_proj columns, x_proj / out_proj rows, the conv and the scan's
channels), of the experts and of the vocab (the embedding's rows and the
head's columns; the loss's softmax stays split). "pod" and "data" are the
batch axes: each rank takes its rows of the global batch. Two stated
differences from the JAX package's specs:

  1. ``wk`` / ``wv`` over "model": split when the KV heads divide the axis,
     replicated otherwise (``kv_replicated``), their votes then summed over
     "model" (the JAX package replicates them under 16 KV heads whatever
     the axis).
  2. ``wo``: FSDP over "data" but replicated over "model" (the JAX package
     splits its rows): the heads are gathered before it
     (``models.attention``), so its fan-in sums in the unsharded order.

Under a ``VoteOptimizer`` (EF-SignSGD) the Boolean leaves stay whole over
"data" (``train_param_specs(boolean_fsdp=False)``): the JAX package's
wrapper votes on grads replicated over the batch axes.

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

A serve spec tree has the structure of its tree, with a placement along
the "model" axis (``torch.distributed.tensor.Shard(dim)`` /
``Replicate()``) a leaf; a ``PackedBool`` leaf's spec describes its
``bits``. ``shard_tree`` takes one rank's slice of every leaf as a plain
local tensor: the kernels take raw pointers, not DTensors. A training
spec tree's leaves are ``distributed.placement.PartitionSpec``s over
("data", "model") (a cache's also over tuples of the mesh's axes), the
JAX package's ``PartitionSpec`` leaves; the JAX package's ``named`` is
``distributed.placement.named``, which pairs each spec with its mesh for
``place`` and ``gather_tree``.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core import PackedBool
from repro_torch.core.optimizer import tree_map
from repro_torch.distributed.placement import P, BatchRows
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
    scalars and step counters are replicated (``P()``)."""
    specs = train_param_specs(params) if specs is None else specs

    def walk(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, dict) and node.keys() == params.keys():
            return tree_map(lambda t, p, sp: sp if t.dim() == p.dim()
                            else P(), node, params, specs)
        return tree_map(lambda _: P(), node)

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


D, M = "data", "model"


def train_param_specs(params, replicate_kv: bool = False,
                      boolean_fsdp: bool = True):
    """Placement tree (the structure of ``params``, a ``PartitionSpec`` a
    leaf) for training: the JAX package's ``lm_init`` specs, leaf by leaf
    (module docstring; a stacked block leaf has a leading unsplit group
    axis, a bias follows its weight's output axis), with k/v replicated
    over "model" under ``replicate_kv`` (``kv_replicated``) and ``wo``
    replicated over "model". ``boolean_fsdp=False`` keeps every Boolean
    (int8) leaf whole over "data", as a ``VoteOptimizer`` needs."""
    lead = (None,)              # a stacked block leaf's group axis

    def proj(node, spec):
        out = {"w": P(*lead, *spec)}
        if "b" in node:
            out["b"] = P(*lead, spec[-1])
        return out

    def attn(node):
        kv = (D, None) if replicate_kv else (D, M)
        return {"wq": proj(node["wq"], (D, M)), "wk": proj(node["wk"], kv),
                "wv": proj(node["wv"], kv),
                "wo": proj(node["wo"], (None, D))}

    def ffn(node):
        return {"wg": proj(node["wg"], (D, M)),
                "wu": proj(node["wu"], (D, M)),
                "wd": proj(node["wd"], (M, D)), "tau": P(*lead, M)}

    def mamba(node):
        return {"in_x": proj(node["in_x"], (D, M)),
                "in_z": proj(node["in_z"], (D, M)),
                "conv_w": P(*lead, None, M), "conv_b": P(*lead, M),
                "x_proj": proj(node["x_proj"], (M, None)),
                "dt_proj": proj(node["dt_proj"], (D, M)),
                "dt_bias": P(*lead, M), "A_log": P(*lead, M, None),
                "D": P(*lead, M), "out_proj": proj(node["out_proj"], (M, D))}

    def moe(node):
        return {"router": P(*lead, None, M), "wg": P(*lead, M, D, None),
                "wu": P(*lead, M, D, None), "wd": P(*lead, M, None, D),
                "tau": P(*lead, None)}

    rules = {"attn": attn, "ffn": ffn, "mamba": mamba, "moe": moe}

    def block(node):
        return {k: (rules[k](v) if k in rules else _whole(v))
                for k, v in node.items()}

    specs = {k: _whole(v) for k, v in params.items()}
    specs["embed"] = {"table": P(M, D)}
    specs["head"] = {"w": P(D, M)}
    specs["blocks"] = {k: block(v) for k, v in params["blocks"].items()}
    _check_keys(params, specs)
    if not boolean_fsdp:
        specs = tree_map(lambda t, sp: P(*(None if a == D else a for a in sp))
                         if t.dtype == torch.int8 else sp, params, specs)
    return specs


def cache_specs(cfg: ModelConfig, cache):
    """Placement tree of a ``models.cache_init`` tree (its structure): the
    JAX package's ``cache_init`` specs. An attention block's k/v (and
    their scales under ``kv_cache_quant``) (G, batch, rows, KVp[, hd]):
    the batch over ``cfg.batch_axes``, the rows over
    ``cfg.cache_seq_axes``, the KV heads over "model" only where the rows
    are whole and the KV heads are 16 or more; a mamba block's ``h`` (G,
    batch, DI, N) and ``conv`` (G, batch, W-1, DI): the batch over the
    batch axes, d_inner over "model"; ``pos`` replicated."""
    def entry(axes):            # as the JAX package's spec reads them
        axes = tuple(axes)
        return axes[0] if len(axes) == 1 else (axes or None)

    batch, seq = entry(cfg.batch_axes), entry(cfg.cache_seq_axes)
    kv = M if cfg.n_kv_heads >= 16 and seq is None else None
    out = {}
    for i, role in enumerate(block_roles(cfg)):
        blk = cache["blocks"][f"b{i}"]
        if role["mixer"] == "mamba":
            out[f"b{i}"] = {"h": P(None, batch, M, None),
                            "conv": P(None, batch, None, M)}
        else:
            out[f"b{i}"] = {k: P(*(None, batch, seq, kv, None)[:t.dim()])
                            for k, t in blk.items()}
    return {"blocks": out, "pos": P()}


def _whole(node):
    """A replicated spec for every leaf of ``node``."""
    if isinstance(node, dict):
        return {k: _whole(v) for k, v in node.items()}
    return P()


def _check_keys(params, specs, path=""):
    """Every leaf of ``params`` has a spec and every spec a leaf."""
    if isinstance(params, dict):
        if not isinstance(specs, dict) or params.keys() != specs.keys():
            raise ValueError(f"train_param_specs: no rule for {path or '/'}: "
                             f"{sorted(params)}")
        for k in params:
            _check_keys(params[k], specs[k], f"{path}/{k}")


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
