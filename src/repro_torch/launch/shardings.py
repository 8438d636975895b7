"""Serve-time tensor parallelism: which leaves shard, on which axis.

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

A spec tree has the structure of its tree, with a placement
(``torch.distributed.tensor.Shard(dim)`` / ``Replicate()``) a leaf, the
JAX package's ``PartitionSpec`` leaves translated; a ``PackedBool`` leaf's
spec describes its ``bits``. ``shard_tree`` takes one rank's slice of
every leaf as a plain local tensor: the kernels take raw pointers, not
DTensors. The training half of the JAX package's ``shardings.py``
(``apply_policy``, ``train_microbatches``, ``batch_shardings``) comes with
the multi-device training slice.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core import PackedBool
from repro_torch.models import ModelConfig, block_roles

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
