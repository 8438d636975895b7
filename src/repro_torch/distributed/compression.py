"""1-bit gradient compression with error feedback (EF-SignSGD), the JAX
package's ``distributed/compression.py``.

The paper's convergence abstraction (Appendix A.2) is EF-SignSGD: Q₀ =
stochastic sign, Q₁ = flip threshold, e_t = error accumulator. The Boolean
vote aggregation (Eq 7) distributes naturally: each data shard contributes
a ±1 vote per weight, and the cross-replica all-reduce sums the votes.

Usage: wrap the hybrid optimizer —
    opt = ef_signsgd_compressed(hybrid_optimizer(...), cfg.batch_axes)
and hand it to ``make_train_step(grad_shardings=)``: the step then leaves
the Boolean leaves' grads un-reduced per data shard (the votes replace
their fp32 all-reduce), and the error-feedback residual lives in the
optimizer state, bounding the compression bias (Lemma A.9).

The payload is the votes summed as int32, as the JAX package's code sums
them (its docstring's int8 payload is not what it computes): exact for
any number of ranks, and as many bytes as the fp32 grads.

One decision of the port's own: the wrapper agrees the scale across the
group. The JAX package's wrapper only sees replicated, already reduced
grads (its ``shard_map`` in-spec is replicated), so its per-leaf scale
mean|g + e| is the same on every device. Here it gets each rank's
un-reduced grads, and a per-rank scale would make the replicas' Boolean
updates, and so their weights, diverge; the wrapper uses the mean of the
ranks' scales (one fp32 scalar a leaf, all-reduced beside the votes),
which equals the JAX package's wherever its inputs are replicated. A
leaf split over "model" (q/k/v, the FFN's and the mamba block's
projections, the experts) takes its whole leaf's scale, the mean of its
slices' means, as the unsharded step does. The Boolean leaves stay whole
over "data" (``launch.shardings.train_param_specs(boolean_fsdp=False)``;
the step refuses a placement that cuts them), as the JAX package's
wrapper votes on grads replicated over the batch axes.
``compress_votes`` alone keeps the rank's own scale, as the JAX
package's does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.optimizer import (Optimizer, is_boolean_leaf,
                                        tree_leaves, tree_map,
                                        tree_unflatten)

from .context import get_mesh


class EFState(NamedTuple):
    inner: object
    error: object          # per-leaf error feedback residual (bf16)


def compress_votes(g: torch.Tensor, error: torch.Tensor, group,
                   scale: Optional[torch.Tensor] = None):
    """The e-corrected sign, its int32 votes summed over ``group`` (a
    process group; None: this rank alone, no collective), decoded as
    votes / n · scale, and the bf16 residual. ``scale``: the per-leaf
    magnitude, by default this rank's mean|g + e|. -> (decoded fp32,
    new residual bf16)."""
    corrected = g + error.to(g.dtype)
    sign = torch.where(corrected >= 0, 1, -1).to(torch.int8)
    # vote count across replicas (Boolean aggregation, Eq 7)
    votes = sign.to(torch.int32)
    n = 1 if group is None else dist.get_world_size(group)
    if n > 1:
        dist.all_reduce(votes, group=group)
    decoded = votes.to(torch.float32) / n
    if scale is None:
        scale = torch.mean(torch.abs(corrected))      # per-leaf magnitude
    decoded = decoded * scale
    new_error = (corrected - sign.to(g.dtype) * scale).to(torch.bfloat16)
    return decoded, new_error


class VoteOptimizer(NamedTuple):
    """An ``Optimizer`` whose update reduces the Boolean leaves' grads
    itself, over the mesh axes ``vote_axes`` (``make_train_step`` then
    leaves them un-reduced)."""
    init: object
    update: object
    vote_axes: Tuple[str, ...]


def ef_signsgd_compressed(inner: Optimizer, axes: Tuple[str, ...],
                          mesh=None) -> VoteOptimizer:
    """Optimizer wrapper: Boolean-leaf gradients arrive UN-reduced per data
    shard; this wrapper compresses and vote-reduces them over ``axes`` of
    ``mesh`` (default: the installed mesh) with error feedback, then
    delegates to ``inner``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)

    def init(params):
        err = tree_map(lambda p: (torch.zeros(p.shape, dtype=torch.bfloat16,
                                              device=p.device)
                                  if is_boolean_leaf(p) else None), params)
        return EFState(inner.init(params), err)

    @torch.no_grad()
    def update(grads, state, params, shardings=None):
        m = mesh or get_mesh()
        n = m.size_of(axes)
        group = m.group(axes) if n > 1 else None
        keys = [i for i, p in enumerate(tree_leaves(params))
                if is_boolean_leaf(p)]
        gs, es = tree_leaves(grads), tree_leaves(state.error)
        # each leaf's mean|g + e|; a leaf sharded over "model" holds equal
        # slices, so its whole-leaf mean is the mean of its slices' (one
        # all-reduce for all of them)
        scales = torch.stack([
            torch.mean(torch.abs(gs[i] + e.to(gs[i].dtype)))
            for i, e in zip(keys, es)]).to(torch.float32) if keys else None
        placed = [] if shardings is None else tree_leaves(shardings)
        split = [j for j, i in enumerate(keys)
                 if placed and placed[i].over("model") > 1]
        if split:
            scales[split] = m.all_reduce(scales[split], "model",
                                         count="count_reduces") \
                / m.shape["model"]
        # then the group's mean of the ranks' (one all-reduce)
        if keys and n > 1:
            m.all_reduce(scales, axes, count="vote_reduces")
            scales = scales / n
        dec = list(gs)
        for j, (i, e) in enumerate(zip(keys, es)):
            dec[i], new_e = compress_votes(gs[i], e, group, scales[j])
            if group is not None:
                m.counts["vote_reduces"] += 1
            e.copy_(new_e)
        new_params, inner_state = inner.update(
            tree_unflatten(grads, dec), state.inner, params,
            shardings=shardings)
        return new_params, EFState(inner_state, state.error)

    return VoteOptimizer(init, update, axes)
