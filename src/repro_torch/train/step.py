"""The training step: the paper's full recipe, as the JAX package's
``train/step.py`` builds it.

  1. view the int8 Boolean params as ±1 ``cfg.dtype`` tensors for one
     differentiation (no persistent FP latents);
  2. microbatched gradient accumulation, so activation memory is one
     microbatch; grads are summed in fp32 (``grad_accum_dtype``) — summing
     votes across microbatches IS the paper's Eq-7 batch aggregation, and
     on a training mesh so is their sum across the batch ranks;
  3. the Boolean flip-rule update for int8 leaves + Adam for FP leaves.
"""
from __future__ import annotations

import torch

from repro_torch.core.optimizer import (Optimizer, is_boolean_leaf,
                                        tree_leaves, tree_map,
                                        tree_unflatten)
from repro_torch.distributed.placement import BatchRows
from repro_torch.models import ModelConfig, lm_decode_step, lm_loss, lm_prefill
from repro_torch.spans import span


def bool_view(params, dtype=torch.bfloat16, wide=None, wide_dtype=None):
    """The tree to differentiate: int8 ±1 leaves viewed as ``dtype`` (a
    transient copy, bitwise determined by the Boolean weight), FP leaves
    detached; every leaf a leaf tensor with ``requires_grad``. ``wide``
    (a tree of bools like ``params``) marks leaves viewed at least as wide
    as ``wide_dtype``: the FSDP slices, whose reduce-scattered grads
    arrive summed at the accumulation dtype (``models.lm``) and must not
    be rounded again, and whose values the view keeps exactly."""
    def view(p, w=False):
        v = p.to(dtype) if is_boolean_leaf(p) else p.detach()
        if w:
            v = v.to(torch.promote_types(v.dtype, wide_dtype))
        return v.requires_grad_(True)
    if wide is None:
        return tree_map(view, params)
    return tree_map(view, params, wide)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    microbatches: int = 1,
                    grad_accum_dtype=torch.float32, grad_shardings=None):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "flips"})``. ``batch`` holds (B, S) ``tokens`` and ``labels``
    (and optionally ``loss_mask``) on the params' device; B is split into
    ``microbatches`` consecutive row blocks whose grads are summed in
    ``grad_accum_dtype``. The optimizer updates ``params`` and
    ``opt_state`` in place.

    ``grad_shardings``: the parameters' placement tree on a training mesh
    (``distributed.placement.named(mesh, train_param_specs(params))``); the
    step is then one rank's part of the sharded step, which computes what
    the unsharded step computes. ``params`` and ``opt_state`` are this
    rank's (``distributed.placement.place``); ``batch`` is the GLOBAL
    batch, of which the rank takes its rows of each microbatch
    (``BatchRows``). Each rank differentiates its share of each global
    microbatch's loss (its rows' weighted NLL over the microbatch's whole weight, and its routing
    groups' share of the MoE aux loss), so the grads summed over the batch
    axes, once after the microbatches, are the global grads — also below
    a ``sign_backward`` projection, where the loss's scale does not reach.
    A ``VoteOptimizer`` (``ef_signsgd_compressed``) reduces the Boolean
    leaves' grads itself, as votes: the step hands it each rank's share
    times the batch shard count, the rank's estimate of the global grad.
    ``cfg.moe_groups`` counts the global batch's routing groups; a rank's
    rows hold ``moe_groups`` / (its batch shards) of them.
    ``grad_shardings=None`` is the single-device step.

    A leaf cut over "data" (FSDP) is gathered in the forward and its grad
    reduce-scattered over "data" each microbatch, at ``grad_accum_dtype``
    (``models.lm``): it is not all-reduced over the batch axes again, only
    over "pod" where the mesh has one. Every other leaf's grad is
    all-reduced over the batch axes once, after the microbatches. A
    ``VoteOptimizer`` votes on grads whole over "data", as the JAX
    package's wrapper does: a placement that cuts a Boolean leaf over
    "data" raises (``train_param_specs(boolean_fsdp=False)``)."""
    mesh = axes = rows = None
    dp = 1
    fsdp = wide = None
    votes_reduced = getattr(optimizer, "vote_axes", None) is not None
    if grad_shardings is not None:
        mesh = next(sh.mesh for sh in tree_leaves(grad_shardings))
        axes = tuple(cfg.batch_axes)
        dp = mesh.size_of(axes)
        if cfg.moe_groups % dp and cfg.n_experts:
            raise ValueError(f"moe_groups={cfg.moe_groups} routing groups do "
                             f"not split over {dp} batch shards")
        cfg = cfg.scaled(moe_groups=max(cfg.moe_groups // dp, 1))
        rows = BatchRows(mesh, axes)
        wide = tree_map(lambda sh: sh.fsdp(), grad_shardings)
        fsdp = tree_leaves(wide)
    rest = tuple(a for a in (axes or ()) if a != "data")

    def grads_of(pf, leaves, mb, share):
        with span("train.forward"):
            loss, parts = lm_loss(cfg, pf, mb, grad_shardings,
                                  grad_accum_dtype)
            if share is not None:
                # this rank's share of the global microbatch's loss
                loss = parts["nll"] * share + 0.01 * parts["aux"] / dp
        with span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(l) if g is None else g
                               for l, g in zip(leaves, grads)]

    def train_step(params, opt_state, batch):
        shares = [None] * microbatches
        if rows is not None and dp > 1:
            shares = _shares(batch, microbatches, rows)
            batch = {k: rows.take(v, microbatches) for k, v in batch.items()}
        if votes_reduced and fsdp is not None:
            _check_votes_whole(params, grad_shardings, fsdp)
        pf = bool_view(params, cfg.dtype, wide, grad_accum_dtype)
        leaves = tree_leaves(pf)
        if microbatches == 1:
            loss, grads = grads_of(pf, leaves, batch, shares[0])
            # reduced in place below: a copy, as two leaves may share a
            # grad tensor
            grads = [g.to(torch.float32, copy=dp > 1) for g in grads]
        else:
            size = next(iter(batch.values())).shape[0]
            if size % microbatches:
                raise ValueError(f"batch of {size} rows does not split into "
                                 f"{microbatches} microbatches")
            n = size // microbatches
            loss = grads = None
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                mloss, g = grads_of(pf, leaves, mb, shares[i])
                loss = mloss if loss is None else loss + mloss
                if grads is None:
                    # a copy even at the grads' dtype: two leaves may share
                    # a grad tensor, which the in-place sums would then
                    # alter twice
                    grads = [gi.to(grad_accum_dtype, copy=True) for gi in g]
                else:
                    for a, gi in zip(grads, g):
                        a.add_(gi.to(grad_accum_dtype))
                del g
            loss = loss / microbatches
        if dp > 1:
            # the grads cross the batch ranks once, after the microbatches
            # (an FSDP slice's crossed "data" in its reduce-scatters)
            bool_leaves = tree_leaves(tree_map(is_boolean_leaf, params))
            for g, is_bool, cut in zip(grads, bool_leaves, fsdp):
                if votes_reduced and is_bool:
                    g.mul_(dp)
                elif cut:
                    mesh.all_reduce(g, rest)
                else:
                    mesh.all_reduce(g, axes)
            loss = mesh.all_reduce(loss.reshape(1).clone(), axes)[0]
        if microbatches > 1:
            for g in grads:
                g.div_(microbatches)
        del pf, leaves
        kw = {} if grad_shardings is None else {"shardings": grad_shardings}
        with span("train.optimizer"):
            new_params, new_state = optimizer.update(
                tree_unflatten(params, grads), opt_state, params, **kw)
        metrics = {"loss": loss.to(torch.float32),
                   "flips": _flip_total(new_state)}
        return new_params, new_state, metrics

    return train_step


def _check_votes_whole(params, shardings, fsdp) -> None:
    """Raise ``ValueError`` when a Boolean leaf is cut over "data" (a
    ``VoteOptimizer`` votes on grads whole over the batch axes)."""
    bad = [sh.name for sh, p, cut in zip(tree_leaves(shardings),
                                         tree_leaves(params), fsdp)
           if cut and is_boolean_leaf(p)]
    if bad:
        raise ValueError(
            "a VoteOptimizer votes on grads whole over 'data', but the "
            f"placement cuts Boolean leaves over it: {', '.join(bad[:3])}"
            + (f" and {len(bad) - 3} more" if len(bad) > 3 else "")
            + " (launch.shardings.train_param_specs(boolean_fsdp=False))")


def _shares(batch, microbatches, rows):
    """Each microbatch's share of its global loss that this rank's rows
    carry: their ``loss_mask`` weight over the microbatch's (every row
    weighs its tokens without a mask), from the global batch. 0-dim fp32
    tensors on the batch's device (no host sync): the fp64 quotient of
    the two fp32 sums rounded once to fp32, as a product with a Python
    float rounds it."""
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    w = torch.ones_like(labels, dtype=torch.float32) if mask is None \
        else mask.to(torch.float32)
    mine = rows.take(w, microbatches)
    n, m = w.shape[0] // microbatches, mine.shape[0] // microbatches
    return [(mine[i * m:(i + 1) * m].sum().double()
             / w[i * n:(i + 1) * n].sum().double().clamp(min=1.0))
            .to(torch.float32) for i in range(microbatches)]


def _flip_total(opt_state):
    flips = getattr(getattr(opt_state, "boolean", opt_state), "flips", None)
    leaves = tree_leaves(flips) if flips is not None else []
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return sum(leaves)


def make_prefill_step(cfg: ModelConfig, shardings=None):
    """Serving prefill: ``prefill_step(params, batch) -> (last-position
    logits, cache)`` over raw int8 params (per-layer transient float
    views), ``lm_prefill``'s cold route.

    ``shardings``: the parameters' placement on a training mesh
    (``distributed.placement.named(mesh, train_param_specs(params))``),
    as ``make_train_step(grad_shardings=)`` takes it; the step is then
    one rank's part of the JAX package's placed prefill: ``params`` are
    this rank's slices and ``batch`` its rows over ``cfg.batch_axes`` (the
    JAX package's batch sharding hands each device its rows; the training
    step takes the global batch for the loss weights of its microbatches,
    which a serving step has not); the logits are its rows', whole over
    the vocab, the cache its slab (``lm_prefill``)."""
    def prefill_step(params, batch):
        return lm_prefill(cfg, params, batch, shardings=shardings)
    return prefill_step


def make_decode_step(cfg: ModelConfig, shardings=None):
    """``decode_step(params, cache, batch) -> (logits, cache)``: one token
    (``batch["tokens"]`` or the (B, 1) tokens themselves) over a
    contiguous cache from ``cache_init`` (after ``lm_prefill``), updated in
    place. ``shardings``: as in ``make_prefill_step``; the tokens and the
    cache are this rank's rows, the cache its slab (``lm_decode_step``)."""
    def decode_step(params, cache, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return lm_decode_step(cfg, params, cache, tokens,
                              shardings=shardings)
    return decode_step
