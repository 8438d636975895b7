"""The training step: the paper's full recipe, as the JAX package's
``train/step.py`` builds it.

  1. view the int8 Boolean params as ±1 ``cfg.dtype`` tensors for one
     differentiation (no persistent FP latents);
  2. microbatched gradient accumulation, so activation memory is one
     microbatch; grads are summed in fp32 — summing votes across
     microbatches IS the paper's Eq-7 batch aggregation;
  3. the Boolean flip-rule update for int8 leaves + Adam for FP leaves.
"""
from __future__ import annotations

import torch

from repro_torch.core.optimizer import (Optimizer, is_boolean_leaf,
                                        tree_leaves, tree_map)
from repro_torch.models import ModelConfig, lm_loss


def bool_view(params, dtype=torch.bfloat16):
    """The tree to differentiate: int8 ±1 leaves viewed as ``dtype`` (a
    transient copy, bitwise determined by the Boolean weight), FP leaves
    detached; every leaf a leaf tensor with ``requires_grad``."""
    def view(p):
        v = p.to(dtype) if is_boolean_leaf(p) else p.detach()
        return v.requires_grad_(True)
    return tree_map(view, params)


def _unflatten(like, leaves):
    """Nested dict shaped like ``like`` from leaves in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    microbatches: int = 1):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "flips"})``. ``batch`` holds (B, S) ``tokens`` and ``labels``
    (and optionally ``loss_mask``) on the params' device; B is split into
    ``microbatches`` consecutive row blocks. The optimizer updates
    ``params`` and ``opt_state`` in place."""
    def grads_of(pf, leaves, mb):
        loss, _ = lm_loss(cfg, pf, mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(l) if g is None else g
                               for l, g in zip(leaves, grads)]

    def train_step(params, opt_state, batch):
        pf = bool_view(params, cfg.dtype)
        leaves = tree_leaves(pf)
        if microbatches == 1:
            loss, grads = grads_of(pf, leaves, batch)
            grads = [g.to(torch.float32) for g in grads]
        else:
            size = next(iter(batch.values())).shape[0]
            if size % microbatches:
                raise ValueError(f"batch of {size} rows does not split into "
                                 f"{microbatches} microbatches")
            rows = size // microbatches
            loss = grads = None
            for i in range(microbatches):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                mloss, g = grads_of(pf, leaves, mb)
                loss = mloss if loss is None else loss + mloss
                if grads is None:
                    # a copy even at fp32: two leaves may share a grad
                    # tensor, which the in-place sums would then alter twice
                    grads = [gi.to(torch.float32, copy=True) for gi in g]
                else:
                    for a, gi in zip(grads, g):
                        a.add_(gi)           # fp32 sum of the widened grads
                del g
            loss = loss / microbatches
            for g in grads:
                g.div_(microbatches)
        del pf, leaves
        new_params, new_state = optimizer.update(_unflatten(params, grads),
                                                 opt_state, params)
        metrics = {"loss": loss.to(torch.float32),
                   "flips": _flip_total(new_state)}
        return new_params, new_state, metrics

    return train_step


def _flip_total(opt_state):
    flips = getattr(getattr(opt_state, "boolean", opt_state), "flips", None)
    leaves = tree_leaves(flips) if flips is not None else []
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return sum(leaves)
