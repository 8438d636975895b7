"""Boolean optimizer (paper Alg 1 / Alg 8) + hybrid FP optimizer.

Per Boolean weight w ∈ {±1} with vote signal q = δLoss/δw:
    m ← β·m + η·q                       (Eq 10 accumulator)
    flip where  xnor(m, w) = T  ⇔  m·w ≥ 1   (Eq 9 / Alg 8)
    w ← ¬w  and  m ← 0 on flip
    β ← (#unchanged)/(#total) per layer      (Eq 11)

No FP latent weights: the stored parameter is int8 ±1 and ``m`` is optimizer
state reset on flip. FP leaves (embedding, head, norms, biases, thresholds)
take Adam. The partition rule is structural: **int8 leaves are Boolean**.

The arithmetic and its dtypes are those of the JAX package's
``core/optimizer.py`` (m summed in fp32 and stored at ``accum_dtype``;
schedules evaluated on fp32 tensors), and the state NamedTuples keep its
field names, which the checkpoint keys are made of. Parameter trees are
nested dicts of tensors; a ``None`` leaf is an absent one, as in the JAX
package's split trees. ``update`` runs under ``torch.no_grad`` and writes
the parameters and the state tensors in place (the trees it returns hold
the same tensors), so a full-width step holds no second copy of either.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Union

import torch

PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]  # step -> value
F32 = torch.float32


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of nested dicts; ``None`` stays."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Tensor leaves in sorted-key order (the JAX package's flatten order)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def _as_schedule(v: Union[float, Schedule]) -> Schedule:
    if callable(v):
        return v
    return lambda step: torch.tensor(v, dtype=F32)


def is_boolean_leaf(p) -> bool:
    return isinstance(p, torch.Tensor) and p.dtype == torch.int8


class BooleanOptState(NamedTuple):
    accum: PyTree          # accumulators at accum_dtype, like boolean leaves
    ratio: PyTree          # per-layer β (f32 scalar per boolean leaf)
    flips: PyTree          # last-step flip count per leaf (f32 scalar)
    step: torch.Tensor


class AdamState(NamedTuple):
    mu: PyTree
    nu: PyTree
    step: torch.Tensor


class HybridState(NamedTuple):
    boolean: BooleanOptState
    adam: AdamState


class Optimizer(NamedTuple):
    """update() returns the NEW PARAMS (not deltas): Boolean flips are not
    additive updates."""
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple]


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def boolean_optimizer(eta: Union[float, Schedule],
                      accum_dtype=torch.bfloat16) -> Optimizer:
    """Optimizer over int8 ±1 leaves only (others must be filtered out)."""
    eta_fn = _as_schedule(eta)

    def init(params: PyTree) -> BooleanOptState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=accum_dtype, device=p.device)

        def scalar(value):
            return lambda p: torch.full((), value, dtype=F32, device=p.device)

        return BooleanOptState(tree_map(zeros, params),
                               tree_map(scalar(1.0), params),
                               tree_map(scalar(0.0), params), _step0(params))

    @torch.no_grad()
    def update(votes: PyTree, state: BooleanOptState, params: PyTree):
        eta = eta_fn(state.step.cpu()).to(F32)

        def leaf(w, q, m, beta, flips):
            # accumulate (Eq 10) in f32, store back at accum_dtype
            m32 = beta * m.to(F32) + eta.to(w.device) * q.to(F32)
            flip = (m32 * w.to(F32)) >= 1.0          # xnor(m, w) = T  (Eq 9)
            w.copy_(torch.where(flip, -w, w))
            m.copy_(m32.masked_fill_(flip, 0.0))
            # an exact count, rounded once to f32
            flips.copy_(flip.sum(dtype=torch.int64).to(F32))
            beta.copy_(1.0 - flips / float(w.numel()))   # Eq 11, per layer

        tree_map(leaf, params, votes, state.accum, state.ratio, state.flips)
        return params, state._replace(step=state.step + 1)

    return Optimizer(init, update)


def adam(lr: Union[float, Schedule], b1=0.9, b2=0.999, eps=1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _as_schedule(lr)

    def init(params: PyTree) -> AdamState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)

        return AdamState(tree_map(zeros, params), tree_map(zeros, params),
                         _step0(params))

    @torch.no_grad()
    def update(grads: PyTree, state: AdamState, params: PyTree):
        step = state.step + 1
        lr = lr_fn(state.step.cpu()).to(F32)
        stepf = step.cpu().to(F32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32), stepf)

        def leaf(p, g, mu, nu):
            dev = p.device
            g = g.to(F32)
            if weight_decay:
                g = g + weight_decay * p.to(F32)
            mu.copy_(b1 * mu + (1 - b1) * g)
            nu.copy_(b2 * nu + (1 - b2) * g * g)
            upd = lr.to(dev) * (mu / bc1.to(dev)) \
                / (torch.sqrt(nu / bc2.to(dev)) + eps)
            p.copy_(p.to(F32) - upd)

        tree_map(leaf, params, grads, state.mu, state.nu)
        return params, AdamState(state.mu, state.nu, step)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Hybrid: Boolean flips for int8 leaves, Adam for FP leaves — the paper's
# full training recipe in one transform.
# ---------------------------------------------------------------------------
def _split(params: PyTree):
    bool_tree = tree_map(lambda p: p if is_boolean_leaf(p) else None, params)
    fp_tree = tree_map(lambda p: None if is_boolean_leaf(p) else p, params)
    return bool_tree, fp_tree


def _select(tree: PyTree, like: PyTree) -> PyTree:
    """``tree``'s leaves where ``like`` has one, ``None`` elsewhere."""
    if isinstance(like, dict):
        return {k: _select(tree[k], v) for k, v in like.items()}
    return None if like is None else tree


def hybrid_optimizer(eta: Union[float, Schedule],
                     fp_lr: Union[float, Schedule],
                     accum_dtype=torch.bfloat16,
                     weight_decay: float = 0.0) -> Optimizer:
    bopt = boolean_optimizer(eta, accum_dtype)
    fopt = adam(fp_lr, weight_decay=weight_decay)

    def init(params: PyTree) -> HybridState:
        bool_tree, fp_tree = _split(params)
        return HybridState(bopt.init(bool_tree), fopt.init(fp_tree))

    def update(grads: PyTree, state: HybridState, params: PyTree):
        bool_p, fp_p = _split(params)
        _, bstate = bopt.update(_select(grads, bool_p), state.boolean, bool_p)
        _, fstate = fopt.update(_select(grads, fp_p), state.adam, fp_p)
        return params, HybridState(bstate, fstate)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Schedules (cosine, as used throughout the paper's experiments).
# ---------------------------------------------------------------------------
def cosine_schedule(base: float, total_steps: int, warmup: int = 0,
                    floor: float = 0.0) -> Schedule:
    """step (int tensor) -> fp32 value, with the JAX package's fp32 ops in
    its order."""
    def fn(step):
        step = step.to(F32)
        warm = torch.minimum(step / max(warmup, 1), torch.tensor(1.0)) \
            if warmup else 1.0
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                        0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * t))
        return base * warm * cos
    return fn
