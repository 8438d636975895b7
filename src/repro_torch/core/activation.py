"""Boolean threshold activation (paper §3.1 Forward Activation, Appendix C).

Forward: y = T (+1) if s ≥ τ else F (−1).

Backward (App C.1): the upstream signal is re-weighted by tanh'(αΔ) =
1 − tanh²(α(s−τ)) with α = π / (2√(3m)) matching the pre-activation spread
(App C.3, Eq 24) — a re-weighting of the variation signal, not a latent-
weight STE. The same rule as the JAX package's ``core/activation.py``.
"""
from __future__ import annotations

import torch

from .scaling import preactivation_alpha


class _BooleanActivation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, tau, fan_in, hard_backward):
        d = s - tau
        ctx.save_for_backward(d)
        ctx.fan_in, ctx.hard_backward = fan_in, hard_backward
        ctx.tau_shape = tuple(tau.shape) if torch.is_tensor(tau) else None
        return torch.where(d >= 0, 1, -1).to(s.dtype)

    @staticmethod
    def backward(ctx, g):
        d, = ctx.saved_tensors
        if ctx.hard_backward:
            gm = g.to(torch.float32)
        else:
            t = torch.tanh(preactivation_alpha(ctx.fan_in) * d.to(torch.float32))
            gm = g.to(torch.float32) * (1.0 - t * t)      # tanh'(αΔ)
        gs = gm.to(d.dtype)
        if ctx.tau_shape is None or not ctx.needs_input_grad[1]:
            return gs, None, None, None
        # δLoss/δτ: τ shifts opposite to s — reduce the broadcast dims so
        # the cotangent takes τ's shape (scalar or per-channel)
        extra = gm.dim() - len(ctx.tau_shape)
        gtau = -gm.sum(dim=tuple(range(extra))) if extra else -gm
        for i, n in enumerate(ctx.tau_shape):
            if n == 1 and gtau.shape[i] != 1:
                gtau = gtau.sum(dim=i, keepdim=True)
        return gs, gtau.to(d.dtype), None, None


def boolean_activation(s: torch.Tensor, tau, fan_in: int = 1,
                       hard_backward: bool = False) -> torch.Tensor:
    """Threshold at ``tau`` (a tensor broadcastable to ``s``, or a number);
    returns ±1 in ``s.dtype``. ``fan_in`` = m, the counting range of ``s``,
    sets the backward window α = π/(2√(3m)); ``hard_backward`` passes the
    signal through un-reweighted (ablations)."""
    return _BooleanActivation.apply(s, tau, fan_in, hard_backward)


def boolean_activation_inference(s: torch.Tensor, tau=0.0,
                                 dtype=torch.int8) -> torch.Tensor:
    """Forward threshold alone, ±1 in ``dtype`` (int8 by default): the
    inference path, no backward."""
    return torch.where(s >= tau, 1, -1).to(dtype)
