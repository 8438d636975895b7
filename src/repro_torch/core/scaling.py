"""Scaling factors of the paper's Appendix C (same formulas as the JAX
package's ``core/scaling.py``).

C.3  Pre-activation scaling: Var(S) = m for a fan-in-m Boolean neuron, so
     α = π/(2√(3m)) matches the spread of the tanh' re-weighting window.
C.4  Backpropagation scaling: the upstream signal of a fan-out-m Boolean
     linear layer is normalised by √(2/m); the convolution variant
     (Eq 43/47) scales with the kernel area and stride.
"""
from __future__ import annotations

import math


def preactivation_alpha(fan_in: int) -> float:
    """α = π / (2·√(3m)) — App C.3 Eq (24)."""
    return math.pi / (2.0 * math.sqrt(3.0 * max(fan_in, 1)))


def backward_scale(fan_out: int) -> float:
    """√(2/m) normalizer inverting Var(Z^{l-1}) = (m/2) Var(Z^l) — Eq (42)."""
    return math.sqrt(2.0 / max(fan_out, 1))


def backward_scale_conv(fan_out_channels: int, kh: int, kw: int, stride: int = 1,
                        maxpool: bool = False) -> float:
    """Conv variant: Var(Z^{l-1}) = (m·kh·kw)/(2v)·Var(Z^l), ×1/4 under 2×2
    maxpool — Eqs (43) and (47)."""
    var_gain = fan_out_channels * kh * kw / (2.0 * max(stride, 1))
    if maxpool:
        var_gain *= 0.25
    return 1.0 / math.sqrt(max(var_gain, 1e-12))
