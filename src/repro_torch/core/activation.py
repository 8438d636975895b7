"""Boolean threshold activation (paper §3.1), forward only.

y = T (+1) if s ≥ τ else F (−1). The tanh'-reweighted backward of the JAX
package's ``core/activation.py`` comes with the training slice.
"""
from __future__ import annotations

import torch


def boolean_activation(s: torch.Tensor, tau, fan_in: int = 1) -> torch.Tensor:
    """Threshold at ``tau``; returns ±1 in ``s.dtype``. ``fan_in`` sets the
    backward window (App C.3) and does not change the forward."""
    d = s - tau
    return torch.where(d >= 0, 1, -1).to(s.dtype)
