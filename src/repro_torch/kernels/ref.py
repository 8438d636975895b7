"""Plain-torch oracles of the port's kernels: the serving GEMV stated on the
unpacked weight, and the fused weight backward (the counterparts of the JAX
package's ``kernels/ref.py``)."""
from __future__ import annotations

import torch


def packed_xnor_gemv_ref(x: torch.Tensor, w_pm1: torch.Tensor) -> torch.Tensor:
    """Real x against the UNPACKED ±1 weight, fp32 out: the packed GEMV must
    agree after ``pack_bits`` on the weight side only."""
    return torch.matmul(x.to(torch.float32), w_pm1.to(torch.float32))


def boolean_weight_bwd_ref(x: torch.Tensor, z: torch.Tensor, d: torch.Tensor,
                           *, alpha: float = 0.0) -> torch.Tensor:
    """Fused weight-backward oracle: Xᵀ·(z·tanh'(α·d)) in fp32 (the mask
    skipped when α = 0)."""
    zf = z.to(torch.float32)
    if alpha > 0.0:
        t = torch.tanh(alpha * d.to(torch.float32))
        zf = zf * (1.0 - t * t)
    return torch.matmul(x.to(torch.float32).t(), zf)
