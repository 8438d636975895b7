"""Plain-torch oracles of the port's kernels: the serving GEMV stated on the
unpacked weight, the fused weight backward and the materialising-softmax
attention (the counterparts of the JAX package's ``kernels/ref.py``)."""
from __future__ import annotations

import math

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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Materialising-softmax oracle of the flash kernel: (BH, S, hd) in
    q's dtype, scores and softmax in fp32."""
    S, hd = q.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(hd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    valid = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        valid &= pos[:, None] >= pos[None, :]
    if window > 0:
        valid &= pos[:, None] - pos[None, :] < window
    s = torch.where(valid[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)
