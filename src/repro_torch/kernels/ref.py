"""Plain-torch oracle for the serving GEMV, stated on the unpacked weight
(the counterpart of the JAX package's ``kernels/ref.py``)."""
from __future__ import annotations

import torch


def packed_xnor_gemv_ref(x: torch.Tensor, w_pm1: torch.Tensor) -> torch.Tensor:
    """Real x against the UNPACKED ±1 weight, fp32 out: the packed GEMV must
    agree after ``pack_bits`` on the weight side only."""
    return torch.matmul(x.to(torch.float32), w_pm1.to(torch.float32))
