"""Fused Boolean-variation weight backward (paper Eq 5/7) with the tanh'(αΔ)
activation re-weighting of App C folded into the same pass:

    G_W[i,j] = Σ_k x[k,i] · z[k,j] · (1 − tanh²(α·d[k,j]))

the mask skipped when α = 0. x is (B, M) ±1 or real (int8, bf16 or fp32),
z and d are (B, N) (bf16 or fp32); the vote counts are summed in fp32.

``boolean_weight_bwd`` runs ``boolean_weight_bwd_plain`` (the fp32 step-by-
step version of ``ref.boolean_weight_bwd_ref``) on CPU tensors and launches
one of the two hand-written kernels in ``csrc/boolean_weight_bwd.cu`` on
CUDA tensors, or raises: ``weight_bwd_route`` picks the tensor-core kernel
(wgmma, bf16 x and z at α = 0, every launch of the training path) or the
CUDA-core one (everything else). It replaces the JAX package's Pallas
kernel ``kernels/boolean_bwd.py::boolean_weight_bwd``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_X_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_Z_TYPES = {torch.bfloat16: 1, torch.float32: 2}


def boolean_weight_bwd_plain(x: torch.Tensor, z: torch.Tensor, d=None, *,
                             alpha: float = 0.0) -> torch.Tensor:
    """The kernel's plain version: widen to fp32, mask, one fp32 matmul."""
    zf = z.to(torch.float32)
    if alpha > 0.0:
        t = torch.tanh(alpha * d.to(torch.float32))
        zf = zf * (1.0 - t * t)
    return torch.matmul(x.to(torch.float32).t(), zf)


def weight_bwd_route(x: torch.Tensor, z: torch.Tensor,
                     alpha: float = 0.0) -> str:
    """The kernel a CUDA launch takes: ``"tensor_cores"`` for bf16 x and z
    at α = 0 with B ≥ 1, M and N multiples of 8 and 16-byte-aligned data
    (TMA's row stride and base), else ``"cuda_cores"``. A function of
    dtypes, α, shapes and addresses alone."""
    B, M = x.shape
    N = z.shape[1]
    if (x.dtype == torch.bfloat16 and z.dtype == torch.bfloat16
            and alpha <= 0.0 and B > 0 and M % 8 == 0 and N % 8 == 0
            and x.data_ptr() % 16 == 0 and z.data_ptr() % 16 == 0):
        return "tensor_cores"
    return "cuda_cores"


def boolean_weight_bwd(x: torch.Tensor, z: torch.Tensor, d=None, *,
                       alpha: float = 0.0) -> torch.Tensor:
    """G_W = Σ_k x[k,:]ᵀ ⊗ (z[k,:]·tanh'(α·d[k,:])) -> (M, N) fp32.

    x: (B, M); z: (B, N) upstream signal; d: (B, N) pre-activation minus
    threshold, read only when ``alpha > 0``. CPU tensors take the plain
    version; CUDA tensors launch the kernel ``weight_bwd_route`` names.
    ``boolean_weight_bwd.launches`` counts kernel launches, ``.tc_launches``
    and ``.cc_launches`` those of the tensor-core and CUDA-core kernels.
    """
    if x.dim() != 2 or z.dim() != 2 or x.shape[0] != z.shape[0]:
        raise ValueError(f"weight bwd wants x (B, M) and z (B, N), got x "
                         f"{tuple(x.shape)}, z {tuple(z.shape)}")
    if alpha > 0.0 and (d is None or d.shape != z.shape):
        raise ValueError(f"alpha > 0 needs d of z's shape {tuple(z.shape)}")
    if x.dtype not in _X_TYPES or z.dtype not in _Z_TYPES \
            or (alpha > 0.0 and d.dtype != z.dtype):
        raise TypeError(f"weight bwd takes x int8/bf16/fp32 and z bf16/fp32 "
                        f"(d of z's type); got x {x.dtype}, z {z.dtype}"
                        f"{'' if d is None else f', d {d.dtype}'}")
    tensors = (x, z) if alpha <= 0.0 else (x, z, d)
    if all(t.device.type == "cpu" for t in tensors):
        return boolean_weight_bwd_plain(x, z, d, alpha=alpha)
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("weight bwd operands must all be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("weight bwd operands must be contiguous")
    B, M = x.shape
    N = z.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = build.library("boolean_weight_bwd")
    tc = weight_bwd_route(x, z, alpha) == "tensor_cores"
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        if tc:
            rc = lib.boolean_weight_bwd_tc(x.data_ptr(), z.data_ptr(),
                                           y.data_ptr(), B, M, N, stream)
        else:
            rc = lib.boolean_weight_bwd(
                x.data_ptr(), _X_TYPES[x.dtype], z.data_ptr(),
                _Z_TYPES[z.dtype], d.data_ptr() if alpha > 0.0 else None,
                y.data_ptr(), B, M, N, float(alpha) if alpha > 0.0 else 0.0,
                stream)
    build.check("boolean_weight_bwd", "boolean_weight_bwd", rc)
    boolean_weight_bwd.launches += 1
    if tc:
        boolean_weight_bwd.tc_launches += 1
    else:
        boolean_weight_bwd.cc_launches += 1
    return y


boolean_weight_bwd.launches = 0
boolean_weight_bwd.tc_launches = 0
boolean_weight_bwd.cc_launches = 0
