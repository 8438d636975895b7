"""Boolean (±1 int8) GEMM with an optional fused threshold activation:

    s[i,j] = Σ_k x[i,k]·w[k,j]       (int32 counts), or
    y[i,j] = +1 if s[i,j] ≥ τ else −1  (int8, the counts never leave the chip)

the counting neuron of paper Eq 1 under the ±1 embedding, and with the
threshold the forward of a Boolean layer fed ±1 inputs (every ±1-input
Boolean convolution of the vision models, through im2col). x is (M, K) and
w (K, N), both int8; a zero entry contributes nothing, which is how im2col
pads and how ragged K is filled.

``boolean_matmul`` runs ``boolean_matmul_plain`` on CPU tensors and launches
the hand-written kernel in ``csrc/boolean_matmul.cu`` (wgmma s8·s8→s32, TMA)
on CUDA tensors, or raises; ``boolean_matmul_operands`` makes the operands
that kernel reads (the weight transposed, K padded). It replaces the JAX
package's Pallas kernel ``kernels/boolean_matmul.py::boolean_matmul``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# an fp32 sum of integers of magnitude <= 1 is exact while |sum| < 2^24
_EXACT_K = 1 << 24


def boolean_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                         fuse_threshold: bool = False,
                         tau: float = 0.0) -> torch.Tensor:
    """The kernel's plain version: an fp32 product of the ±1 / 0 operands,
    exact for K < 2^24 in any summation order (and under TF32, which holds
    ±1 exactly), rounded to int32; then the threshold."""
    if x.shape[-1] >= _EXACT_K:
        raise ValueError(f"K = {x.shape[-1]} is past fp32's exact range")
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32)).to(torch.int32)
    if fuse_threshold:
        return torch.where(y >= tau, 1, -1).to(torch.int8)
    return y


def boolean_matmul_operands(x: torch.Tensor, w: torch.Tensor):
    """x (M, K) and w (K, N) as the kernel reads them: x (M, Kp) and
    wt = wᵀ (N, Kp), both row-major with K zero-padded to Kp, a multiple of
    16 (TMA's 16-byte row stride; 8-bit wgmma reads both operands K-major).
    Zeros add nothing, so ``boolean_matmul_plain(x, wt.t())`` is the
    product of the given operands. x is copied only to pad K or to align
    its base to 16 bytes; wt is one pass over the weight, on the card the
    library's transpose kernel."""
    K, N = w.shape
    Kp = -(-K // 16) * 16
    if Kp != K:
        x = torch.nn.functional.pad(x, (0, Kp - K))
    elif x.data_ptr() % 16:
        x = x.clone()
    if not w.is_cuda:
        wt = w.new_zeros((N, Kp))
        wt[:, :K] = w.t()
        return x, wt
    wt = torch.empty((N, Kp), dtype=torch.int8, device=w.device)
    lib = build.library("boolean_matmul")
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.boolean_matmul_transpose(w.data_ptr(), wt.data_ptr(), K, N, Kp,
                                          ctypes.c_void_p(stream))
    build.check("boolean_matmul", "boolean_matmul", rc)
    return x, wt


def boolean_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   fuse_threshold: bool = False,
                   tau: float = 0.0) -> torch.Tensor:
    """x (M, K) int8 @ w (K, N) int8 -> (M, N) int32 counts, or int8 ±1
    (s ≥ tau) with ``fuse_threshold``. CPU tensors take the plain version;
    CUDA tensors launch the kernel on ``boolean_matmul_operands(x, w)``.
    ``boolean_matmul.launches`` counts kernel launches."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"boolean matmul wants x (M, K) and w (K, N), got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"boolean matmul takes int8 operands, got {x.dtype}, "
                        f"{w.dtype}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return boolean_matmul_plain(x, w, fuse_threshold=fuse_threshold,
                                    tau=tau)
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"boolean matmul operands on {x.device} and "
                         f"{w.device}: both must be on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("boolean matmul operands must be contiguous")
    M, N = x.shape[0], w.shape[1]
    y = torch.empty((M, N), dtype=torch.int8 if fuse_threshold else torch.int32,
                    device=x.device)
    if y.numel() == 0:
        return y
    xk, wt = boolean_matmul_operands(x, w)
    lib = build.library("boolean_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.boolean_matmul(xk.data_ptr(), wt.data_ptr(), y.data_ptr(), M,
                                xk.shape[1], N, int(fuse_threshold),
                                float(tau), ctypes.c_void_p(stream))
    build.check("boolean_matmul", "boolean_matmul", rc)
    boolean_matmul.launches += 1
    return y


boolean_matmul.launches = 0
