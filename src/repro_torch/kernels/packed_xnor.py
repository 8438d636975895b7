"""Bit-packed Boolean tensors, the thin-M packed-XNOR serving GEMV and the
fully packed XNOR-popcount GEMM.

Packing layout (identical to the JAX package's ``kernels/packed_xnor.py``):
bit b of word j along K encodes element k = 32j + b, bit 1 = T (+1), and K
is padded up to a multiple of 32 with F. torch has no full uint32 bit
arithmetic, so words are stored as int32 tensors whose bits equal the
reference's uint32 words.

``packed_xnor_gemv`` computes y[M,N] = sum_k x[M,k] * e(w[k,N]) in fp32. On
CPU tensors it runs ``packed_xnor_gemv_plain`` (unpack + fp32 matmul, the
oracle of the JAX package's ``ref.packed_xnor_gemv_ref``); on CUDA tensors
it launches the hand-written kernel in ``csrc/packed_xnor_gemv.cu`` or
raises.

``packed_xnor_matmul`` computes s[M,N] = k_valid − 2·popcount(x XOR w) over
the words of x (M, Kw), packed along axis 1, and w (Kw, N), packed along
axis 0: the ±1 product Σ_k e(x[M,k])·e(w[k,N]) when the pad bits past
k_valid are F on both sides. CPU tensors take ``packed_xnor_matmul_plain``;
CUDA tensors launch ``csrc/packed_xnor_matmul.cu`` or raise. It replaces
the JAX package's Pallas kernel ``kernels/packed_xnor.py::
packed_xnor_matmul``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build


def pack_bits(x_pm1: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a ±1 int8 tensor into int32 words along ``axis`` (pad with F)."""
    x = torch.movedim(x_pm1, axis, -1)
    K = x.shape[-1]
    Kp = -(-K // 32) * 32
    if Kp != K:
        x = torch.nn.functional.pad(x, (0, Kp - K), value=-1)
    bits = x > 0
    words = torch.zeros(*x.shape[:-1], Kp // 32, dtype=torch.int32,
                        device=x.device)
    for b in range(32):
        words |= bits[..., b::32].to(torch.int32) << b
    return torch.movedim(words, -1, axis).contiguous()


def unpack_bits(words: torch.Tensor, k: int, axis: int = -1) -> torch.Tensor:
    """Inverse of ``pack_bits`` -> ±1 int8 of length ``k`` along ``axis``."""
    w = torch.movedim(words, axis, -1)
    shifts = torch.arange(32, dtype=torch.int32, device=w.device)
    bits = (w[..., :, None] >> shifts) & 1
    x = (bits * 2 - 1).to(torch.int8)
    x = x.reshape(*w.shape[:-1], w.shape[-1] * 32)[..., :k]
    return torch.movedim(x, -1, axis)


def packed_xnor_gemv_plain(x: torch.Tensor, w_packed: torch.Tensor, *,
                           k_valid: int) -> torch.Tensor:
    """The kernel's plain version: unpack to ±1 and take an fp32 matmul."""
    w = unpack_bits(w_packed, k_valid, axis=0).to(torch.float32)
    return torch.matmul(x.to(torch.float32), w)


# Fill the card: aim for this many blocks (2 per SM of an H100).
_TARGET_BLOCKS = 264
_BN, _BM, _KWS_MAX, _KWS_MIN = 256, 8, 32, 4


def gemv_split(M: int, Kw: int, N: int):
    """(ksplit, words per split) for the CUDA kernel's K split."""
    base = (-(-N // _BN)) * (-(-M // _BM))
    ksplit = max(-(-_TARGET_BLOCKS // base), -(-Kw // _KWS_MAX))
    ksplit = min(ksplit, -(-Kw // _KWS_MIN))
    kws = -(-Kw // ksplit)
    return -(-Kw // kws), kws


def packed_xnor_gemv(x: torch.Tensor, w_packed: torch.Tensor, *,
                     k_valid: int) -> torch.Tensor:
    """y[i,j] = Σ_k x[i,k]·e(w[k,j]) with only the weights bit-packed.

    x: (M, K) real activations, K == k_valid; w_packed: (Kw, N) int32 words
    (``pack_bits`` layout, K packed along axis 0). Returns (M, N) fp32.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``packed_xnor_gemv.launches`` counts kernel launches.
    """
    if x.dim() != 2 or w_packed.dim() != 2:
        raise ValueError(f"packed gemv wants 2-D operands, got x {tuple(x.shape)}"
                         f", w {tuple(w_packed.shape)}")
    M, K = x.shape
    Kw, N = w_packed.shape
    if K != k_valid or Kw * 32 < K:
        raise ValueError(f"packed gemv mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w_packed.shape)}, k_valid={k_valid}")
    if w_packed.dtype != torch.int32:
        raise TypeError(f"packed weights must be int32 words, got {w_packed.dtype}")
    if x.device.type == "cpu" and w_packed.device.type == "cpu":
        return packed_xnor_gemv_plain(x, w_packed, k_valid=k_valid)
    if not (x.is_cuda and w_packed.device == x.device):
        raise ValueError(f"packed gemv operands on {x.device} and "
                         f"{w_packed.device}: both must be on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"packed gemv takes bf16 or fp32 activations, got {x.dtype}")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("packed gemv operands must be contiguous")
    ksplit, kws = gemv_split(M, Kw, N)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    part = (torch.empty((ksplit, M, N), dtype=torch.float32, device=x.device)
            if ksplit > 1 else y)
    lib = build.library("packed_xnor_gemv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xnor_gemv(x.data_ptr(), int(x.dtype == torch.bfloat16),
                           w_packed.data_ptr(), y.data_ptr(), part.data_ptr(),
                           M, K, Kw, N, ksplit, kws, ctypes.c_void_p(stream))
    build.check("packed_xnor_gemv", "xnor_gemv", rc)
    packed_xnor_gemv.launches += 1
    return y


packed_xnor_gemv.launches = 0


def packed_xnor_matmul_plain(x_packed: torch.Tensor, w_packed: torch.Tensor, *,
                             k_valid: int) -> torch.Tensor:
    """The kernel's plain version: unpack every bit of both operands and take
    the exact ±1 product P over all 32·Kw bits (an fp32 matmul, exact below
    2^24). Each bit pair that agrees adds 1 to P and none to the popcount,
    so k_valid − 2·popcount(x XOR w) = k_valid − 32·Kw + P, whatever the
    pad bits hold."""
    kbits = 32 * x_packed.shape[1]
    if kbits >= 1 << 24:
        raise ValueError(f"{kbits} bits are past fp32's exact range")
    x = unpack_bits(x_packed, kbits, axis=1).to(torch.float32)
    w = unpack_bits(w_packed, kbits, axis=0).to(torch.float32)
    return torch.matmul(x, w).to(torch.int32) + (k_valid - kbits)


def packed_xnor_matmul(x_packed: torch.Tensor, w_packed: torch.Tensor, *,
                       k_valid: int) -> torch.Tensor:
    """s = k_valid − 2·popcount(x_bits XOR w_bits) -> (M, N) int32.

    x_packed: (M, Kw) int32 words packed along axis 1; w_packed: (Kw, N)
    int32 words packed along axis 0 (``pack_bits`` layouts); pad bits F on
    both sides make s the ±1 product over the k_valid real bits. CPU tensors
    take the plain version; CUDA tensors launch the kernel.
    ``packed_xnor_matmul.launches`` counts kernel launches.
    """
    if x_packed.dim() != 2 or w_packed.dim() != 2 \
            or x_packed.shape[1] != w_packed.shape[0]:
        raise ValueError(f"packed matmul wants x (M, Kw) and w (Kw, N), got x "
                         f"{tuple(x_packed.shape)}, w {tuple(w_packed.shape)}")
    if x_packed.dtype != torch.int32 or w_packed.dtype != torch.int32:
        raise TypeError(f"packed matmul takes int32 words, got "
                        f"{x_packed.dtype}, {w_packed.dtype}")
    M, Kw = x_packed.shape
    N = w_packed.shape[1]
    if not 0 <= k_valid <= 32 * Kw:
        raise ValueError(f"k_valid={k_valid} does not fit {Kw} words")
    if x_packed.device.type == "cpu" and w_packed.device.type == "cpu":
        return packed_xnor_matmul_plain(x_packed, w_packed, k_valid=k_valid)
    if not (x_packed.is_cuda and w_packed.device == x_packed.device):
        raise ValueError(f"packed matmul operands on {x_packed.device} and "
                         f"{w_packed.device}: both must be on one CUDA device")
    if not (x_packed.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("packed matmul operands must be contiguous")
    y = torch.empty((M, N), dtype=torch.int32, device=x_packed.device)
    if y.numel() == 0:
        return y
    lib = build.library("packed_xnor_matmul")
    with torch.cuda.device(x_packed.device):
        stream = torch.cuda.current_stream(x_packed.device).cuda_stream
        rc = lib.packed_xnor_matmul(x_packed.data_ptr(), w_packed.data_ptr(),
                                    y.data_ptr(), M, Kw, N, k_valid,
                                    ctypes.c_void_p(stream))
    build.check("packed_xnor_matmul", "packed_xnor_matmul", rc)
    packed_xnor_matmul.launches += 1
    return y


packed_xnor_matmul.launches = 0
