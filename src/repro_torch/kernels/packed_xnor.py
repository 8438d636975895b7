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
it launches one of the two hand-written routes in
``csrc/packed_xnor_gemv.cu`` or raises: ``gemv_route`` picks the
tensor-core route (bf16 x at aligned shapes, every launch of the bf16
serving path: ``wgmma`` over lane tiles of 8 to 128 rows of x, as
``gemv_tc_plan`` tiles them) or the CUDA-core kernel (fp32 x, unaligned
shapes).

``packed_xnor_matmul`` computes s[M,N] = k_valid − 2·popcount(x XOR w) over
the words of x (M, Kw), packed along axis 1, and w (Kw, N), packed along
axis 0: the ±1 product Σ_k e(x[M,k])·e(w[k,N]) when the pad bits past
k_valid are F on both sides. CPU tensors take ``packed_xnor_matmul_plain``;
CUDA tensors launch ``csrc/packed_xnor_matmul.cu`` (the words as they lie
on the binary tensor cores: ``wgmma`` b1 AND-popc and the operands'
popcounts) or raise; it takes every shape. It replaces
the JAX package's Pallas kernel ``kernels/packed_xnor.py::
packed_xnor_matmul``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from . import build


def pack_bits(x_pm1: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a ±1 int8 tensor into int32 words along ``axis`` (pad with F)."""
    x = torch.movedim(x_pm1, axis, -1)
    K = x.shape[-1]
    Kp = -(-K // 32) * 32
    if Kp != K:
        x = torch.nn.functional.pad(x, (0, Kp - K), value=-1)
    bits = (x > 0).to(torch.int32).reshape(*x.shape[:-1], Kp // 32, 32)
    # bit b weighs 2^b and bit 31 -2^31 (1 << 31 in int32): the sum is the
    # int32 whose two's-complement bits are the reference's uint32 word, and
    # it never overflows. Made on x's device: a tensor built from a host
    # list would be a copy from pageable memory, which waits for the stream.
    shifts = torch.arange(32, dtype=torch.int32, device=x.device)
    words = (bits * (torch.ones_like(shifts) << shifts)).sum(-1, dtype=torch.int32)
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


# Fill the card: aim for this many blocks (2 per SM of an H100's 132).
_TARGET_BLOCKS = 2 * build.H100_SMS
_BN, _BM, _KWS_MAX, _KWS_MIN = 256, 8, 32, 4


def gemv_split(M: int, Kw: int, N: int):
    """(ksplit, words per split) for the CUDA-core kernel's K split."""
    base = (-(-N // _BN)) * (-(-M // _BM))
    ksplit = max(-(-_TARGET_BLOCKS // base), -(-Kw // _KWS_MAX))
    ksplit = min(ksplit, -(-Kw // _KWS_MIN))
    kws = -(-Kw // ksplit)
    return -(-Kw // kws), kws


class GemvTiles(NamedTuple):
    """The tensor-core kernels' tiles: words a stage, weight columns a
    block, and by lane tile (rows of x a block, ascending) the blocks an
    SM, the ring's stages and its dynamic shared bytes."""
    ks: int
    cols: int
    blocks: Dict[int, int]
    stages: Dict[int, int]
    smem: Dict[int, int]


@functools.lru_cache(maxsize=None)
def gemv_tc_tiles() -> GemvTiles:
    """The tile table as ``csrc/packed_xnor_gemv.cu`` builds it (its one
    source), read from the library."""
    out = (ctypes.c_int * 22)()
    n = build.library("packed_xnor_gemv").xnor_gemv_tc_tiles(out)
    rows = [tuple(out[2 + 4 * i:6 + 4 * i]) for i in range(n)]
    return GemvTiles(out[0], out[1], *({r[0]: r[c] for r in rows}
                                       for c in (1, 2, 3)))


@functools.lru_cache(maxsize=None)
def gemv_source_tiles() -> GemvTiles:
    """The tile table as ``csrc/packed_xnor_gemv.cu`` writes it (``TC_KS``,
    ``TC_COLS``, ``TC_TILES``), read from its text: what a traced launch
    (``build.traced``) plans with, where no library is built. The shared
    bytes are the compiler's, and left empty."""
    (ks,), (cols,) = (build.source_ints("packed_xnor_gemv.cu", n)
                      for n in ("TC_KS", "TC_COLS"))
    flat = build.source_ints("packed_xnor_gemv.cu", "TC_TILES")
    rows = [flat[i:i + 3] for i in range(0, len(flat), 3)]
    return GemvTiles(ks, cols, {r[0]: r[1] for r in rows},
                     {r[0]: r[2] for r in rows}, {})


def gemv_tc_plan(M: int, Kw: int, N: int, tiles: GemvTiles):
    """(lanes, ksplit, words per split) for the tensor-core kernel: the
    narrowest lane tile of ``tiles`` that covers M (the widest above it,
    tiled); K split until the blocks fill one wave at the tile's blocks an
    SM; every split but the last a whole number of stages."""
    lanes = next((b for b in tiles.blocks if b >= M), max(tiles.blocks))
    n_tiles = (-(-N // tiles.cols)) * (-(-M // lanes))
    ksplit = max(1, build.H100_SMS * tiles.blocks[lanes] // n_tiles)
    ksplit = min(ksplit, -(-Kw // tiles.ks))
    kws = -(-(-(-Kw // ksplit)) // tiles.ks) * tiles.ks
    return lanes, -(-Kw // kws), kws


def gemv_route(x: torch.Tensor, w_packed: torch.Tensor) -> str:
    """The kernel a CUDA launch takes: ``"tensor_cores"`` for bf16 x with K
    a multiple of 8 and N of 4 and 16-byte-aligned bases (TMA's row
    strides and bases), else ``"cuda_cores"`` (fp32 x, which the bf16
    tensor cores would round, and unaligned bf16). A function of dtypes,
    shapes and addresses alone."""
    K, N = x.shape[1], w_packed.shape[1]
    if (x.dtype == torch.bfloat16 and K % 8 == 0 and N % 4 == 0
            and build.address(x) % 16 == 0
            and build.address(w_packed) % 16 == 0):
        return "tensor_cores"
    return "cuda_cores"


def packed_xnor_gemv(x: torch.Tensor, w_packed: torch.Tensor, *,
                     k_valid: int, plan_n: Optional[int] = None
                     ) -> torch.Tensor:
    """y[i,j] = Σ_k x[i,k]·e(w[k,j]) with only the weights bit-packed.

    x: (M, K) real activations, K == k_valid; w_packed: (Kw, N) int32 words
    (``pack_bits`` layout, K packed along axis 0). Returns (M, N) fp32.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    ``gemv_route`` names. ``packed_xnor_gemv.launches`` counts kernel
    launches, ``.tc_launches`` and ``.cc_launches`` those of the
    tensor-core and CUDA-core kernels; a traced launch (``build.traced``)
    allocates y and the split-K partials and counts ``.fake_launches``.

    ``plan_n``: plan the launch (lane tile, K split) as for a weight of
    ``plan_n`` columns. A column shard of a wider weight passes the whole
    weight's N, so each column sums its K partials in the order the
    unsharded launch sums them (the split follows N; ``sign()`` downstream
    turns another order's ulps into token flips).
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
    if not (build.on_card(x) and w_packed.device == x.device):
        raise ValueError(f"packed gemv operands on {x.device} and "
                         f"{w_packed.device}: both must be on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"packed gemv takes bf16 or fp32 activations, got {x.dtype}")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("packed gemv operands must be contiguous")
    tc = gemv_route(x, w_packed) == "tensor_cores"
    traced = build.traced(x, w_packed)
    if tc:
        lanes, ksplit, kws = gemv_tc_plan(
            M, Kw, plan_n or N,
            gemv_source_tiles() if traced else gemv_tc_tiles())
    else:
        ksplit, kws = gemv_split(M, Kw, plan_n or N)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    part = (torch.empty((ksplit, M, N), dtype=torch.float32, device=x.device)
            if ksplit > 1 else y)
    if traced:
        packed_xnor_gemv.fake_launches += 1
        return y
    lib = build.library("packed_xnor_gemv")
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        if tc:
            rc = lib.xnor_gemv_tc(x.data_ptr(), w_packed.data_ptr(), y.data_ptr(),
                                  part.data_ptr(), M, K, Kw, N, lanes, ksplit,
                                  kws, stream)
        else:
            rc = lib.xnor_gemv(x.data_ptr(), int(x.dtype == torch.bfloat16),
                               w_packed.data_ptr(), y.data_ptr(),
                               part.data_ptr(), M, K, Kw, N, ksplit, kws,
                               stream)
    build.check("packed_xnor_gemv", "xnor_gemv", rc)
    packed_xnor_gemv.launches += 1
    if tc:
        packed_xnor_gemv.tc_launches += 1
    else:
        packed_xnor_gemv.cc_launches += 1
    return y


packed_xnor_gemv.launches = 0
packed_xnor_gemv.tc_launches = 0
packed_xnor_gemv.cc_launches = 0
packed_xnor_gemv.fake_launches = 0


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
    ``packed_xnor_matmul.launches`` counts kernel launches; a traced launch
    (``build.traced``) allocates y and counts ``.fake_launches``.
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
    if not (build.on_card(x_packed) and w_packed.device == x_packed.device):
        raise ValueError(f"packed matmul operands on {x_packed.device} and "
                         f"{w_packed.device}: both must be on one CUDA device")
    if not (x_packed.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("packed matmul operands must be contiguous")
    y = torch.empty((M, N), dtype=torch.int32, device=x_packed.device)
    if y.numel() == 0:
        return y
    if build.traced(x_packed, w_packed):
        packed_xnor_matmul.fake_launches += 1
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
packed_xnor_matmul.fake_launches = 0
