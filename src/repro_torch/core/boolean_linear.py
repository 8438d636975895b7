"""Boolean linear layer forward (paper §3.1 Eq 1) and packed serving weights.

Under the ±1 embedding the counting neuron s = Σ xnor(x, w) is a multiply-
accumulate, y = x · e(W) (+ b), summed in fp32 as in the JAX package's
``core/boolean_linear.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import pack_bits, packed_xnor_gemv, unpack_bits


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w summed in fp32 and returned in fp32 (``preferred_element_type=
    float32`` in the JAX package). bf16 inputs on the card go through the
    GEMM's fp32 output; elsewhere the operands are widened first, which is
    exact for bf16."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda and x.dtype == w.dtype:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def boolean_dense(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """y = x @ w (+ b) on the ±1 weight view, fp32 counts cast to x.dtype.
    Forward only; the Boolean-variation backward comes with training."""
    y = matmul_f32(x, w).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class PackedBool:
    """A Boolean ±1 weight stored bit-packed: 32 Booleans per int32 word.

    ``bits`` packs the input (contraction) dimension — shape (...,
    ceil(k/32), n) for a logical (..., k, n) weight — and ``k`` is the true
    fan-in, the kernels' ``k_valid``.
    """

    def __init__(self, bits: torch.Tensor, k: int):
        self.bits = bits
        self.k = k

    @property
    def shape(self):  # logical (unpacked) shape, for fan-in/scale logic
        return (*self.bits.shape[:-2], self.k, self.bits.shape[-1])

    def __getitem__(self, i) -> "PackedBool":
        """Index the leading (stacked-groups) axes; K and N stay whole."""
        return PackedBool(self.bits[i], self.k)

    def to(self, device) -> "PackedBool":
        return PackedBool(self.bits.to(device), self.k)

    def __repr__(self):
        return f"PackedBool(bits={tuple(self.bits.shape)}, k={self.k})"


def pack_boolean_weight(w_int8: torch.Tensor) -> PackedBool:
    """int8 ±1 (..., k, n) -> PackedBool with bits (..., ceil(k/32), n)."""
    return PackedBool(pack_bits(w_int8, axis=-2), w_int8.shape[-2])


# Above this many activation rows a packed contraction is compute-bound
# (prefill): it unpacks to a ±1 view and takes a dense matmul, as the JAX
# package leaves that product to XLA.
PACKED_GEMV_MAX_M = 256


def boolean_dense_inference(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """Serving-path Boolean dense on stored Boolean weights.

    A ``PackedBool`` weight routes thin-M (decode, short prefill)
    contractions through the packed-XNOR GEMV and returns fp32; wider ones
    unpack transiently to a ±1 view. An int8 ±1 weight takes the mixed-type
    rule xnor(w, x) = e(w)·x for real x.
    """
    if isinstance(w, PackedBool):
        lead = x.shape[:-1]
        m = 1
        for d in lead:
            m *= d
        if m > PACKED_GEMV_MAX_M:
            wv = unpack_bits(w.bits, w.k, axis=-2).to(x.dtype)
            y = matmul_f32(x, wv)
        else:
            y = packed_xnor_gemv(x.reshape(-1, x.shape[-1]).contiguous(),
                                 w.bits, k_valid=w.k)
            y = y.reshape(*lead, y.shape[-1])
        if b is not None:
            y = y + b.to(y.dtype)
        return y
    if x.dtype == torch.int8:
        raise NotImplementedError("int8 activations take the boolean_matmul "
                                  "kernel, which is not ported yet")
    y = matmul_f32(x, w.to(x.dtype)).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y
