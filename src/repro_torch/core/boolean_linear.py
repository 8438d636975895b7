"""Boolean linear layer (paper §3.1 Eq 1, §3.3 Eqs 3-8) and packed serving
weights.

Under the ±1 embedding the counting neuron s = Σ xnor(x, w) is a multiply-
accumulate, y = x · e(W) (+ b), summed in fp32. The backward for a real
upstream signal Z (Eqs 4-8) is the linear VJP on the embedded Booleans:

    δLoss/δx = Z · e(W)ᵀ  (Eq 6/8, × √(2/n) with App C.4's ``bwd_norm``,
                           projected to ±1 with ``sign_backward``)
    δLoss/δW = Xᵀ · Z     (Eq 5/7, fp32 vote counts over every batch row)

The votes run through the fused weight-backward kernel
(``kernels.boolean_weight_bwd`` at α = 0) and are rounded to the weight
view's dtype, where the JAX package's ``core/boolean_linear.py`` rounds them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import (boolean_matmul, boolean_weight_bwd,
                                 pack_bits, packed_xnor_gemv,
                                 packed_xnor_matmul, unpack_bits)
from repro_torch.kernels.build import on_card

from .scaling import backward_scale


class _MatmulF32(torch.autograd.Function):
    """One GEMM of same-dtype low-precision operands on the card with an
    fp32 result. Its backward sums in fp32 and rounds to the operands'
    dtypes, as JAX transposes a dot with ``preferred_element_type=f32``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.matmul(g2, w.to(torch.float32).t()).to(x.dtype) \
                .reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = torch.matmul(x.reshape(-1, x.shape[-1]).to(torch.float32).t(),
                              g2).to(w.dtype)
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w summed in fp32 and returned in fp32 (``preferred_element_type=
    float32`` in the JAX package), differentiable. bf16 inputs on the card
    go through the GEMM's fp32 output (also in a trace of the card's step,
    ``kernels.build.on_card``); elsewhere the operands are widened first,
    which is exact for bf16."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if on_card(x) and x.dtype == w.dtype:
        return _MatmulF32.apply(x, w)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


class _BooleanDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, bwd_norm, sign_backward, reduce_bf16, group,
                fan_out, sum_votes, keep_f32):
        y = torch.matmul(x, w) if reduce_bf16 else matmul_f32(x, w)
        if not keep_f32:
            y = y.to(x.dtype)
        if b is not None:
            y = y + b.to(y.dtype)
        ctx.save_for_backward(x, w)
        ctx.has_b, ctx.bwd_norm, ctx.sign_backward = \
            b is not None, bwd_norm, sign_backward
        ctx.reduce_bf16, ctx.group, ctx.fan_out = reduce_bf16, group, fan_out
        ctx.sum_votes = sum_votes
        return y

    @staticmethod
    def backward(ctx, z):
        x, w = ctx.saved_tensors
        m, n = w.shape
        # an fp32 output (keep_f32) reaches x's dtype by a cast, so its grad
        # holds x-dtype values: back to x's dtype exactly
        z = z.to(x.dtype)
        gx = None
        if ctx.needs_input_grad[0]:
            # Eq 6/8: upstream signal aggregated over fan-out, in x.dtype
            # under reduce_bf16 (the JAX package's bf16 transpose), else fp32
            if ctx.reduce_bf16:
                gx = torch.matmul(z.to(x.dtype), w.to(x.dtype).t())
            else:
                gx = matmul_f32(z, w.t())
            if ctx.group is not None:
                # the other output columns' partials live on the other ranks
                # of the group: the sum precedes the normalisation and sign
                gx = all_reduce_sum(gx, ctx.group)
            gx = gx.to(torch.float32)
            if ctx.bwd_norm:
                gx = gx * backward_scale(ctx.fan_out or n)
            if ctx.sign_backward:
                gx = signal_sign(gx)
            gx = gx.to(x.dtype)
        # Eq 5/7: weight votes over all batch-like rows, fp32 counts rounded
        # to the weight view's dtype
        z2 = z.reshape(-1, n).contiguous()
        gw = boolean_weight_bwd(x.reshape(-1, m).contiguous(), z2, alpha=0.0)
        gb = z2.to(torch.float32).sum(0) if ctx.has_b else None
        if ctx.sum_votes:
            # a replicated weight whose output this rank reads in part: the
            # other ranks of the group hold the other partial votes
            gw = all_reduce_sum(gw, ctx.group)
            gb = None if gb is None else all_reduce_sum(gb, ctx.group)
        gb = None if gb is None else gb.to(w.dtype)
        return (gx, gw.to(w.dtype), gb, None, None, None, None, None, None,
                None)


def signal_sign(gx: torch.Tensor) -> torch.Tensor:
    """The ±1 Boolean backprop signal of ``sign_backward`` (Alg 6): +1 at
    and above 0, as the JAX package's ``jnp.where(gx >= 0, 1, -1)``."""
    return torch.where(gx >= 0, 1.0, -1.0)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (a copy, contiguous)."""
    import torch.distributed as dist

    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def boolean_dense(x: torch.Tensor, w: torch.Tensor, b=None,
                  bwd_norm: bool = True, sign_backward: bool = False,
                  reduce_bf16: bool = False, group=None,
                  fan_out: Optional[int] = None,
                  sum_votes: bool = False,
                  keep_f32: bool = False) -> torch.Tensor:
    """y = x @ w (+ b) on the ±1 weight view, fp32 counts cast to x.dtype,
    with the Boolean-variation backward.

    x: (..., m) real or ±1 activations; w: (m, n) ±1 view (bf16/fp32), whose
    gradient is the vote tensor the flip-rule optimizer reads, never a
    weight update; b: (n,) real bias or None. ``bwd_norm`` applies the
    √(2/n) App-C.4 normalisation to δLoss/δx; ``sign_backward`` projects it
    to ±1 (Boolean backprop signal, Alg 6). ``reduce_bf16`` emits the
    contraction and its activation-grad transpose in x.dtype (the vote
    counts stay fp32), as the JAX package's flag does.

    A column shard of a wider weight (head-parallel training): ``w`` holds
    this rank's output columns, ``group`` the ranks holding the others and
    ``fan_out`` the whole weight's columns. The backward sums δLoss/δx's
    partials over ``group`` before the √(2/fan_out) normalisation and the
    sign, so every rank gets the unsharded signal. ``sum_votes``: ``w`` is
    the whole weight, replicated over ``group``, and each rank reads only
    part of its output (k/v when the KV heads are fewer than the ranks):
    the votes (and the bias grad) are also summed over ``group``, in fp32.
    ``keep_f32``: return the fp32 counts uncast (a row slice of a wider
    weight, whose partial counts the caller sums across ranks before the
    cast; not under ``reduce_bf16``, whose counts are x's dtype). The
    App-C.4 normalisation is by ``fan_out`` (default: ``w``'s columns),
    the whole weight's column count.
    """
    return _BooleanDense.apply(x, w, b, bwd_norm, sign_backward, reduce_bf16,
                               group, fan_out, sum_votes, keep_f32)


class PackedBool:
    """A Boolean ±1 weight stored bit-packed: 32 Booleans per int32 word.

    ``bits`` packs the input (contraction) dimension — shape (...,
    ceil(k/32), n) for a logical (..., k, n) weight — and ``k`` is the true
    fan-in, the kernels' ``k_valid``.
    """

    def __init__(self, bits: torch.Tensor, k: int):
        self.bits = bits
        self.k = k
        self._colsum = None

    def colsum(self) -> torch.Tensor:
        """Σ_k e(w[..., k, n]), (..., n) int32: weight-only, computed on
        first use and kept with the leaf."""
        if self._colsum is None:
            self._colsum = unpack_bits(self.bits, self.k, axis=-2).sum(
                -2, dtype=torch.int32)
        return self._colsum

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


def boolean_dense_inference(x: torch.Tensor, w, b=None, *,
                            plan_n: Optional[int] = None) -> torch.Tensor:
    """Serving-path Boolean dense on stored Boolean weights.

    int8 ±1 ``x``: against an int8 weight ``boolean_matmul`` gives the int32
    counts; against a ``PackedBool`` weight ``x`` is packed along K and the fully
    packed ``packed_xnor_matmul`` gives the counts, returned in fp32 as the
    JAX package returns them (its GEMV casts x before the grid). Real ``x``:
    a ``PackedBool`` weight routes thin-M (decode, short prefill)
    contractions through the packed-XNOR GEMV and returns fp32, wider ones
    unpack transiently to a ±1 view; an int8 weight takes the mixed-type
    rule xnor(w, x) = e(w)·x. ``plan_n`` is the GEMV's (``packed_xnor_gemv``).
    """
    lead = x.shape[:-1]
    if isinstance(w, PackedBool):
        m = 1
        for d in lead:
            m *= d
        if x.dtype == torch.int8:
            xp = pack_bits(x.reshape(-1, x.shape[-1]), axis=-1)
            y = packed_xnor_matmul(xp, w.bits, k_valid=w.k).to(torch.float32)
            y = y.reshape(*lead, y.shape[-1])
        elif m > PACKED_GEMV_MAX_M:
            wv = unpack_bits(w.bits, w.k, axis=-2).to(x.dtype)
            y = matmul_f32(x, wv)
        else:
            y = packed_xnor_gemv(x.reshape(-1, x.shape[-1]).contiguous(),
                                 w.bits, k_valid=w.k, plan_n=plan_n)
            y = y.reshape(*lead, y.shape[-1])
    elif x.dtype == torch.int8:
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = boolean_matmul(x2, w).reshape(*lead, w.shape[-1])
    else:
        y = matmul_f32(x, w.to(x.dtype)).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y
