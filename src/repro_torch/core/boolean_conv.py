"""Boolean 2-D convolution (the paper's CNN experiments: VGG-SMALL, EDSR).

Layouts are the JAX package's: activations NHWC, weights HWIO, padding
``"SAME"`` (JAX's rule: at stride 2 on an even size it pads (0, 1)) or
``"VALID"``.

``boolean_conv2d`` is the training route, the same variation calculus as
the dense layer: the embedded forward is a standard convolution of the ±1
weight view, summed in fp32, and the backward is the convolution's VJP
(Remark C.1/C.2) with App C's variance normalisation (Eq 43/47) on δx,
``sign_backward`` projecting it to ±1, and the weight votes in the view's
dtype (the JAX package's ``core/boolean_conv.py``).

``boolean_conv2d_inference`` is the route of an int8 ±1 input against
stored Boolean weights: im2col in (kh, kw, cin) order with the padding as
zeros, then one GEMM of exact integer counts —

* int8 HWIO weights: ``boolean_matmul`` (int8 ±1 × int8 ±1 → int32 counts,
  or the threshold fused into the kernel);
* ``PackedBool`` weights from ``pack_boolean_weight`` (bits packed along
  Cin per tap, (kh, kw, ceil(Cin/32), Cout)): the input packed along C,
  im2col over words with all-F (0) words as padding, then
  ``packed_xnor_matmul``. The kernel reads a pad tap as Cin F inputs, which
  add −Σ_c e(w[t, c, :]) where the zero padding adds nothing, so that
  column sum is added back for each output pixel's pad taps: an exact
  integer correction, a (pixels, taps) pad mask times a (taps, Cout) table.

Both give the counts the float convolution gives on the same ±1 operands.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import (boolean_matmul, pack_bits, packed_xnor_matmul,
                                 unpack_bits)

from .activation import boolean_activation_inference
from .boolean_linear import PackedBool
from .scaling import backward_scale_conv


def same_pads(n: int, k: int, stride: int, padding: str):
    """((lo, hi), out) along one spatial axis of size ``n``, by JAX's rule."""
    if padding == "VALID":
        return (0, 0), (n - k) // stride + 1
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return (total // 2, total - total // 2), out


@contextlib.contextmanager
def _ieee_fp32():
    """cuDNN convolutions in IEEE fp32 (no TF32) inside, whatever the
    process-wide setting, which PyTorch defaults to TF32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv2dF32(torch.autograd.Function):
    """An unpadded NCHW fp32 ``F.conv2d`` whose forward and VJP both run in
    IEEE fp32."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _ieee_fp32():
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _ieee_fp32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [ctx.stride] * 2, [0, 0], [1, 1], False,
                [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                            False])
        return gx, gw, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """NHWC ⊛ HWIO -> NHWC, summed in IEEE fp32 (TF32 off on the card) and
    returned in x's dtype (the JAX package's ``conv_general_dilated`` with
    ``preferred_element_type=float32``); differentiable."""
    kh, kw = w.shape[0], w.shape[1]
    (pt, pb), _ = same_pads(x.shape[1], kh, stride, padding)
    (pl, pr), _ = same_pads(x.shape[2], kw, stride, padding)
    xc = x.permute(0, 3, 1, 2).to(torch.float32)
    xc = F.pad(xc, (pl, pr, pt, pb))
    y = _Conv2dF32.apply(xc, w.permute(3, 2, 0, 1).to(torch.float32), stride)
    return y.permute(0, 2, 3, 1).to(x.dtype)


class _BooleanConv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, bwd_norm, sign_backward):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, bwd_norm, sign_backward)
        return conv2d(x, w, stride, padding)

    @staticmethod
    def backward(ctx, z):
        x, w = ctx.saved_tensors
        stride, padding, bwd_norm, sign_backward = ctx.conf
        with torch.enable_grad():
            x_ = x.detach().requires_grad_()
            w_ = w.detach().requires_grad_()
            gx, gw = torch.autograd.grad(conv2d(x_, w_, stride, padding),
                                         (x_, w_), z)
        if bwd_norm:
            kh, kw, _, cout = w.shape
            gx = (gx.to(torch.float32)
                  * backward_scale_conv(cout, kh, kw, stride)).to(x.dtype)
        if sign_backward:
            gx = torch.where(gx >= 0, 1.0, -1.0).to(x.dtype)
        return gx, gw.to(w.dtype), None, None, None, None


def boolean_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                   padding: str = "SAME", bwd_norm: bool = True,
                   sign_backward: bool = False) -> torch.Tensor:
    """x: (N, H, W, Cin) real or ±1; w: (kh, kw, Cin, Cout) ±1 weight view
    (float), whose gradient is the vote tensor of the flip rule."""
    return _BooleanConv2d.apply(x, w, stride, padding, bwd_norm, sign_backward)


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME"):
    """(N, H, W, C) -> ((N·Ho·Wo, kh·kw·C) patches in (kh, kw, c) order with
    the padding as zeros, Ho, Wo), for any dtype."""
    N, H, W, C = x.shape
    (pt, pb), Ho = same_pads(H, kh, stride, padding)
    (pl, pr), Wo = same_pads(W, kw, stride, padding)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    taps = [xp[:, dy:dy + (Ho - 1) * stride + 1:stride,
               dx:dx + (Wo - 1) * stride + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(taps, dim=3).reshape(N * Ho * Wo, kh * kw * C), Ho, Wo


@functools.lru_cache(maxsize=64)
def pad_taps(H: int, W: int, kh: int, kw: int, stride: int = 1,
             padding: str = "SAME", device=None) -> torch.Tensor:
    """(Ho·Wo, kh·kw) int32: 1 where an output pixel's tap reads padding.
    Built once per input shape and device; callers must not modify it."""
    masks = []
    for n, k in ((H, kh), (W, kw)):
        (lo, _), out = same_pads(n, k, stride, padding)
        pos = (torch.arange(out, device=device)[:, None] * stride - lo
               + torch.arange(k, device=device)[None, :])
        masks.append((pos >= 0) & (pos < n))              # (out, k) inside
    inside = masks[0][:, None, :, None] & masks[1][None, :, None, :]
    return (~inside).reshape(-1, kh * kw).to(torch.int32)


def is_stored_boolean(w) -> bool:
    """An int8 or bit-packed Boolean leaf (the inference routes), not a
    float ±1 view (the training route)."""
    return isinstance(w, PackedBool) or w.dtype == torch.int8


def weight_view(w, dtype) -> torch.Tensor:
    """The ±1 view of a Boolean leaf (float, int8 or ``PackedBool``) in
    ``dtype``."""
    if isinstance(w, PackedBool):
        w = unpack_bits(w.bits, w.k, axis=-2)
    return w.to(dtype)


def boolean_conv2d_inference(x: torch.Tensor, w, stride: int = 1,
                             padding: str = "SAME", *,
                             fuse_threshold: bool = False,
                             tau: float = 0.0) -> torch.Tensor:
    """int8 ±1 x (N, H, W, Cin) ⊛ Boolean w -> (N, Ho, Wo, Cout) int32
    counts, or int8 ±1 (counts ≥ tau) with ``fuse_threshold``.

    w: int8 ±1 (kh, kw, Cin, Cout), through ``boolean_matmul`` (the
    threshold fused into the kernel); or a ``PackedBool`` with bits (kh,
    kw, ceil(Cin/32), Cout) and k = Cin, through ``packed_xnor_matmul`` and
    the pad-tap correction (the threshold applied to the corrected counts).
    """
    if x.dtype != torch.int8:
        raise TypeError(f"the inference conv takes an int8 ±1 input, got {x.dtype}")
    N, H, W, _ = x.shape
    if isinstance(w, PackedBool):
        kh, kw, cw, cout = w.bits.shape
        cols, Ho, Wo = im2col(pack_bits(x, axis=-1), kh, kw, stride, padding)
        s = packed_xnor_matmul(cols, w.bits.reshape(kh * kw * cw, cout),
                               k_valid=kh * kw * w.k)
        mask = pad_taps(H, W, kh, kw, stride, padding, x.device)
        corr = (mask[:, :, None] * w.colsum().reshape(1, kh * kw, cout)).sum(
            1, dtype=torch.int32)
        s = (s.reshape(N, Ho * Wo, cout) + corr).reshape(N, Ho, Wo, cout)
        return boolean_activation_inference(s, tau) if fuse_threshold else s
    kh, kw, cin, cout = w.shape
    cols, Ho, Wo = im2col(x, kh, kw, stride, padding)
    s = boolean_matmul(cols, w.reshape(kh * kw * cin, cout).contiguous(),
                       fuse_threshold=fuse_threshold, tau=tau)
    return s.reshape(N, Ho, Wo, cout)
