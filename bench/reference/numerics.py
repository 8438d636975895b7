"""Where the models round, and to what.

The configurations state bfloat16 activations with float32 sums: every
projection sums in fp32 and rounds its output to bf16, as do the norms,
RoPE, the attention output and the residual adds; logits, softmax, the
SSM scan and the loss stay fp32. ``Numerics`` holds values in fp32
tensors and rounds them at those points to ``act``: bf16 for the
reference, float8 e4m3 with a per-tensor scale for the control (the
next precision below the stated one). A rounded tensor's gradient is
rounded alike (a bf16 tensor's grad is bf16).
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _to_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().to(torch.float32)
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (x / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return q.to(torch.float32) * scale


class Numerics:
    """``act``: "bfloat16" (the configurations' precision), "fp8" (the
    control), or "float32" (an fp32 model, as the CPU tests run the
    port)."""

    def __init__(self, act: str = "bfloat16"):
        fns = {"bfloat16": _to_bf16, "fp8": _to_fp8,
               "float32": lambda x: x.to(torch.float32)}
        if act not in fns:
            raise ValueError(f"unknown activation precision {act!r}")
        self.act = act
        self._fn = fns[act]

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to the activation type (and its grad, under
        autograd), held in fp32."""
        if x.requires_grad:
            return _Round.apply(x, self._fn)
        return self._fn(x)

    def scalar(self, v: float, device) -> torch.Tensor:
        """A Python number as the activation type holds it."""
        return self._fn(torch.tensor(v, dtype=torch.float32, device=device))


def setup_matmuls() -> None:
    """fp32 products in fp32: no TF32, no reduced-precision split-K sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) summed in fp32. Both hold bf16-exact values
    (activations rounded to bf16 or fp8, ±1 or bf16 weights), so on the
    card the product runs on bf16 operands with an fp32 result; on the
    CPU in fp32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        y = torch.mm(x2.to(torch.bfloat16), w.to(torch.bfloat16),
                     out_dtype=torch.float32)
    else:
        y = x2.to(torch.float32) @ w.to(torch.float32)
    return y.reshape(*lead, w.shape[-1])


def inv_sqrt(n: int) -> float:
    return 1.0 / math.sqrt(n)
