"""Model substrate: config dataclass, parameter init, shared modules.

Parameters are nested dicts of tensors with the same tree as the JAX
package's ``models/modules.py`` (Boolean weights are int8 ±1 leaves, stacked
per group on a leading axis by ``lm_init``), so a JAX parameter tree bridges
over leaf by leaf (``repro_torch.bridge``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import (PackedBool, boolean_dense,
                              boolean_dense_inference, matmul_f32,
                              random_boolean)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The architecture and training fields of the JAX package's
    ``ModelConfig``. Its mesh and sharding fields have no counterpart yet;
    ``reduce_bf16``, ``remat_policy="save_block_outs"`` and
    ``block_grad_barriers`` exist for cross-shard and XLA scheduling and
    raise ``NotImplementedError`` until the multi-device slice."""
    name: str
    family: str                    # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention flavour
    qkv_bias: bool = False
    sliding_window: int = 0        # >0 enables local attention layers
    alt_local_global: bool = False # gemma2: alternate local/global
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0

    # MoE (block roles only; the MoE blocks are not ported yet)
    n_experts: int = 0
    moe_dense_residual: bool = False

    # hybrid (jamba)
    group_size: int = 1            # layers per stacked group
    attn_index: int = -1

    # B⊕LD knobs
    boolean: bool = True           # Boolean projections (int8 weights)
    act_boolean: bool = True       # threshold activation in FFN hidden
    sign_backward: bool = False    # 1-bit inter-layer backprop signal
    bwd_norm: bool = True          # App-C.4 variance normalization

    # frontend
    frontend: str = "tokens"

    # numerics / memory
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True             # recompute each group in the backward
    remat_policy: str = "full"     # "save_block_outs": multi-device slice
    attn_chunk: int = 1024         # flash-attention KV chunk
    kv_cache_quant: bool = False   # int8 KV cache (kv-quant slice)
    reduce_bf16: bool = False      # bf16 cross-shard partials: multi-device
    block_grad_barriers: bool = False  # XLA scheduling: multi-device

    def __post_init__(self):
        if self.reduce_bf16 or self.block_grad_barriers \
                or self.remat_policy != "full":
            raise NotImplementedError(
                "reduce_bf16, block_grad_barriers and remat_policy="
                f"{self.remat_policy!r} serve cross-shard training; they "
                "come with the multi-device slice")

    # -- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def heads_padded(self, axis_size: int = 16) -> int:
        """Q heads padded up to a multiple of the TP axis (padded heads are
        masked to zero post-attention; Boolean weights cannot be zeroed)."""
        return -(-self.n_heads // axis_size) * axis_size

    def kv_heads_padded(self, axis_size: int = 16) -> int:
        if self.n_kv_heads >= axis_size:
            return -(-self.n_kv_heads // axis_size) * axis_size
        return self.n_kv_heads  # replicated over the model axis instead

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // 256) * 256

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.group_size:
            raise ValueError(f"{self.n_layers} layers do not split into groups "
                             f"of {self.group_size}")
        return self.n_layers // self.group_size

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


# ---------------------------------------------------------------------------
# Init (an explicit torch.Generator; leaves are made on its device)
# ---------------------------------------------------------------------------
def fp_weight(gen: torch.Generator, shape, scale: float = 1.0,
              dtype=torch.float32) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def proj_init(gen: torch.Generator, cfg: ModelConfig, d_in: int, d_out: int,
              bias: bool = False, lead=()):
    """A projection: Boolean int8 (B⊕LD) or FP (baseline). ``lead`` stacks
    groups on leading axes."""
    p = {}
    if cfg.boolean:
        p["w"] = random_boolean((*lead, d_in, d_out), gen)
    else:
        p["w"] = fp_weight(gen, (*lead, d_in, d_out),
                           scale=1.0 / math.sqrt(d_in), dtype=cfg.dtype)
    if bias:
        p["b"] = torch.zeros((*lead, d_out), device=gen.device)
    return p


def rmsnorm_init(d: int, device, lead=()):
    return {"scale": torch.ones((*lead, d), device=device)}


def embed_init(gen: torch.Generator, cfg: ModelConfig):
    return {"table": fp_weight(gen, (cfg.vocab_padded, cfg.d_model),
                               scale=0.02, dtype=cfg.dtype)}


def head_init(gen: torch.Generator, cfg: ModelConfig):
    # Last layer stays FP (paper's standard setup).
    return {"w": fp_weight(gen, (cfg.d_model, cfg.vocab_padded),
                           scale=1.0 / math.sqrt(cfg.d_model),
                           dtype=cfg.dtype)}


# ---------------------------------------------------------------------------
# Projection dispatch: packed Boolean, int8 Boolean, or FP — one call site.
# ---------------------------------------------------------------------------
def proj_apply(cfg: ModelConfig, p, x, *, scale: Optional[float] = None):
    """Apply a projection. Boolean path: counting GEMM, then the
    deterministic 1/√fan_in pre-activation normalizer (App C.3)."""
    w = p["w"]
    b = p.get("b")
    if isinstance(w, PackedBool):
        y = boolean_dense_inference(x, w).to(x.dtype)
        s = (1.0 / math.sqrt(w.k)) if scale is None else scale
        y = y * torch.tensor(s, dtype=y.dtype)
        if b is not None:
            y = y + b.to(y.dtype)
        return y
    if w.dtype == torch.int8:
        w = w.to(cfg.dtype)
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    if cfg.boolean:
        y = boolean_dense(x, w, None, cfg.bwd_norm, cfg.sign_backward)
        s = (1.0 / math.sqrt(w.shape[0])) if scale is None else scale
        y = y * torch.tensor(s, dtype=y.dtype)
        if b is not None:
            y = y + b.to(y.dtype)
        return y
    y = matmul_f32(x, w).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms / rotary / embeddings / head
# ---------------------------------------------------------------------------
def rmsnorm_apply(p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding, half-split. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                     -torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freq
    ang = ang[..., None, :]                                   # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_apply(cfg: ModelConfig, p, tokens):
    return p["table"][tokens.long()] * math.sqrt(cfg.d_model)


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap > 0 else x


def head_apply(cfg: ModelConfig, p, x):
    """fp32 (B, S, vocab_padded) logits with the final softcap."""
    return softcap(matmul_f32(x, p["w"]), cfg.final_logit_softcap)
