"""Model substrate: config dataclass, parameter init, shared modules.

Parameters are nested dicts of tensors with the same tree as the JAX
package's ``models/modules.py`` (Boolean weights are int8 ±1 leaves, stacked
per group on a leading axis by ``lm_init``), so a JAX parameter tree bridges
over leaf by leaf (``repro_torch.bridge``).

The JAX package's ``constrain`` (a ``with_sharding_constraint`` against the
launcher's mesh) has no counterpart: the port computes eagerly on local
tensors, which have no layout to constrain. ``use_sharding_constraints``
selects the mesh paths, as in the JAX package: the training forward and
the prefill and decode steps on this rank's "model" slices
(``model_mesh``: the heads, d_ff, the mamba d_inner, the experts and the
vocab; ``launch/shardings.py``), and the prefill's and decode's cache
rows over ``cache_seq_axes`` (``models/attention.py``), under the training
mesh the launcher installs (``distributed.set_mesh``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import (PackedBool, boolean_dense,
                              boolean_dense_inference, matmul_f32,
                              random_boolean)
from repro_torch.core.boolean_linear import all_reduce_sum
from repro_torch.distributed import (TrainMesh, get_mesh, reduce_from_group,
                                     vocab_embed)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of the JAX package's ``ModelConfig``, with its defaults.
    ``block_grad_barriers`` is accepted and changes nothing: in the JAX
    package it places an ``optimization_barrier`` for XLA's scheduler, and
    eager autograd has no scheduler to reorder the blocks' grads."""
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

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False   # arctic: dense FFN beside the MoE
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"       # einsum (GShard dispatch) | scatter
    dense_ff: int = 0              # width of the non-MoE dense FFN
    moe_groups: int = 1            # routing groups (capacity is per group)

    # SSM (mamba-1)
    ssm_state: int = 0
    d_inner: int = 0               # 0 -> 2 * d_model
    conv_width: int = 4
    dt_rank: int = 0               # 0 -> d_model // 16
    ssm_chunk: int = 128           # selective-scan chunk (prefill)

    # hybrid (jamba)
    group_size: int = 1            # layers per stacked group
    attn_index: int = -1

    # B⊕LD knobs
    boolean: bool = True           # Boolean projections (int8 weights)
    act_boolean: bool = True       # threshold activation in FFN hidden
    sign_backward: bool = False    # 1-bit inter-layer backprop signal
    bwd_norm: bool = True          # App-C.4 variance normalization

    # frontend
    frontend: str = "tokens"       # tokens | embeddings (audio/vlm stub)

    # numerics / memory
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True             # recompute each group in the backward
    remat_policy: str = "full"     # full | save_block_outs (each block's two
    # residual branch outputs kept, the rest recomputed: models/lm.py)
    long_context: bool = False     # eligible for long_500k (ssm/hybrid)
    attn_chunk: int = 1024         # flash-attention KV chunk
    decode_chunk: int = 2048       # contiguous flash-decode KV chunk
    kv_cache_quant: bool = False   # int8 KV cache (kv-quant slice)
    reduce_bf16: bool = False      # projections and their activation grads
    # in x.dtype, not fp32, so the cross-shard partials are bf16
    block_grad_barriers: bool = False  # XLA scheduling only: a no-op here

    # distribution (set by the launcher; the defaults run mesh-free)
    batch_axes: tuple = ("data",)  # mesh axes the batch rows shard over
    cache_seq_axes: tuple = ()     # decode: mesh axes the cache rows shard over
    use_sharding_constraints: bool = False   # run the mesh paths
    serve_tp: int = 1              # serve-time tensor parallelism over the
    # 1-D ("model",) serve mesh: the model body runs at the head-local
    # counts hp/serve_tp and kvp/serve_tp, and gathers the heads before the
    # replicated wo (attention._wo_project); set by the engine from its mesh

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
    def d_inner_(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(self.d_model // 16, 1)

    @property
    def dense_ff_(self) -> int:
        return self.dense_ff or self.d_ff

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
def model_mesh(cfg: ModelConfig) -> Optional[TrainMesh]:
    """The training mesh whose "model" axis the model splits over (the
    heads, d_ff, d_inner, the experts, the vocab), or None: a ``TrainMesh``
    installed under ``use_sharding_constraints`` with a "model" axis of
    more than one rank. The training step and the prefill and decode steps
    split alike; beside the split the prefill and decode hold the cache
    rows over ``cfg.cache_seq_axes``."""
    if not cfg.use_sharding_constraints:
        return None
    mesh = get_mesh()
    if not isinstance(mesh, TrainMesh):
        raise RuntimeError("use_sharding_constraints outside a training "
                           "mesh (the launcher installs one: set_mesh)")
    return mesh if mesh.shape.get("model", 1) > 1 else None


def proj_apply(cfg: ModelConfig, p, x, *, scale: Optional[float] = None,
               plan_n: Optional[int] = None, group=None,
               replicated: bool = False, rows: Optional[TrainMesh] = None):
    """Apply a projection. Boolean path: counting GEMM, then the
    deterministic 1/√fan_in pre-activation normalizer (App C.3), fan_in
    the whole weight's. ``plan_n``: a packed shard's whole column count,
    so the serving GEMV sums each column as the unsharded launch does
    (``packed_xnor_gemv``). ``group``: ``p`` holds this rank's output
    columns of a weight whose other columns live on the other ranks of
    that process group (head-parallel training); the activation grad is
    summed over it (``boolean_dense``, ``copy_to_group``). With
    ``replicated`` ``p`` is the whole weight on every rank of ``group``,
    each rank reading part of its output: the weight's grads are summed
    over the group as well. ``rows``: ``p`` holds this rank's input rows
    of a weight whose other rows live on the other "model" ranks of that
    training mesh (``x`` is this rank's slice of the input features): the
    partial products are summed over "model" before the cast to x's dtype
    (``reduce_from_group``; fp32 partials, x's dtype under
    ``reduce_bf16``), the bias added once after."""
    w = p["w"]
    b = p.get("b")
    if isinstance(w, PackedBool):
        y = boolean_dense_inference(x, w, plan_n=plan_n).to(x.dtype)
        s = (1.0 / math.sqrt(w.k)) if scale is None else scale
        y = y * torch.tensor(s, dtype=y.dtype)
        if b is not None:
            y = y + b.to(y.dtype)
        return y
    if w.dtype == torch.int8:
        w = w.to(cfg.dtype)
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    shards = 1 if group is None or replicated else dist.get_world_size(group)
    fan_in = w.shape[0] * (1 if rows is None else rows.shape["model"])
    if replicated and b is not None:
        b = copy_to_group(b, group)
    if cfg.boolean:
        y = boolean_dense(x, w, None, cfg.bwd_norm, cfg.sign_backward,
                          cfg.reduce_bf16, group, w.shape[-1] * shards,
                          replicated, keep_f32=rows is not None)
        if rows is not None:
            y = reduce_from_group(y, rows).to(x.dtype)
        s = (1.0 / math.sqrt(fan_in)) if scale is None else scale
        y = y * torch.tensor(s, dtype=y.dtype)
        if b is not None:
            y = y + b.to(y.dtype)
        return y
    if group is not None:
        x = copy_to_group(x, group)
        if replicated:
            w = copy_to_group(w, group)
    y = torch.matmul(x, w) if cfg.reduce_bf16 else matmul_f32(x, w)
    if rows is not None:
        y = reduce_from_group(y, rows)
    y = y.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the grad over the group (the
    input of a column-sharded projection, Megatron-LM's copy-to-region)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


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


def embed_apply(cfg: ModelConfig, p, tokens, mesh: Optional[TrainMesh] = None):
    """The scaled token embeddings. ``mesh``: ``p`` holds this "model"
    rank's vocab rows, looked up vocab-parallel (``vocab_embed``: exact)."""
    if mesh is not None:
        return vocab_embed(p["table"], tokens, mesh) * math.sqrt(cfg.d_model)
    return p["table"][tokens.long()] * math.sqrt(cfg.d_model)


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap > 0 else x


def head_apply(cfg: ModelConfig, p, x, mesh: Optional[TrainMesh] = None):
    """fp32 (B, S, vocab_padded) logits with the final softcap. ``mesh``:
    ``p`` holds this "model" rank's vocab columns, and so do the logits
    (B, S, vocab_padded / tp); the grad of ``x`` is summed over "model"."""
    if mesh is not None:
        x = copy_to_group(x, mesh.group("model"))
    return softcap(matmul_f32(x, p["w"]), cfg.final_logit_softcap)
