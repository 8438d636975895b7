"""The two model families the benchmark runs, in plain PyTorch: the dense
decoder (GQA with q heads padded to a multiple of 16 and masked, RoPE,
q/k/v biases, the gated FFN) and the Mamba-1 block, with Boolean ±1
projections scaled by 1/sqrt(fan-in) (B⊕LD, App. C.3), the norms' (1 +
scale), the embedding scaled by sqrt(d_model) and an FP head.

Differences from the port by design: attention is the exact softmax over
all keys in fp32 (no flash blocks, no pages, no rounding of p); the SSM
recurrence runs position by position (no chunks, no doubling); every
projection is one matmul (no packed words, no GEMV, no fused q/k/v or
gate/up). A Boolean projection's backward is the paper's (Eqs. 5-8):
δx = δy·Wᵀ·sqrt(2/fan-out), the votes δW = xᵀ·δy in fp32 rounded to the
weight view's type.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from bench.reference.numerics import Numerics, inv_sqrt, mm
from bench.yardstick.work import Sizes

EPS = 1e-6


# ---- projections -----------------------------------------------------------
class _BoolLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, num):
        ctx.save_for_backward(x, w)
        ctx.num = num
        return num.r(mm(x, w))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        num = ctx.num
        z = num.r(g)
        gx = num.r(mm(z, w.t()) * math.sqrt(2.0 / w.shape[1]))
        x2 = x.reshape(-1, x.shape[-1])
        votes = mm(x2.t().contiguous(), z.reshape(-1, z.shape[-1]))
        return gx, num.r(votes), None


class _FPLinear(torch.autograd.Function):
    """x @ w for an FP weight (the head): fp32 result; δx rounded to the
    activation type, δw to bf16 (the leaf's type)."""

    @staticmethod
    def forward(ctx, x, w, num):
        ctx.save_for_backward(x, w)
        ctx.num = num
        return mm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = ctx.num.r(g @ w.t().to(torch.float32))
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        gw = x2.t() @ g.reshape(-1, g.shape[-1])
        return gx, gw.to(torch.bfloat16).to(torch.float32), None


def proj(num: Numerics, x, p):
    """A Boolean projection: (x·W) rounded, times 1/sqrt(fan-in) rounded,
    plus the bias rounded."""
    w = p["w"]
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _BoolLinear.apply(x, w, num)
    else:
        y = num.r(mm(x, w))
    y = num.r(y * num.scalar(inv_sqrt(w.shape[0]), x.device))
    if "b" in p:
        y = num.r(y + num.r(p["b"]))
    return y


def head(num: Numerics, x, w):
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _FPLinear.apply(x, w, num)
    return mm(x, w)


def rmsnorm(num: Numerics, x, scale):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return num.r(x * torch.rsqrt(var + EPS) * (1.0 + scale))


def embed(num: Numerics, table, tokens, d_model: int):
    return num.r(table[tokens.long()] * math.sqrt(d_model))


# ---- attention -------------------------------------------------------------
def rope(num: Numerics, x, pos, theta: float):
    """Half-split rotary embedding of x (T, H, hd) at positions pos (T,)."""
    half = x.shape[-1] // 2
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                     -torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = (pos[:, None].to(torch.float32) * freq)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return num.r(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1))


def attention(num: Numerics, q, k, v, n_heads: int, block: int = 512):
    """Causal softmax attention of q (T, hp, hd) over k, v (T, kvp, hd),
    q head h reading KV head h // (hp / kvp); heads >= n_heads (the
    padding) give zero. Exact fp32 softmax, output rounded."""
    T, hp, hd = q.shape
    kvp = k.shape[1]
    R = hp // kvp
    qg = q.reshape(T, kvp, R, hd)
    outs = []
    for t0 in range(0, T, block):
        t1 = min(T, t0 + block)
        s = torch.einsum("tgrd,sgd->grts", qg[t0:t1], k[:t1]) / math.sqrt(hd)
        mask = torch.arange(t0, t1, device=q.device)[:, None] \
            >= torch.arange(t1, device=q.device)[None, :]
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("grts,sgd->tgrd", p, v[:t1]))
    out = num.r(torch.cat(outs, 0).reshape(T, hp, hd))
    live = (torch.arange(hp, device=q.device) < n_heads).to(out.dtype)
    return out * live[None, :, None]


def dense_block(num: Numerics, s: Sizes, model: dict, lw, x, pos):
    """One decoder block over one sequence x (T, D) at positions pos."""
    T = x.shape[0]
    hd = s.hd
    h = rmsnorm(num, x, lw["norm1"]["scale"])
    a = lw["attn"]
    q = rope(num, proj(num, h, a["wq"]).reshape(T, s.hp, hd), pos,
             model["rope_theta"])
    k = rope(num, proj(num, h, a["wk"]).reshape(T, s.kvp, hd), pos,
             model["rope_theta"])
    v = proj(num, h, a["wv"]).reshape(T, s.kvp, hd)
    o = attention(num, q, k, v, s.n_heads)
    x = num.r(x + proj(num, o.reshape(T, s.hp * hd), a["wo"]))
    h = rmsnorm(num, x, lw["norm2"]["scale"])
    f = lw["ffn"]
    g, u = proj(num, h, f["wg"]), proj(num, h, f["wu"])
    if model.get("act_boolean", True):
        act = torch.where(g - num.r(f["tau"]) >= 0, 1.0, -1.0)
    else:
        act = num.r(F.silu(g))
    return num.r(x + proj(num, num.r(act * u), f["wd"]))


# ---- mamba -----------------------------------------------------------------
def _softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def scan(decay, xbar):
    """h_t = decay_t · h_(t-1) + xbar_t from h_(-1) = 0, every t, over
    the whole sequence at once (B, S, ...): a Hillis-Steele scan of the
    pairs (decay, xbar) under (d1, x1) ∘ (d2, x2) = (d1·d2, d2·x1 + x2),
    log2(S) steps."""
    S, s = decay.shape[1], 1
    while s < S:
        xbar = torch.cat([xbar[:, :s], xbar[:, s:] + decay[:, s:]
                          * xbar[:, :-s]], dim=1)
        decay = torch.cat([decay[:, :s], decay[:, s:] * decay[:, :-s]], dim=1)
        s *= 2
    return xbar


def mamba_block(num: Numerics, s: Sizes, lw, x):
    """One Mamba-1 block over x (B, S, D)."""
    Bsz, S, _ = x.shape
    N, R, W = s.ssm_state, s.r, s.conv_width
    m = lw["mamba"]
    h = rmsnorm(num, x, lw["norm1"]["scale"])
    xin = proj(num, h, m["in_x"])
    z = proj(num, h, m["in_z"])
    xp = F.pad(xin, (0, 0, W - 1, 0))
    conv = sum(xp[:, i:i + S] * m["conv_w"][i] for i in range(W))
    xc = num.r(F.silu(num.r(conv + m["conv_b"])))
    dbc = proj(num, xc, m["x_proj"])
    dt_r, Bm, Cm = torch.split(dbc, [R, N, N], dim=-1)
    dt = _softplus(proj(num, dt_r, m["dt_proj"]) + m["dt_bias"])
    A = -torch.exp(m["A_log"])                                  # (DI, N)
    decay = torch.exp(dt[..., None] * A)                        # (B,S,DI,N)
    xbar = (dt * xc)[..., None] * Bm[:, :, None, :]
    hs = scan(decay, xbar)
    y = torch.einsum("bsdn,bsn->bsd", hs, Cm) + m["D"] * xc
    y = num.r(num.r(y) * num.r(F.silu(z)))
    return num.r(x + proj(num, y, m["out_proj"]))


# ---- whole model, served -----------------------------------------------
def bool_views(tree, device=None):
    """int8 ±1 leaves as fp32 ±1 (the projections' view), others fp32."""
    if isinstance(tree, dict):
        return {k: bool_views(v, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=torch.float32)


@torch.no_grad()
def served_logits(model: dict, seed: int, seqs: List[torch.Tensor],
                  firsts: List[int], num: Numerics, device) -> List:
    """fp32 logits (T - first, vocab) of each token sequence at positions
    first..T-1, the model run layer by layer over all the sequences so
    that one layer's weights are held at a time."""
    from bench import weights

    s = Sizes.of(model)
    g = bool_views(weights.global_weights(model, seed, device))
    xs = [embed(num, g["embed"]["table"].float(), t.to(device), s.d_model)
          for t in seqs]
    poss = [torch.arange(t.shape[0], device=device) for t in seqs]
    for layer in range(s.n_layers):
        lw = bool_views(weights.layer_weights(model, seed, layer, device))
        for i, x in enumerate(xs):
            if s.family == "ssm":
                xs[i] = mamba_block(num, s, lw, x[None])[0]
            else:
                xs[i] = dense_block(num, s, model, lw, x, poss[i])
        del lw
    out = []
    for x, first in zip(xs, firsts):
        h = rmsnorm(num, x[first:], g["final_norm"]["scale"])
        out.append(head(num, h, g["head"]["w"])[:, :s.vocab_size])
    return out
