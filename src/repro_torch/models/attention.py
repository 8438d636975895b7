"""Attention: GQA with Boolean projections, chunked flash attention for
training and prefill, sliding-window + global alternation (gemma2), logit softcap, and
the block-table paged decode of continuous batching.

Q heads are padded up to a multiple of 16 and the padded heads' outputs are
masked to zero before the o-projection, because Boolean ±1 weights cannot
encode zero rows (the JAX package's layout, kept so weights bridge over).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import paged_flash_decode

from .modules import ModelConfig, proj_apply, proj_init, rope, softcap


def attention_init(gen: torch.Generator, cfg: ModelConfig, lead=(),
                   axis_size: int = 16):
    hd = cfg.head_dim_
    hp = cfg.heads_padded(axis_size)
    kvp = cfg.kv_heads_padded(axis_size)
    return {
        "wq": proj_init(gen, cfg, cfg.d_model, hp * hd, cfg.qkv_bias, lead),
        "wk": proj_init(gen, cfg, cfg.d_model, kvp * hd, cfg.qkv_bias, lead),
        "wv": proj_init(gen, cfg, cfg.d_model, kvp * hd, cfg.qkv_bias, lead),
        "wo": proj_init(gen, cfg, hp * hd, cfg.d_model, False, lead),
    }


def _qkv(cfg: ModelConfig, p, x, positions, axis_size: int = 16):
    """Project to (B,S,Hp,hd) q and (B,S,KVp,hd) k/v with RoPE applied."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    hp = cfg.heads_padded(axis_size)
    kvp = cfg.kv_heads_padded(axis_size)
    if "wqkv" in p:
        # packed serving layout (pack_weights): one GEMV for q, k and v
        qkv = proj_apply(cfg, p["wqkv"], x)
        q, k, v = torch.split(qkv, [hp * hd, kvp * hd, kvp * hd], dim=-1)
    else:
        q = proj_apply(cfg, p["wq"], x)
        k = proj_apply(cfg, p["wk"], x)
        v = proj_apply(cfg, p["wv"], x)
    q = rope(q.reshape(B, S, hp, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, kvp, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, kvp, hd)


def _head_mask(cfg: ModelConfig, out, axis_size: int = 16):
    """Zero the padded q-head outputs (Boolean wo rows are ±1, not 0)."""
    hp = cfg.heads_padded(axis_size)
    if hp == cfg.n_heads:
        return out
    mask = (torch.arange(hp, device=out.device) < cfg.n_heads).to(out.dtype)
    return out * mask[None, None, :, None]


def _wo_project(cfg: ModelConfig, p_wo, out):
    """o-projection. The JAX package all-gathers the head activations here
    under serve-time tensor parallelism; the port serves on one card, which
    is its ``serve_tp == 1`` path."""
    return proj_apply(cfg, p_wo, out)


def _repeat_kv(x, n_rep: int):
    """(B,S,KV,hd) -> (B,S,KV*n_rep,hd) — GQA group broadcast."""
    if n_rep == 1:
        return x
    B, S, KV, hd = x.shape
    return x[:, :, :, None, :].expand(B, S, KV, n_rep, hd) \
        .reshape(B, S, KV * n_rep, hd)


# ---------------------------------------------------------------------------
# Chunked flash attention (training / prefill)
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap_val: float = 0.0, chunk: int = 1024):
    """Online-softmax attention over KV chunks of ``chunk`` rows.

    q, k, v: (B, S, H, hd) with identical H (kv already group-broadcast).
    window > 0 limits attention to the last ``window`` positions. Scores
    and accumulators are fp32; the probabilities are cast to v's dtype
    before the value product, as in the JAX package. Under ``causal`` the
    KV chunks past the query chunk are skipped: every query row has a valid
    key in its own chunk, so they would add exactly nothing.
    """
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    c = min(chunk, S)
    n = -(-S // c)
    qt = q.transpose(1, 2).to(torch.float32)           # (B, H, S, hd)
    kt = k.transpose(1, 2).to(torch.float32)
    vt = v.transpose(1, 2)
    pos = torch.arange(S, device=q.device)
    out = torch.empty((B, H, S, hd), dtype=torch.float32, device=q.device)
    for qi in range(n):
        qs = slice(qi * c, min(S, (qi + 1) * c))
        qpos = pos[qs]
        m = torch.full((B, H, qpos.numel()), -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, qpos.numel(), hd), device=q.device)
        for ki in range(qi + 1 if causal else n):
            ks = slice(ki * c, min(S, (ki + 1) * c))
            kpos = pos[ks]
            s = torch.matmul(qt[:, :, qs], kt[:, :, ks].transpose(-1, -2)) * scale
            s = softcap(s, softcap_val)
            valid = torch.ones((qpos.numel(), kpos.numel()), dtype=torch.bool,
                               device=q.device)
            if causal:
                valid &= qpos[:, None] >= kpos[None, :]
            if window > 0:
                valid &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(valid, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                p.to(vt.dtype).to(torch.float32), vt[:, :, ks].to(torch.float32))
            m = m_new
        out[:, :, qs] = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def attention_apply(cfg: ModelConfig, p, x, positions, *,
                    local: bool = False, axis_size: int = 16):
    """Full training/prefill attention block body (no residual/norm)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    hp = cfg.heads_padded(axis_size)
    kvp = cfg.kv_heads_padded(axis_size)
    q, k, v = _qkv(cfg, p, x, positions, axis_size)
    out = flash_attention(q, _repeat_kv(k, hp // kvp), _repeat_kv(v, hp // kvp),
                          causal=True,
                          window=cfg.sliding_window if local else 0,
                          softcap_val=cfg.attn_logit_softcap,
                          chunk=cfg.attn_chunk)
    out = _head_mask(cfg, out, axis_size)
    return proj_apply(cfg, p["wo"], out.reshape(B, S, hp * hd))


# ---------------------------------------------------------------------------
# KV cache + paged decode
# ---------------------------------------------------------------------------
def kv_cache_entry(cfg: ModelConfig, k, v):
    """The prefill write payload of one attention block: cfg.dtype rows."""
    if cfg.kv_cache_quant:
        raise NotImplementedError("int8 KV caches come with the kv-quant slice")
    return {"k": k.to(cfg.dtype), "v": v.to(cfg.dtype)}


def attention_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                         device, lead=(), axis_size: int = 16):
    """Zeroed {"k", "v"}: (*lead, batch, max_len, KVp, hd) in cfg.dtype."""
    if cfg.kv_cache_quant:
        raise NotImplementedError("int8 KV caches come with the kv-quant slice")
    shape = (*lead, batch, max_len, cfg.kv_heads_padded(axis_size),
             cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def attention_decode_paged(cfg: ModelConfig, p, x, cache, block_table, pos,
                           *, local: bool = False):
    """One-token decode over a block-table PAGED cache (continuous batching).

    x: (L,1,D) with L scheduler lanes; cache{k,v}: (n_pages, page, KVp, hd)
    pool blocks, UPDATED IN PLACE with the new token's row; block_table:
    (L, C) int32; pos: (L,) int32 per-lane positions. Logical row r of lane
    l lives at ``pool[block_table[l, r // page], r % page]``. Physical page
    0 is the reserved garbage page: idle lanes point at it, and a lane past
    its TABLE is routed to it explicitly — clipping the column would wrap
    the write onto the lane's last real page. Returns (out, cache).
    """
    B = x.shape[0]
    hd = cfg.head_dim_
    hp, kvp = cfg.heads_padded(), cfg.kv_heads_padded()
    page = cache["k"].shape[1]
    C = block_table.shape[1]
    q, k_new, v_new = _qkv(cfg, p, x, pos[:, None])
    qg = q[:, 0].reshape(B, kvp, hp // kvp, hd).contiguous()

    col = (pos // page).long()
    in_table = col < C
    page_id = torch.where(
        in_table,
        torch.gather(block_table, 1, col.clamp(0, C - 1)[:, None])[:, 0],
        torch.zeros_like(block_table[:, 0])).long()
    off = (pos % page).long()
    if cache["k"].dtype == torch.int8:
        raise NotImplementedError("int8 KV pools come with the kv-quant slice")
    cache["k"][page_id, off] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][page_id, off] = v_new[:, 0].to(cache["v"].dtype)

    out = paged_flash_decode(
        qg, cache["k"], cache["v"], block_table, pos,
        window=cfg.sliding_window if local else 0,
        softcap_val=cfg.attn_logit_softcap)
    out = out.reshape(B, 1, hp, hd).to(x.dtype)
    out = _head_mask(cfg, out)
    return _wo_project(cfg, p["wo"], out.reshape(B, 1, hp * hd)), cache
