"""Attention: GQA with Boolean projections, chunked flash attention for
training, the flash-prefill kernel for cold prefill, the prefix-cache tail
prefill over in-place pool pages, sliding-window + global alternation
(gemma2), logit softcap, the int8 KV cache with per-(token, head) scales,
the contiguous one-token decode of ``generate`` and the block-table paged
decode of continuous batching.

Q heads are padded up to a multiple of 16 and the padded heads' outputs are
masked to zero before the o-projection, because Boolean ±1 weights cannot
encode zero rows (the JAX package's layout, kept so weights bridge over).

Under serve-time tensor parallelism (``cfg.serve_tp``, a serve mesh's
engine) the serving bodies run at the head-local counts of ``_tp_heads``
on this rank's column slice of q/k/v and its KVp slice of the page pools,
and gather the heads before the replicated ``wo`` (``_wo_project``)
over the serve mesh the engine runs them under (``distributed.serving``).

Under a training mesh (``cfg.use_sharding_constraints``, the launcher's
``TrainMesh``) the training attention runs head-parallel over its "model"
axis: this rank's column slices of q/k/v (``launch.shardings.
train_param_specs``), attention at the head-local counts, the heads
gathered before the ``wo`` replicated over "model"
(``distributed.gather_heads``), the activation grad of the q/k/v input
summed over the axis. Their FSDP slices over "data" are gathered with
the layer group's (``models.lm``) before the block runs. The prefill
and decode steps split alike (the JAX package places them as it places
training) and hold the cache rows over ``cfg.cache_seq_axes``: the
prefill runs the flash-prefill kernel on this rank's q heads, gathers
the heads before ``wo`` and keeps its slab of the prompt's rows, every
KV head (``attention_prefill_mesh``); the decode gathers q (and split
k/v) over "model", writes the new row into its slab, reads the slab and
combines the softmax statistics across the slabs (``attention_decode``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import PackedBool
from repro_torch.distributed import active_mesh, gather_heads, get_mesh
from repro_torch.kernels import (flash_attention_fwd, paged_flash_decode,
                                 paged_prefix_attention)
from repro_torch.kernels.paged_attention import (  # noqa: F401 (reference names)
    flash_attention_abs, gather_prefix_rows)

from .modules import (ModelConfig, model_mesh, proj_apply, proj_init, rope,
                      softcap)


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


def _tp_heads(cfg: ModelConfig, axis_size: int = 16):
    """(hp_local, kvp_local): a rank's head counts under serve-time TP, the
    global padded counts at ``serve_tp == 1``. Heads are group-major and
    the engine checks that serve_tp divides kvp, so hp_local // kvp_local
    is the global group size."""
    return (cfg.heads_padded(axis_size) // cfg.serve_tp,
            cfg.kv_heads_padded(axis_size) // cfg.serve_tp)


def _proj_cols(cfg: ModelConfig, p, x):
    """A q/k/v projection of this rank's columns, its serving GEMV planned
    for the whole weight's columns (``packed_xnor_gemv``'s ``plan_n``)."""
    w = p["w"]
    n = (w.bits if isinstance(w, PackedBool) else w).shape[-1]
    return proj_apply(cfg, p, x, plan_n=n * cfg.serve_tp)


def _qkv(cfg: ModelConfig, p, x, positions, axis_size: int = 16):
    """Project to (B,S,Hp,hd) q and (B,S,KVp,hd) k/v with RoPE applied: the
    head-local counts under serve-time TP (the fused wqkv is this rank's
    shard-major [q_r|k_r|v_r] block)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    hp, kvp = _tp_heads(cfg, axis_size)
    if "wqkv" in p:
        # packed serving layout (pack_weights): one GEMV for q, k and v
        qkv = _proj_cols(cfg, p["wqkv"], x)
        q, k, v = torch.split(qkv, [hp * hd, kvp * hd, kvp * hd], dim=-1)
    else:
        q = _proj_cols(cfg, p["wq"], x)
        k = _proj_cols(cfg, p["wk"], x)
        v = _proj_cols(cfg, p["wv"], x)
    q = rope(q.reshape(B, S, hp, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, kvp, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, kvp, hd)


def _group(cfg: ModelConfig, axis_size: int = 16) -> int:
    """q heads a KV head serves, hp // kvp. A KV head count that does not
    divide the padded q heads (bold-bert at full width: 12 under 16) is no
    whole group, and the JAX package's attention fails on it too: raise."""
    hp = cfg.heads_padded(axis_size)
    kvp = cfg.kv_heads_padded(axis_size)
    if hp % kvp:
        raise ValueError(f"{cfg.name}: {kvp} KV heads do not divide the "
                         f"{hp} padded q heads into whole groups")
    return hp // kvp


def _head_mask(cfg: ModelConfig, out, axis_size: int = 16, shard=None):
    """Zero the padded q-head outputs (Boolean wo rows are ±1, not 0).
    ``out`` holds shard ``rank`` of ``n`` of the heads (``shard`` = (rank,
    n); by default the serve mesh's rank and ``serve_tp``), so the test is
    on GLOBAL head indices: rank × local heads + local index."""
    hp = cfg.heads_padded(axis_size)
    if hp == cfg.n_heads:
        return out
    if shard is None:
        shard = (_serve_mesh(cfg).rank, cfg.serve_tp) if cfg.serve_tp > 1 \
            else (0, 1)
    rank, n = shard
    hp_l = hp // n
    mask = (torch.arange(rank * hp_l, (rank + 1) * hp_l, device=out.device)
            < cfg.n_heads).to(out.dtype)
    return out * mask[None, None, :, None]


def _serve_mesh(cfg: ModelConfig):
    mesh = active_mesh()
    if mesh is None or mesh.size != cfg.serve_tp:
        raise RuntimeError(f"serve_tp={cfg.serve_tp} outside a serve mesh of "
                           "that size (ServeEngine(mesh=) runs the model)")
    return mesh


def _wo_project(cfg: ModelConfig, p_wo, out):
    """o-projection of (B, S, hp_local·hd) head activations. Under
    serve-time TP the heads are all-gathered first (shard-major is the
    global head order) and the REPLICATED wo is applied to the whole
    activation, not a partial wo summed across ranks: that sum would
    reassociate wo's fan-in and ``sign()`` turns its ulps into token
    flips, where the gather keeps the projection's arithmetic the
    unsharded graph's. The gathered bytes are O(B·hp·hd) a step, noise
    beside the pool reads sharding divides. ``serve_tp == 1`` (a mesh of
    one too) is the unsharded path, as in the JAX package: a one-rank
    gather would only copy, at ~0.23 ms of host a call on the card."""
    if cfg.serve_tp > 1:
        B, S, _ = out.shape
        out = _serve_mesh(cfg).all_gather_heads(
            out.reshape(B, S, -1, cfg.head_dim_), axis=2).reshape(B, S, -1)
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


def gather_prefix_kv(cfg: ModelConfig, bcache, page_ids):
    """Gather a cached prefix's K/V rows out of one block's page pool.

    bcache: a stacked-groups pool block ({"k"/"v": (G, n_pages, page, KVp,
    hd)} plus scale pools under kv_cache_quant); page_ids: (npp,) int32
    physical pages (garbage-page 0 padding allowed — the caller masks rows
    past ``prefix_len``). Returns {"k"/"v": (G, 1, npp*page, KVp, hd)}
    dequantised to fp32: exactly the values decode reads for those rows.
    """
    def rows(name):
        scale = bcache[f"{name}_scale"] if cfg.kv_cache_quant else None
        return gather_prefix_rows(bcache[name], page_ids, scale)[:, None]

    return {"k": rows("k"), "v": rows("v")}


def flash_prefix_attention_paged(cfg: ModelConfig, bcache, page_ids, q, k, v,
                                 offset: int, prefix_len: int,
                                 length: Optional[int], *, local: bool = False):
    """Tail-prefill attention over a cached prefix read IN PLACE from pool
    pages (``kernels.paged_prefix_attention``; its plain version is
    ``gather_prefix_kv`` + ``flash_attention_abs``).

    bcache: one block's group-sliced pool leaves ({"k"/"v": (n_pages, page,
    KVp, hd)} plus scale pools under kv_cache_quant); page_ids: (npp,) int32
    physical prefix pages on the pool's device (garbage-page padding
    allowed); q: (1, S, Hp, hd) tail queries; k/v: (1, S, KVp, hd) the
    tail's own rows (before the GQA repeat); offset: the absolute position
    of tail row 0 (the JAX package passes ``positions``, whose first entry
    it is); prefix_len / length: live prefix rows / true tail rows
    (``length`` None means S). Returns (1, S, Hp, hd) in q's dtype.
    """
    B, S, hp, hd = q.shape
    if B != 1:
        raise ValueError("paged prefix attention serves batch-1 admission "
                         f"prefills; got batch {B}")
    kvp = k.shape[2]
    out = paged_prefix_attention(
        q[0].transpose(0, 1).contiguous(), k[0].contiguous(),
        v[0].contiguous(), bcache["k"], bcache["v"], page_ids, offset,
        prefix_len, S if length is None else length,
        bcache.get("k_scale"), bcache.get("v_scale"), n_rep=hp // kvp,
        window=cfg.sliding_window if local else 0,
        softcap_val=cfg.attn_logit_softcap, chunk=cfg.attn_chunk)
    return out.transpose(0, 1)[None].to(q.dtype)


def _qkv_split(cfg: ModelConfig, p, x, positions, mesh, axis_size: int = 16):
    """q/k/v under a "model" split of tp ranks, RoPE applied -> (q (B, S,
    hp/tp, hd): this rank's q heads; k, v (B, S, kvp/tp, hd): its KV heads,
    or every KV head where they are replicated; the KV head this rank's q
    heads read then, else None). ``p``'s q/k/v hold this rank's columns
    (contiguous, group-major, so a rank's q heads read its own KV heads),
    or k/v whole when the KV heads do not divide the axis (tp a multiple of
    kvp), as the JAX package places them; the activation grad of ``x`` is
    summed over the axis and replicated k/v's votes too."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    hp, kvp = cfg.heads_padded(axis_size), cfg.kv_heads_padded(axis_size)
    tp = mesh.shape["model"]
    rep = kvp % tp != 0
    if rep and (tp % kvp or hp % tp):
        raise ValueError(f"{cfg.name}: {kvp} KV heads neither split over "
                         f"nor evenly share a model axis of {tp}")
    if rep and p["wk"]["w"].shape[-1] != kvp * hd:
        raise ValueError("k/v must be replicated on a model axis wider "
                         "than the KV heads (launch.shardings."
                         "train_param_specs(replicate_kv=True))")
    group = mesh.group("model")
    q = proj_apply(cfg, p["wq"], x, group=group)
    k, v = (proj_apply(cfg, p[name], x, group=group, replicated=rep)
            .reshape(B, S, -1, hd) for name in ("wk", "wv"))
    q = rope(q.reshape(B, S, hp // tp, hd), positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    j = mesh.coords["model"] // (tp // kvp) if rep else None
    return q, k, v, j


def attention_apply(cfg: ModelConfig, p, x, positions, *,
                    local: bool = False, axis_size: int = 16):
    """Full training/prefill attention block body (no residual/norm).

    Head-parallel under a training mesh of tp "model" ranks
    (``modules.model_mesh``): this rank's hp/tp q and kvp/tp KV heads
    (``_qkv_split``), the padded-head mask on global head indices, and the
    heads gathered before the replicated ``wo``. With fewer KV heads than
    ranks (tp a multiple of kvp) k/v are replicated, as the JAX package
    places them: every rank computes all KV heads, its q heads read KV
    head ``rank // (tp / kvp)``, and the k/v votes are summed over the
    axis (``proj_apply(replicated=True)``)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    hp = cfg.heads_padded(axis_size)
    n_rep = _group(cfg, axis_size)
    mesh = model_mesh(cfg)
    shard = (0, 1)
    if mesh is None:
        q, k, v = _qkv(cfg, p, x, positions, axis_size)
    else:
        q, k, v, j = _qkv_split(cfg, p, x, positions, mesh, axis_size)
        if j is not None:
            # every KV head on every rank: this rank's q heads read one
            k, v = k[:, :, j:j + 1], v[:, :, j:j + 1]
        n_rep = q.shape[2] // k.shape[2]
        shard = (mesh.coords["model"], mesh.shape["model"])
    out = flash_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                          causal=True,
                          window=cfg.sliding_window if local else 0,
                          softcap_val=cfg.attn_logit_softcap,
                          chunk=cfg.attn_chunk)
    out = _head_mask(cfg, out, axis_size, shard)
    if mesh is not None:
        out = gather_heads(out, mesh, 2)
    return proj_apply(cfg, p["wo"], out.reshape(B, S, hp * hd))


def attention_prefill_mesh(cfg: ModelConfig, p, x, positions, mesh,
                           rows: int, *, local: bool = False,
                           axis_size: int = 16):
    """The cold prefill's attention under a "model" split -> (its output
    (B, S, D), this rank's cache entry: ``kv_cache_entry``'s leaves of its
    slab of a cache of ``rows`` rows over ``cfg.cache_seq_axes``, every KV
    head, (B, rows / n, KVp, ...); the prompt's rows past S are zeros).

    The flash-prefill kernel runs on this rank's q heads over their KV
    heads (``_qkv_split``: for gemma2-2b on 16 ranks one q head over one KV
    head, n_rep 1); the heads are gathered before ``wo``. The slab: where
    k/v are replicated every rank holds every KV head at every position
    and keeps its rows, no collective; where they are split the ranks
    trade heads for rows in one all-to-all over "model" a layer (k and v
    together, and their scales under ``kv_cache_quant``): a rank sends each
    other rank its heads at that rank's rows, (n - 1) / n of its k/v."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q, k, v, j = _qkv_split(cfg, p, x, positions, mesh, axis_size)
    ka, va = (k, v) if j is None else (k[:, :, j:j + 1], v[:, :, j:j + 1])
    hp_l = q.shape[2]

    def heads(t):                 # (B, S, heads, hd) -> (B*heads, S, hd)
        return t.transpose(1, 2).reshape(-1, S, hd).contiguous()

    out = flash_attention_fwd(
        heads(q), heads(ka), heads(va), causal=True,
        window=cfg.sliding_window if local else 0,
        softcap=cfg.attn_logit_softcap, n_rep=hp_l // ka.shape[2])
    out = out.reshape(B, hp_l, S, hd).transpose(1, 2)
    out = _head_mask(cfg, out, axis_size,
                     (mesh.coords["model"], mesh.shape["model"]))
    out = gather_heads(out, mesh, 2)
    y = proj_apply(cfg, p["wo"], out.reshape(B, S, -1))
    return y, cache_slab(cfg, kv_cache_entry(cfg, k, v), rows,
                         split=j is None)


def cache_slab(cfg: ModelConfig, entry, rows: int, split: bool = False):
    """This rank's slab of a cache of ``rows`` rows over
    ``cfg.cache_seq_axes`` (slab r: rows [r·rows/n, (r+1)·rows/n), r the
    rank's row-major index over those axes) from a prefill's cache entry
    ``entry`` ({"k", "v"[, "k_scale", "v_scale"]}: (B, S, heads, ...),
    S <= rows). ``split``: the entry holds this "model" rank's slice of
    the KV heads, and "model" is the last of the slabs' axes: the rank
    takes the block of rows its other axes index (long_500k's rows over
    every axis; every rank of that block holds them), and one all-to-all
    over "model" a pair of leaves trades heads for every head at the
    slab's rows (the prompt's rows padded with zeros to ``rows``); else
    every rank holds every head and slices its rows (the slab's leaves are
    shorter than rows / n where the prompt ends inside or before it)."""
    mesh = get_mesh()
    axes = tuple(cfg.cache_seq_axes)
    n, r = mesh.size_of(axes), mesh.index(axes)
    if rows % n:
        raise ValueError(f"{rows} cache rows do not split over {n} slabs")
    s_loc = rows // n
    if not split:
        return {k: t[:, r * s_loc:(r + 1) * s_loc] for k, t in entry.items()}
    if axes[-1:] != ("model",):
        raise ValueError("split KV heads trade for cache rows over 'model', "
                         f"the last of the slabs' axes, not {axes}")
    tp = mesh.size_of("model")
    lo = mesh.index(axes[:-1]) * tp * s_loc      # this block's first row
    out = {}
    for a, b in (("k", "v"), ("k_scale", "v_scale")):
        if a not in entry:
            continue
        kv = torch.stack([entry[a], entry[b]], 2)   # (B, S, 2, heads, ...)
        B, S = kv.shape[:2]
        if S < rows:
            kv = torch.cat([kv, kv.new_zeros((B, rows - S) + kv.shape[2:])],
                           1)
        kv = kv[:, lo:lo + tp * s_loc]
        blocks = kv.reshape(B, tp, s_loc, *kv.shape[2:]).movedim(1, 0)
        got = mesh.all_to_all(blocks, "model")   # block i: rank i's heads
        # (n, B, s_loc, 2, heads, ...) -> (2, B, s_loc, n * heads, ...)
        got = got.movedim(3, 0).movedim(1, 3)
        got = got.reshape(2, B, s_loc, -1, *got.shape[5:])
        out[a], out[b] = got[0], got[1]
    return out


# ---------------------------------------------------------------------------
# KV cache + paged decode
# ---------------------------------------------------------------------------
# int8 cache rows carry a PER-(token, head) fp32 scale computed at write
# time: scale = max|row| / 127, stored beside the k/v pools, so every row
# spans its own int8 range.
def kv_quant(x):
    """x: (..., hd) -> (int8 rows, fp32 per-row scale (...,)): a true
    division, round half to even, clip to ±127 (the JAX package's
    ``kv_quant``, bit for bit)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequant(x, scale=None):
    if x.dtype == torch.int8:
        return x.to(torch.float32) * scale[..., None]
    return x.to(torch.float32)


def kv_cache_entry(cfg: ModelConfig, k, v):
    """The prefill write payload of one attention block: int8 rows + their
    scales under cfg.kv_cache_quant, cfg.dtype rows otherwise (the leaves
    of ``attention_cache_init``)."""
    if cfg.kv_cache_quant:
        kq, ks = kv_quant(k)
        vq, vs = kv_quant(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k.to(cfg.dtype), "v": v.to(cfg.dtype)}


def attention_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                         device, lead=(), axis_size: int = 16):
    """Zeroed {"k", "v"}: (*lead, batch, max_len, KVp, hd) in cfg.dtype, or
    int8 with fp32 {"k_scale", "v_scale"}: (*lead, batch, max_len, KVp)
    under cfg.kv_cache_quant; KVp head-local under serve-time TP."""
    shape = (*lead, batch, max_len, _tp_heads(cfg, axis_size)[1],
             cfg.head_dim_)
    dtype = torch.int8 if cfg.kv_cache_quant else cfg.dtype
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.kv_cache_quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    return cache


def attention_decode(cfg: ModelConfig, p, x, cache, pos: int, *,
                     local: bool = False):
    """One-token decode over a CONTIGUOUS cache (``generate``): plain
    torch, as the JAX package leaves it to XLA.

    x: (B, 1, D); cache{k, v}: (B, Smax, KVp, hd) in cfg.dtype, or int8
    with {"k_scale", "v_scale"}: (B, Smax, KVp) under kv_cache_quant,
    UPDATED IN PLACE with the new token's row at ``pos`` (an int, every
    row of the batch at the same position). The read is the JAX package's
    ``_flash_decode_local``. Returns (out, cache). Under
    ``use_sharding_constraints`` with ``cache_seq_axes`` the cache holds
    this rank's slab of the rows and ``pos`` is global
    (``_decode_seq_sharded``); under a "model" split (``model_mesh``) q/k/v
    are this rank's heads, gathered over "model" first (``_qkv_gathered``),
    so the read, the head mask and the ``wo`` (whole over "model") see
    every head, as the unsharded decode does.

    The cache has the paged pool's layout (B pages of Smax rows, block
    table ``arange(B)[:, None]``), but this read stays its own copy: the
    JAX package runs no kernel here, and the paged op on a CUDA tensor
    must launch one (never its plain version), which would give
    ``generate`` kernel launches and numbers the reference does not have,
    and the CUDA-core kernel wherever ``max_len`` is not a power of two
    (``decode_route``).
    """
    B = x.shape[0]
    hd = cfg.head_dim_
    hp, kvp = cfg.heads_padded(), cfg.kv_heads_padded()
    n_rep = _group(cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    mesh = model_mesh(cfg)
    if mesh is None:
        q, k_new, v_new = _qkv(cfg, p, x, positions)
    else:
        q, k_new, v_new = _qkv_gathered(cfg, p, x, positions, mesh)
    qg = q[:, 0].reshape(B, kvp, n_rep, hd).to(torch.float32)
    sharded = cfg.use_sharding_constraints and bool(cfg.cache_seq_axes)
    row, here = pos, True
    if sharded:
        # this rank's slab of the rows: the new row is written iff it lands
        # there
        s_loc = cache["k"].shape[1]
        row = pos - get_mesh().index(cfg.cache_seq_axes) * s_loc
        here = 0 <= row < s_loc
    if cache["k"].dtype == torch.int8:
        k_new, ks_new = kv_quant(k_new)
        v_new, vs_new = kv_quant(v_new)
        if here:
            cache["k_scale"][:, row] = ks_new[:, 0]
            cache["v_scale"][:, row] = vs_new[:, 0]
    if here:
        cache["k"][:, row] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, row] = v_new[:, 0].to(cache["v"].dtype)

    if sharded:
        out = _decode_seq_sharded(cfg, qg, cache, pos, local)
    else:
        m, l, acc = _flash_decode_local(cfg, qg, cache, pos, 0, local)
        out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.reshape(B, 1, hp, hd).to(x.dtype)
    out = _head_mask(cfg, out)
    return _wo_project(cfg, p["wo"], out.reshape(B, 1, hp * hd)), cache


def _qkv_gathered(cfg: ModelConfig, p, x, positions, mesh):
    """A decode token's q/k/v under a "model" split, every head on every
    rank: this rank's heads (``_qkv_split``) gathered over "model" in one
    all-gather, q with k/v where they are split (replicated k/v are whole
    already) -> (q (B, 1, hp, hd), k, v (B, 1, kvp, hd))."""
    q, k, v, j = _qkv_split(cfg, p, x, positions, mesh)
    hp_l, kv_l = q.shape[2], (0 if j is not None else k.shape[2])
    parts = [q] if j is not None else [q, k, v]
    got = mesh.all_gather(torch.cat(parts, 2)[None], "model", 0,
                          count="head_gathers")      # (tp, B, 1, heads, hd)
    tp = got.shape[0]

    def whole(lo, n):
        return got[:, :, :, lo:lo + n].movedim(0, 2).reshape(
            got.shape[1], got.shape[2], tp * n, -1)

    if j is not None:
        return whole(0, hp_l), k, v
    return whole(0, hp_l), whole(hp_l, kv_l), whole(hp_l + kv_l, kv_l)


def _flash_decode_local(cfg: ModelConfig, qg, cache, pos: int, offset: int,
                        local: bool):
    """The JAX package's ``_flash_decode_local``: (m, l, acc) of qg (B, KVp,
    R, hd) fp32 over the cache rows, row i at position ``offset + i``: fp32
    scores over chunks of ``cfg.decode_chunk`` rows with an online softmax,
    rows valid at kpos <= pos (and kpos > pos - window on a local layer)."""
    B, kvp, n_rep, hd = qg.shape
    S = cache["k"].shape[1]
    scale = 1.0 / math.sqrt(hd)
    c = min(cfg.decode_chunk, S)
    m = torch.full((B, kvp, n_rep), -1e30, device=qg.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, kvp, n_rep, hd), device=qg.device)
    for c0 in range(0, S, c):
        rows = slice(c0, min(S, c0 + c))
        kf = kv_dequant(cache["k"][:, rows], cache["k_scale"][:, rows]
                        if "k_scale" in cache else None)
        vf = kv_dequant(cache["v"][:, rows], cache["v_scale"][:, rows]
                        if "v_scale" in cache else None)
        s = torch.einsum("bgrd,bcgd->bgrc", qg, kf) * scale
        s = softcap(s, cfg.attn_logit_softcap)
        kpos = torch.arange(offset + rows.start, offset + rows.stop,
                            device=qg.device)
        valid = kpos <= pos
        if local and cfg.sliding_window > 0:
            valid &= kpos > pos - cfg.sliding_window
        s = torch.where(valid, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        pexp = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + pexp.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgrc,bcgd->bgrd", pexp, vf)
        m = m_new
    return m, l, acc


def _decode_seq_sharded(cfg: ModelConfig, qg, cache, pos: int,
                        local: bool):
    """The JAX package's ``_decode_shardmap``: this rank holds the cache
    rows [offset, offset + S_loc) of a cache whose rows shard over
    ``cfg.cache_seq_axes`` (slab index: the row-major index over those
    axes), its read runs over its slab from that offset, and the softmax
    statistics combine across the slabs with one MAX and two SUM
    all-reduces of O(B·H·hd). The new row was written by the caller iff
    ``pos`` lands in the slab."""
    mesh = get_mesh()
    axes = cfg.cache_seq_axes
    offset = mesh.index(axes) * cache["k"].shape[1]
    m, l, acc = _flash_decode_local(cfg, qg, cache, pos, offset, local)
    m_g = mesh.all_reduce(m.clone(), axes, dist.ReduceOp.MAX,
                          count="seq_combines")
    corr = torch.exp(m - m_g)
    l_g = mesh.all_reduce(l * corr, axes, count="seq_combines")
    acc_g = mesh.all_reduce(acc * corr[..., None], axes,
                            count="seq_combines")
    return acc_g / torch.clamp(l_g[..., None], min=1e-30)


def attention_decode_paged(cfg: ModelConfig, p, x, cache, block_table, pos,
                           *, local: bool = False):
    """One-token decode over a block-table PAGED cache (continuous batching).

    x: (L,1,D) with L scheduler lanes; cache{k,v}: (n_pages, page, KVp, hd)
    pool blocks (int8 + {"k_scale","v_scale"} (n_pages, page, KVp) under
    kv_cache_quant), UPDATED IN PLACE with the new token's row; block_table:
    (L, C) int32; pos: (L,) int32 per-lane positions. Logical row r of lane
    l lives at ``pool[block_table[l, r // page], r % page]``. Physical page
    0 is the reserved garbage page: idle lanes point at it, and a lane past
    its TABLE is routed to it explicitly — clipping the column would wrap
    the write onto the lane's last real page. Returns (out, cache).

    Under serve-time TP the pool leaves are this rank's KVp slices and the
    kernel reads only head-local pages, its page shares those of the
    unsharded launch (``plan_kv``).
    """
    B = x.shape[0]
    hd = cfg.head_dim_
    hp, kvp = _tp_heads(cfg)
    page = cache["k"].shape[1]
    C = block_table.shape[1]
    q, k_new, v_new = _qkv(cfg, p, x, pos[:, None])
    qg = q[:, 0].reshape(B, kvp, _group(cfg), hd).contiguous()

    col = (pos // page).long()
    in_table = col < C
    page_id = torch.where(
        in_table,
        torch.gather(block_table, 1, col.clamp(0, C - 1)[:, None])[:, 0],
        torch.zeros_like(block_table[:, 0])).long()
    off = (pos % page).long()
    if cache["k"].dtype == torch.int8:
        k_new, ks_new = kv_quant(k_new)
        v_new, vs_new = kv_quant(v_new)
        cache["k_scale"][page_id, off] = ks_new[:, 0]
        cache["v_scale"][page_id, off] = vs_new[:, 0]
    cache["k"][page_id, off] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][page_id, off] = v_new[:, 0].to(cache["v"].dtype)

    out = paged_flash_decode(
        qg, cache["k"], cache["v"], block_table, pos,
        cache.get("k_scale"), cache.get("v_scale"),
        window=cfg.sliding_window if local else 0,
        softcap_val=cfg.attn_logit_softcap, plan_kv=cfg.kv_heads_padded())
    out = out.reshape(B, 1, hp, hd).to(x.dtype)
    out = _head_mask(cfg, out)
    return _wo_project(cfg, p["wo"], out.reshape(B, 1, hp * hd)), cache
