"""Mamba-1 block (falcon-mamba, jamba) with Boolean projections.

The four projections around the recurrence — in_x/in_z, x_proj, dt_proj,
out_proj — carry Boolean weights (packed, they run the packed-XNOR GEMV);
the selective-scan recurrence stays FP, as in the JAX package's
``models/mamba.py``, where it is XLA code and not a Pallas kernel.

Prefill: the chunked selective scan. The JAX package carries h over chunks
of ``ssm_chunk`` positions and runs ``lax.associative_scan`` of
(d1·d2, d2·x1 + x2) within each; torch has no associative scan, so each
chunk runs a log-depth doubling scan over its positions (7 steps at 128).
Its rounding order differs from XLA's, so states agree within an fp32
tolerance, not bit for bit. A cumulative product with a division would
underflow: exp(dt·A) over 128 steps leaves fp32's range at A up to 16. The
chunks are scanned one at a time, so the (B, Q, d_inner, N) scan tensors
of one chunk are the largest live.

Decode: the O(1) single-step state update; the state is lane-indexed in a
serving pool and never paged.

Under a training mesh's "model" split (``modules.model_mesh``)
d_inner splits, as the JAX package's specs place it: this rank's columns
of ``in_x`` / ``in_z`` / ``dt_proj``, its channels of the conv, of
``dt_bias``, ``A_log`` and ``D`` and so of the scan, and its rows of
``x_proj`` and ``out_proj``, whose partial outputs (dt, B, C and the
block's output) are summed over "model". B and C feed every rank's
channels: their grads are summed over "model" too. The prefill and
decode steps split alike, and the state {"h", "conv"} of a rank holds
its d_inner channels (the JAX package's cache specs).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.spans import span

from .modules import (ModelConfig, copy_to_group, fp_weight, model_mesh,
                      proj_apply, proj_init)


def mamba_init(gen: torch.Generator, cfg: ModelConfig, lead=()):
    """S4D-real A (A_log = log 1..N), dt bias so softplus(dt) spans
    [1e-3, 1e-1], the standard mamba init; ``lead`` stacks groups."""
    D, DI, N, R = cfg.d_model, cfg.d_inner_, cfg.ssm_state, cfg.dt_rank_
    dev = gen.device
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev) \
        .expand(*lead, DI, N)
    u = torch.rand((*lead, DI), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_x": proj_init(gen, cfg, D, DI, lead=lead),
        "in_z": proj_init(gen, cfg, D, DI, lead=lead),
        "conv_w": fp_weight(gen, (*lead, cfg.conv_width, DI),
                            scale=1.0 / math.sqrt(cfg.conv_width)),
        "conv_b": torch.zeros((*lead, DI), device=dev),
        "x_proj": proj_init(gen, cfg, DI, R + 2 * N, lead=lead),
        "dt_proj": proj_init(gen, cfg, R, DI, lead=lead),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),      # inverse softplus
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones((*lead, DI), device=dev),
        "out_proj": proj_init(gen, cfg, DI, D, lead=lead),
    }


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` forms it: max(x, 0) +
    log1p(e^-|x|)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, b, conv0=None):
    """Depthwise causal conv over the sequence. x: (B, S, DI); w: (W, DI).

    ``conv0`` (B, W-1, DI), optional: the last W-1 inputs BEFORE this
    sequence (a cached prefix's boundary state); they replace the zero
    left padding, so a tail continues the conv where the prefix left off."""
    W, S = w.shape[0], x.shape[1]
    if conv0 is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([conv0.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return out + b[None, None, :]


def _ssm_params(cfg: ModelConfig, p, xc, mesh=None):
    """xc: (..., DI) conv-activated input -> (dt, Bmat, Cmat), fp32. Under
    a "model" split (``mesh``) xc and dt are this rank's channels."""
    N, R = cfg.ssm_state, cfg.dt_rank_
    dbc = proj_apply(cfg, p["x_proj"], xc, rows=mesh)
    if mesh is None:
        dt_r, Bm, Cm = torch.split(dbc, [R, N, N], dim=-1)
        group = None
    else:
        group = mesh.group("model")
        dt_r = dbc[..., :R]
        Bm, Cm = torch.split(copy_to_group(dbc[..., R:], group), [N, N],
                             dim=-1)
    dt = proj_apply(cfg, p["dt_proj"], dt_r, group=group)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    return dt, Bm.to(torch.float32), Cm.to(torch.float32)


def _scan_chunk(decay, xbar, h0):
    """One chunk of the selective scan: decay, xbar (B, Q, DI, N) with
    decay = exp(dt·A), xbar = dt·B·x; h0 (B, DI, N) -> every position's
    state (B, Q, DI, N). Log-depth doubling: after the step at offset s,
    (decay[t], xbar[t]) compose positions t-2s+1..t under
    (d1, x1) ∘ (d2, x2) = (d1·d2, d2·x1 + x2)."""
    Q, s = decay.shape[1], 1
    while s < Q:
        xbar = torch.cat([xbar[:, :s], torch.addcmul(
            xbar[:, s:], decay[:, s:], xbar[:, :-s])], dim=1)
        decay = torch.cat([decay[:, :s], decay[:, s:] * decay[:, :-s]], dim=1)
        s *= 2
    return decay * h0[:, None] + xbar


def mamba_ssm(cfg: ModelConfig, p, xc, dt, Bm, Cm, h0=None,
              chunk: int = 128, hs_at=None):
    """Selective scan. xc: (B, S, DI); dt: (B, S, DI) fp32; Bm/Cm: (B, S, N)
    fp32. Returns (y (B, S, DI) in xc's dtype, h_final (B, DI, N)); with
    ``hs_at`` (positions b, 1 <= b <= S) also the states after the first b
    tokens, stacked (B, len(hs_at), DI, N): the JAX package's per-position
    states ``hs[:, b - 1]``."""
    with span("mamba.scan"):
        Bsz, S, DI = xc.shape
        A = -torch.exp(p["A_log"].to(torch.float32))            # (DI, N)
        h = torch.zeros((Bsz, DI, cfg.ssm_state), dtype=torch.float32,
                        device=xc.device) if h0 is None \
            else h0.to(torch.float32)
        xf = xc.to(torch.float32)
        want = {} if hs_at is None \
            else {b - 1: i for i, b in enumerate(hs_at)}
        kept = [None] * len(want)
        ys = []
        for q0 in range(0, S, chunk):
            q1 = min(q0 + chunk, S)
            d = dt[:, q0:q1]
            decay = torch.exp(d[..., None] * A[None, None])
            xbar = (d * xf[:, q0:q1])[..., None] * Bm[:, q0:q1, None, :]
            hs = _scan_chunk(decay, xbar, h)
            del decay, xbar
            ys.append(torch.einsum("bsdn,bsn->bsd", hs, Cm[:, q0:q1]))
            for t in range(q0, q1):
                if t in want:
                    kept[want[t]] = hs[:, t - q0]
            h = hs[:, -1]
            del hs
        y = torch.cat(ys, dim=1) \
            + p["D"].to(torch.float32)[None, None] * xf
        if hs_at is not None:
            return y.to(xc.dtype), h, torch.stack(kept, dim=1)
        return y.to(xc.dtype), h


def mamba_apply(cfg: ModelConfig, p, x, h0=None, conv0=None,
                return_state: bool = False, length=None, state_at=None):
    """Train/prefill block body. x: (B, S, D) -> out (B, S, D).

    ``length`` (optional): the true sequence length when ``x`` is right-
    padded to a bucket. dt is 0 at and past it (decay 1, input 0: the
    recurrence's identity) and the conv state is sliced at it, so the
    returned state equals an unpadded run's.

    ``h0``/``conv0``: the boundary state of a cached prefix; the sequence
    continues from it instead of from zeros.

    ``return_state``: also return (h_final, conv_state (B, W-1, DI)).
    ``state_at`` (positions): also return the snapshots {"h": (B, len, DI,
    N), "conv": (B, len, W-1, DI)}, the state after the first b tokens for
    each b (prefix-cache page boundaries). Past ``length`` they hold the
    frozen state at ``length`` and garbage conv rows, which callers drop.
    """
    W, S = cfg.conv_width, x.shape[1]
    mesh = model_mesh(cfg)
    group = None if mesh is None else mesh.group("model")
    xin = proj_apply(cfg, p["in_x"], x, group=group)
    z = proj_apply(cfg, p["in_z"], x, group=group)
    xconv = _causal_conv(xin, p["conv_w"].to(torch.float32), p["conv_b"],
                         conv0=conv0).to(x.dtype)
    xc = F.silu(xconv.to(torch.float32)).to(x.dtype)
    dt, Bm, Cm = _ssm_params(cfg, p, xc, mesh)
    if length is not None:
        live = torch.arange(S, device=x.device) < int(length)
        dt = torch.where(live[None, :, None], dt, 0.0)
    y, h_last, *hs = mamba_ssm(cfg, p, xc, dt, Bm, Cm, h0,
                               chunk=cfg.ssm_chunk, hs_at=state_at)
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    out = proj_apply(cfg, p["out_proj"], y, rows=mesh)
    if not return_state:
        return out
    # conv history with conv0 (or zeros) prepended: rows [b-W+1, b) of the
    # input stream sit at xp[:, b:b+W-1] for any b
    if conv0 is None:
        xp = F.pad(xin, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([conv0.to(xin.dtype), xin], dim=1)
    end = S if length is None else int(length)
    conv_state = xp[:, end:end + W - 1]
    if state_at is None:
        return out, (h_last, conv_state)
    snaps = {"h": hs[0],
             "conv": torch.stack([xp[:, b:b + W - 1] for b in state_at], 1)}
    return out, (h_last, conv_state), snaps


def mamba_cache_init(cfg: ModelConfig, batch: int, device, lead=()):
    """Zeroed fp32 {"h": (*lead, batch, DI, N), "conv": (*lead, batch, W-1,
    DI)}; DI this rank's channels under a "model" split (``model_mesh``)."""
    mesh = model_mesh(cfg)
    DI, N, W = cfg.d_inner_, cfg.ssm_state, cfg.conv_width
    if mesh is not None:
        DI //= mesh.shape["model"]
    return {"h": torch.zeros((*lead, batch, DI, N), device=device),
            "conv": torch.zeros((*lead, batch, W - 1, DI), device=device)}


def mamba_cache_lane_write(pool, state, lane: int):
    """Write one request's state into lane ``lane`` of a lane-indexed pool,
    in place. pool leaves (n_groups, lanes, ...); state leaves (n_groups,
    1, ...) from a batch-1 prefill (admission is one lane write; eviction
    abandons the lane)."""
    for name, full in pool.items():
        full[:, lane] = state[name][:, 0].to(full.dtype)
    return pool


def mamba_decode(cfg: ModelConfig, p, x, cache):
    """One-token decode. x: (B, 1, D); cache: {"h": (B, DI, N), "conv": (B,
    W-1, DI)} -> (out (B, 1, D), new state). Under a "model" split
    (``model_mesh``) DI is this rank's channels, as in ``mamba_apply``."""
    mesh = model_mesh(cfg)
    group = None if mesh is None else mesh.group("model")
    xin = proj_apply(cfg, p["in_x"], x, group=group)[:, 0]      # (B, DI)
    z = proj_apply(cfg, p["in_z"], x, group=group)[:, 0]
    conv_hist = torch.cat([cache["conv"], xin[:, None].to(cache["conv"].dtype)],
                          dim=1)
    w = p["conv_w"].to(torch.float32)                            # (W, DI)
    xconv = torch.sum(conv_hist * w[None], dim=1) + p["conv_b"][None]
    xc = F.silu(xconv).to(x.dtype)
    dt, Bm, Cm = _ssm_params(cfg, p, xc[:, None], mesh)
    dt, Bm, Cm = dt[:, 0], Bm[:, 0], Cm[:, 0]
    A = -torch.exp(p["A_log"].to(torch.float32))
    decay = torch.exp(dt[..., None] * A[None])                   # (B, DI, N)
    h = decay * cache["h"] \
        + (dt * xc.to(torch.float32))[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm) \
        + p["D"].to(torch.float32)[None] * xc.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z.to(torch.float32)).to(x.dtype)
    out = proj_apply(cfg, p["out_proj"], y[:, None], rows=mesh)
    return out, {"h": h, "conv": conv_hist[:, 1:]}
