"""Mixture-of-Experts with Boolean expert weights (moonshot, arctic, jamba).

Router: FP dense + softmax + top-k with renormalised gates and the
Switch/GShard load-balancing loss. Expert FFNs are gated MLPs with Boolean
int8 weights stacked (E, D, F). Two dispatches, as in the JAX package's
``models/moe.py``, both with a static capacity C per expert a routing
group:

* ``einsum``  — GShard dispatch through (T, E, C) one-hot products;
* ``scatter`` — positions in each expert from a cumulative sum, tokens
  scattered into (E, C + 1, D) buffers (slot C swallows overflow) and
  gathered back.

The expert products are plain torch on the ±1 views summed in fp32; the
JAX package leaves them to XLA too (no Pallas kernel).

Under a training mesh's "model" split (``modules.train_model_mesh``) the
experts split, as the JAX package's specs place them (its EP layout):
the router's columns are gathered first (small), so the routing is the
unsharded routing; each rank builds the same dispatch, runs its E / tp
experts on their rows, and the expert outputs are gathered over "model"
before the combine, which then sums in the unsharded order. The grads of
the dispatched tokens and of the replicated ``tau`` are summed over
"model" (each rank's experts see part of them).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import boolean_activation, random_boolean
from repro_torch.distributed import gather_heads

from .modules import ModelConfig, copy_to_group, fp_weight, train_model_mesh


def moe_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int = 0, lead=()):
    d_ff = d_ff or cfg.d_ff
    E, D = cfg.n_experts, cfg.d_model
    if cfg.boolean:
        wg = random_boolean((*lead, E, D, d_ff), gen)
        wu = random_boolean((*lead, E, D, d_ff), gen)
        wd = random_boolean((*lead, E, d_ff, D), gen)
    else:
        sc = 1.0 / math.sqrt(D)
        wg = fp_weight(gen, (*lead, E, D, d_ff), sc, cfg.dtype)
        wu = fp_weight(gen, (*lead, E, D, d_ff), sc, cfg.dtype)
        wd = fp_weight(gen, (*lead, E, d_ff, D), 1.0 / math.sqrt(d_ff),
                       cfg.dtype)
    return {"router": fp_weight(gen, (*lead, D, E), 1.0 / math.sqrt(D)),
            "wg": wg, "wu": wu, "wd": wd,
            "tau": torch.zeros((*lead, d_ff), device=gen.device)}


def _bmm_f32(x, w):
    """(E, C, K) x (E, K, N) summed in fp32 (the ±1 and bf16 operands widen
    exactly)."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def _bmm(cfg: ModelConfig, x, w):
    """An expert product in x's dtype: summed in fp32, or, under
    ``reduce_bf16``, produced in x's dtype so its grads are too (the JAX
    package's ``preferred_element_type``)."""
    if cfg.reduce_bf16:
        return torch.matmul(x, w.to(x.dtype))
    return _bmm_f32(x, w).to(x.dtype)


def _expert_mlp(cfg: ModelConfig, p, xin):
    """xin: (E, C, D) -> (E, C, D) through each expert's gated MLP (E: the
    experts ``p`` holds)."""
    d_ff = p["wg"].shape[-1]
    scale_in = 1.0 / math.sqrt(p["wg"].shape[-2]) if cfg.boolean else 1.0
    scale_hid = 1.0 / math.sqrt(d_ff) if cfg.boolean else 1.0
    g = _bmm(cfg, xin, p["wg"]) * scale_in
    u = _bmm(cfg, xin, p["wu"]) * scale_in
    if cfg.boolean and cfg.act_boolean:
        h = boolean_activation(g, p["tau"].to(g.dtype), 1) * u
    else:
        h = F.silu(g.to(torch.float32)).to(u.dtype) * u
    return _bmm(cfg, h, p["wd"]) * scale_hid


def _route(cfg: ModelConfig, p, xf):
    """xf: (T, D) -> (gates (T, k) fp32, experts (T, k) int64, aux loss)."""
    logits = torch.matmul(xf.to(torch.float32), p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    E = cfg.n_experts
    me = probs.mean(0)                                   # mean router prob
    ce = F.one_hot(experts[:, 0], E).to(torch.float32).mean(0)  # top-1 load
    return gates, experts, E * torch.sum(me * ce)


def _capacity(cfg: ModelConfig, T: int) -> int:
    c = int(math.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def _group_tokens(cfg: ModelConfig, x):
    """(B, S, D) -> (G, T_g, D): capacity and dispatch are per routing
    group (the GShard group dimension)."""
    B, S, D = x.shape
    G = min(cfg.moe_groups, B)
    return x.reshape(G, (B // G) * S, D)


def _arrival(onehot):
    """(T·k, E) one-hot rows -> each row's arrival position in its expert."""
    return ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)


def _local_experts(cfg: ModelConfig, p, xin, mesh):
    """The expert MLP on this rank's experts' rows of the dispatched
    ``xin`` (E, C, D), the outputs of every expert gathered over "model"
    (the whole (E, C, D), this rank's slice of the grad in the backward);
    ``mesh`` None: every expert here."""
    if mesh is None:
        return _expert_mlp(cfg, p, xin)
    el = p["wg"].shape[0]
    lo = mesh.coords["model"] * el
    out = _expert_mlp(cfg, p, xin[lo:lo + el])
    return gather_heads(out, mesh, 0, count="expert_gathers")


def _moe_einsum_group(cfg: ModelConfig, p, xf, mesh=None):
    T, _ = xf.shape
    gates, experts, aux = _route(cfg, p, xf)
    E, k, C = cfg.n_experts, cfg.top_k, _capacity(cfg, T)
    onehot = F.one_hot(experts, E).to(torch.float32)         # (T, k, E)
    pos = _arrival(onehot.reshape(T * k, E)).reshape(T, k).to(torch.int64)
    keep = pos < C
    gates = gates * keep
    # an arrival past C one-hots to zeros, as jax.nn.one_hot does
    pos_oh = (pos[..., None] == torch.arange(C, device=xf.device)) \
        .to(xf.dtype)                                        # (T, k, C)
    disp = torch.einsum("tke,tkc->tec", onehot.to(xf.dtype),
                        pos_oh * keep[..., None].to(xf.dtype))
    comb = torch.einsum("tke,tkc->tec", onehot * gates[..., None],
                        pos_oh.to(torch.float32))
    xd = xf if mesh is None else copy_to_group(xf, mesh.group("model"))
    xin = torch.einsum("td,tec->ecd", xd, disp)              # (E, C, D)
    out = _local_experts(cfg, p, xin, mesh)
    y = torch.einsum("ecd,tec->td", out.to(torch.float32), comb)
    return y, aux


def _moe_scatter_group(cfg: ModelConfig, p, xf, mesh=None):
    T, D = xf.shape
    gates, experts, aux = _route(cfg, p, xf)
    E, k, C = cfg.n_experts, cfg.top_k, _capacity(cfg, T)
    onehot = F.one_hot(experts, E).reshape(T * k, E)
    pos = _arrival(onehot)
    e_flat = experts.reshape(T * k)
    keep = pos < C
    pos_c = torch.where(keep, pos, C)            # overflow -> scratch slot C
    tok_idx = torch.arange(T, device=xf.device).repeat_interleave(k)
    xd = xf if mesh is None else copy_to_group(xf, mesh.group("model"))
    buf = torch.zeros((E, C + 1, D), dtype=xf.dtype, device=xf.device)
    buf.index_put_((e_flat, pos_c), xd[tok_idx], accumulate=True)
    out = _local_experts(cfg, p, buf[:, :C], mesh)
    out_pad = torch.cat([out, torch.zeros((E, 1, D), dtype=out.dtype,
                                          device=out.device)], dim=1)
    got = out_pad[e_flat, pos_c]                 # (T·k, D)
    w = (gates.reshape(T * k) * keep).to(xf.dtype)
    y = torch.zeros((T, D), dtype=xf.dtype, device=xf.device) \
        .index_add_(0, tok_idx, got * w[:, None])
    return y, aux


def moe_apply(cfg: ModelConfig, p, x):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, mean aux loss over the
    routing groups)."""
    group = _moe_scatter_group if cfg.moe_impl == "scatter" \
        else _moe_einsum_group
    mesh = train_model_mesh(cfg)
    if mesh is not None:
        model = mesh.group("model")
        p = dict(p, router=gather_heads(p["router"], mesh, p["router"].dim()
                                        - 1, count="expert_gathers"),
                 tau=copy_to_group(p["tau"], model))
    ys, auxs = zip(*(group(cfg, p, xg, mesh)
                     for xg in _group_tokens(cfg, x)))
    return torch.stack(ys).reshape(x.shape).to(x.dtype), \
        torch.stack(auxs).mean()
