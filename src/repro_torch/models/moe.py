"""Mixture-of-Experts with Boolean expert weights (moonshot, arctic, jamba).

Router: FP dense + softmax + top-k with renormalised gates and the
Switch/GShard load-balancing loss. Expert FFNs are gated MLPs with Boolean
int8 weights stacked (E, D, F). Two dispatches, as in the JAX package's
``models/moe.py``, both with a static capacity C per expert a routing
group, positions in each expert from a cumulative sum:

* ``einsum``  — GShard dispatch, whose (T, E, C) one-hot products the
  JAX package builds; the port computes their function by index (tokens
  scattered into (E, C + 1, D) buffers, slot C swallowing the overflow,
  and gathered back), so no (T, E, C) tensor lives on a rank, and
  combines in fp32;
* ``scatter`` — the same buffers, the combine in x's dtype.

The expert products are plain torch on the ±1 views summed in fp32; the
JAX package leaves them to XLA too (no Pallas kernel).

Under a training mesh's "model" split (``modules.model_mesh``) the
experts split, as the JAX package's specs place them (its EP layout):
the router's columns are gathered first (small), so the routing is the
unsharded routing; each rank builds the same dispatch, runs its E / tp
experts on their rows, and the expert outputs are gathered over "model"
before the combine, which then sums in the unsharded order. The grads of
the dispatched tokens and of the replicated ``tau`` are summed over
"model" (each rank's experts see part of them). The prefill splits alike,
its routing groups the rank's rows; a decode's one routing group spans
the batch ranks (``route``): each rank gathers every rank's expert
choices, so the capacity and the arrival order are the whole group's,
and dispatches its own tokens at their places in the group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import boolean_activation, random_boolean
from repro_torch.distributed import gather_heads, get_mesh

from .modules import ModelConfig, copy_to_group, fp_weight, model_mesh


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


def _slots(cfg: ModelConfig, experts, route=()):
    """-> (each (token, choice)'s arrival position in its expert, (T, k)
    int64; the capacity C). ``route``: the routing group spans the ranks
    of those mesh axes, each holding the next T tokens in rank order: the
    expert choices of every rank are gathered (one all-gather of (T, k)
    ints), the positions counted over the whole group and this rank's
    taken, C the whole group's."""
    T, k = experts.shape
    E = cfg.n_experts
    every, lo = experts, 0
    if route:
        mesh = get_mesh()
        if mesh.size_of(route) > 1:
            every = mesh.all_gather(experts.contiguous(), route, 0,
                                    count="route_gathers")
            lo = mesh.index(route) * T
    pos = _arrival(F.one_hot(every, E).reshape(-1, E)).reshape(-1, k)
    return pos[lo:lo + T], _capacity(cfg, every.shape[0])


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


def _moe_group(cfg: ModelConfig, p, xf, mesh=None, route=()):
    """One routing group's tokens xf (T, D) through the MoE -> (y (T, D),
    aux loss). The dispatch and the combine go by index: slot (e, c) of
    the (E, C, D) buffer holds the token that arrived c-th at expert e
    (zeros where none did), an arrival past C lands in a scratch slot C
    and is dropped, and each token sums its k experts' outputs at its
    gates. ``einsum`` is GShard's dispatch (the JAX package's one-hot (T,
    E, C) products), computed so: the same slots and drops, its combine
    in fp32; the (T, E, C) tensors are never built. ``scatter`` combines
    in x's dtype by ``index_add_``, as the JAX package's does."""
    T, D = xf.shape
    gates, experts, aux = _route(cfg, p, xf)
    E, k = cfg.n_experts, cfg.top_k
    pos, C = _slots(cfg, experts, route)
    pos = pos.reshape(T * k)
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
    w = gates.reshape(T * k) * keep
    if cfg.moe_impl == "scatter":
        y = torch.zeros((T, D), dtype=xf.dtype, device=xf.device) \
            .index_add_(0, tok_idx, got * w.to(xf.dtype)[:, None])
    else:
        y = (got.to(torch.float32) * w[:, None]).reshape(T, k, D).sum(1)
    return y, aux


def moe_apply(cfg: ModelConfig, p, x, route=()):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, mean aux loss over the
    routing groups). ``route``: the mesh axes whose ranks hold the parts
    of one routing group (``_slots``); ``x`` is then one group."""
    mesh = model_mesh(cfg)
    if mesh is not None:
        model = mesh.group("model")
        p = dict(p, router=gather_heads(p["router"], mesh, p["router"].dim()
                                        - 1, count="expert_gathers"),
                 tau=copy_to_group(p["tau"], model))
    if route and cfg.moe_groups != 1:
        raise ValueError("a routing group that spans ranks is the rank's "
                         f"one group, not {cfg.moe_groups}")
    ys, auxs = zip(*(_moe_group(cfg, p, xg, mesh, route)
                     for xg in _group_tokens(cfg, x)))
    return torch.stack(ys).reshape(x.shape).to(x.dtype), \
        torch.stack(auxs).mean()
