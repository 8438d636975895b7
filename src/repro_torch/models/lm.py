"""Decoder LM of every family: block roles, init, the training forward and
loss, bucketed prefill (cold, or the tail of a prefix-cache hit) and the
decode step over a contiguous or a block-table paged cache.

Block parameters are stacked on a leading ``n_groups`` axis, as in the JAX
package's ``models/lm.py``; its ``lax.scan`` over groups becomes a Python
loop over groups that indexes each stacked leaf. A group holds
``group_size`` blocks with static roles (gemma2's local/global pairs,
jamba's 1:7 mamba:attention groups with MoE on odd indices). The decode
step updates the preallocated page pool and the lane-indexed SSM state in
place, the counterpart of the donated scan carry.

On a training mesh the prefill and decode steps run one rank's part of
the JAX package's placement (``lm_prefill`` / ``lm_decode_step
(shardings=)``): its rows of the batch, its FSDP slices gathered a layer
group at a time (no grad), its "model" slices of the heads, d_ff,
d_inner, the experts and the vocab, its slab of the cache rows over
``cfg.cache_seq_axes`` and its d_inner channels of the SSM state; the
logits leave whole over the vocab.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from repro_torch.core import PackedBool
from repro_torch.core.optimizer import tree_leaves, tree_unflatten
from repro_torch.distributed import (fsdp_gather, get_mesh,
                                     reduce_from_group)
from repro_torch.kernels import flash_attention_fwd

from . import attention as A
from . import ffn as F
from . import mamba as M
from . import moe as MOE
from .modules import (ModelConfig, embed_apply, embed_init, head_apply,
                      head_init, model_mesh, rmsnorm_apply, rmsnorm_init)


# ---------------------------------------------------------------------------
# Block roles
# ---------------------------------------------------------------------------
def block_roles(cfg: ModelConfig) -> List[Dict[str, Optional[str]]]:
    """Static per-in-group-index roles: mixer in {attn, attn_local, mamba},
    ffn in {dense, moe, moe+dense, None}."""
    if cfg.family == "ssm":
        return [{"mixer": "mamba", "ffn": None}]
    if cfg.family == "hybrid":
        roles = []
        for i in range(cfg.group_size):
            mixer = "attn" if i == cfg.attn_index else "mamba"
            ffn = "moe" if (i % 2 == 1 and cfg.n_experts > 0) else "dense"
            roles.append({"mixer": mixer, "ffn": ffn})
        return roles
    if cfg.alt_local_global:
        return [{"mixer": "attn_local", "ffn": "dense"},
                {"mixer": "attn", "ffn": "dense"}]
    if cfg.n_experts > 0:
        ffn = "moe+dense" if cfg.moe_dense_residual else "moe"
        return [{"mixer": "attn", "ffn": ffn}]
    return [{"mixer": "attn", "ffn": "dense"}]


def index_tree(tree, i):
    """Slice every stacked leaf (tensor or PackedBool) of ``tree`` at ``i``."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _block_init(gen: torch.Generator, cfg: ModelConfig, role, lead):
    dev = gen.device
    bp = {"norm1": rmsnorm_init(cfg.d_model, dev, lead)}
    if role["mixer"] == "mamba":
        bp["mamba"] = M.mamba_init(gen, cfg, lead)
    else:
        bp["attn"] = A.attention_init(gen, cfg, lead)
    if role["ffn"] is not None:
        bp["norm2"] = rmsnorm_init(cfg.d_model, dev, lead)
        if "moe" in role["ffn"]:
            bp["moe"] = MOE.moe_init(gen, cfg, 0, lead)
        if "dense" in role["ffn"]:
            bp["ffn"] = F.ffn_init(gen, cfg, cfg.dense_ff_ if role["ffn"]
                                   != "dense" else cfg.d_ff, lead)
    return bp


def lm_init(cfg: ModelConfig, generator: torch.Generator):
    """Random params on ``generator``'s device, in the JAX package's tree:
    {"embed", "blocks": {"b{i}": stacked (n_groups, ...) leaves},
    "final_norm", "head"}."""
    lead = (cfg.n_groups,)
    blocks = {f"b{i}": _block_init(generator, cfg, role, lead)
              for i, role in enumerate(block_roles(cfg))}
    return {"embed": embed_init(generator, cfg), "blocks": blocks,
            "final_norm": rmsnorm_init(cfg.d_model, generator.device),
            "head": head_init(generator, cfg)}


def cache_init(cfg: ModelConfig, batch: int, max_len: int, device):
    """Stacked (n_groups, batch, ...) caches + pos scalar: K/V rows
    (n_groups, batch, max_len, KVp, hd) for attention blocks, the O(1)
    state {"h", "conv"} for mamba blocks. The batch-1 prefill scratch of
    the serving session, or ``generate``'s contiguous cache. On a mesh
    that splits the model (``model_mesh``) ``batch`` and ``max_len`` are
    this rank's rows and its slab's rows, and the mamba state holds its
    d_inner channels: its slice of the whole cache under
    ``launch.shardings.cache_specs``."""
    lead = (cfg.n_groups,)
    blocks = {f"b{i}": (M.mamba_cache_init(cfg, batch, device, lead)
                        if role["mixer"] == "mamba" else
                        A.attention_cache_init(cfg, batch, max_len, device,
                                               lead=lead))
              for i, role in enumerate(block_roles(cfg))}
    return {"blocks": blocks, "pos": 0}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _ffn_branch(cfg: ModelConfig, bp, role, x, route=()):
    """The block's FFN branch (MoE, dense or both) on ``x`` -> (its output,
    MoE aux loss); (None, 0) for a block without one. ``route``: the mesh
    axes the MoE's one routing group spans (``moe.moe_apply``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if role["ffn"] is None:
        return None, aux
    h = rmsnorm_apply(bp["norm2"], x)
    out = None
    if "moe" in role["ffn"]:
        out, aux = MOE.moe_apply(cfg, bp["moe"], h, route)
    if "dense" in role["ffn"]:
        d = F.ffn_apply(cfg, bp["ffn"], h)
        out = d if out is None else out + d
    return out, aux


def _ffn_residual(cfg: ModelConfig, bp, role, x, route=()):
    """x + the block's FFN (MoE, dense or both) -> (x, MoE aux loss)."""
    out, aux = _ffn_branch(cfg, bp, role, x, route)
    return (x if out is None else x + out), aux


def _apply_block_prefill(cfg: ModelConfig, bp, role, x, positions,
                         length=None, offset: int = 0, prefix_len=None,
                         prefix_pages=None, prefix_ids=None, ssm_init=None,
                         state_at=None, mesh=None, rows=None):
    """One block of (possibly tail-) prefill -> (x, cache entry, snap).

    ``mesh``: the "model" split of a sharded cold prefill; the attention
    block's entry is then this rank's slab of a cache of ``rows`` rows
    (``attention.attention_prefill_mesh``), a mamba block's state its
    d_inner channels.

    Attention, cold (``prefix_pages`` None): the flash-prefill kernel over
    the block's own rows, the q rows (batch, head) reading KV head
    ``h // n_rep`` in place of a repeated copy. Tail: ``prefix_pages`` (the
    block's pool leaves) and ``prefix_ids`` (the prefix's physical pages) —
    the queries at ``offset + i`` attend over the prefix read in place from
    the pool and the tail's own rows (``paged_prefix_attention``).

    Mamba: the recurrence resumes from ``ssm_init`` ({"h", "conv"}, the
    prefix-boundary state) when given; ``snap`` is its page-boundary state
    snapshots at ``state_at`` (None otherwise and for attention blocks).
    """
    B, S, _ = x.shape
    h = rmsnorm_apply(bp["norm1"], x)
    snap = None
    if role["mixer"] == "mamba":
        h0 = conv0 = None
        if ssm_init is not None:
            h0, conv0 = ssm_init["h"], ssm_init["conv"]
        mix, (h_last, conv_state), *snaps = M.mamba_apply(
            cfg, bp["mamba"], h, h0=h0, conv0=conv0, return_state=True,
            length=length, state_at=state_at)
        if snaps:
            snap = snaps[0]
        entry = {"h": h_last, "conv": conv_state.to(torch.float32)}
        x, _ = _ffn_residual(cfg, bp, role, x + mix)
        return x, entry, snap
    local = role["mixer"] == "attn_local"
    if mesh is not None:
        mix, entry = A.attention_prefill_mesh(cfg, bp["attn"], h, positions,
                                              mesh, rows, local=local)
        x, _ = _ffn_residual(cfg, bp, role, x + mix)
        return x, entry, snap
    q, k, v = A._qkv(cfg, bp["attn"], h, positions)
    hp, hd = A._tp_heads(cfg)[0], cfg.head_dim_
    if prefix_pages is not None:
        out = A.flash_prefix_attention_paged(
            cfg, prefix_pages, prefix_ids, q, k, v, offset, prefix_len, length,
            local=local)
    else:
        def rows(t):                    # (B, S, heads, hd) -> (B*heads, S, hd)
            return t.transpose(1, 2).reshape(-1, S, hd).contiguous()

        out = flash_attention_fwd(
            rows(q), rows(k), rows(v), causal=True,
            window=cfg.sliding_window if local else 0,
            softcap=cfg.attn_logit_softcap, n_rep=A._group(cfg))
        out = out.reshape(B, hp, S, hd).transpose(1, 2)
    out = A._head_mask(cfg, out)
    x = x + A._wo_project(cfg, bp["attn"]["wo"], out.reshape(B, S, hp * hd))
    x, _ = _ffn_residual(cfg, bp, role, x)
    return x, A.kv_cache_entry(cfg, k, v), snap


def _apply_block_decode(cfg: ModelConfig, bp, role, bcache, x, pos,
                        block_table, route=()):
    """One block of a decode step; ``bcache`` (the group's views of the
    cache) is updated in place."""
    h = rmsnorm_apply(bp["norm1"], x)
    local = role["mixer"] == "attn_local"
    if role["mixer"] == "mamba":
        # O(1) state, lane-indexed directly, never paged
        mix, new_c = M.mamba_decode(cfg, bp["mamba"], h, bcache)
        for name, leaf in bcache.items():
            leaf.copy_(new_c[name])
    elif block_table is None:
        mix, _ = A.attention_decode(cfg, bp["attn"], h, bcache, pos,
                                    local=local)
    else:
        mix, _ = A.attention_decode_paged(cfg, bp["attn"], h, bcache,
                                          block_table, pos, local=local)
    return _ffn_residual(cfg, bp, role, x + mix, route)[0]


# ---------------------------------------------------------------------------
# Forward (train) and loss
# ---------------------------------------------------------------------------
def unbind_tree(tree, n: int):
    """Stacked (n, ...) leaves -> n per-group trees of views. Its backward
    stacks the groups' grads once (``torch.unbind``), where indexing each
    group would scatter into a zeroed full-size grad per group. Packed
    serving leaves (``PackedBool``, no grad) are indexed."""
    if isinstance(tree, dict):
        parts = {k: unbind_tree(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    if isinstance(tree, PackedBool):
        return [tree[g] for g in range(n)]
    return torch.unbind(tree, 0)


def _mixer_branch(cfg: ModelConfig, bp, role, x, positions):
    """The block's mixer branch (attention or mamba) on ``x``."""
    h = rmsnorm_apply(bp["norm1"], x)
    if role["mixer"] == "mamba":
        return M.mamba_apply(cfg, bp["mamba"], h)
    return A.attention_apply(cfg, bp["attn"], h, positions,
                             local=(role["mixer"] == "attn_local"))


def _saved(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under ``remat_policy="save_block_outs"`` recomputed in
    the backward from its inputs, so what the backward keeps of a block is
    its residual branches' inputs and outputs (the JAX package saves the
    two outputs it names ``blk_out`` and recomputes the rest)."""
    if cfg.remat and cfg.remat_policy == "save_block_outs":
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _apply_block(cfg: ModelConfig, bp, role, x, positions):
    """One block of the training forward -> (x, MoE aux loss)."""
    x = x + _saved(cfg, _mixer_branch, cfg, bp, role, x, positions)
    out, aux = _saved(cfg, _ffn_branch, cfg, bp, role, x)
    return (x if out is None else x + out), aux


class _Fsdp:
    """The FSDP gathers of one training forward: ``shardings`` is the
    params' placement tree (``distributed.placement.named``); a leaf cut
    over "data" into more than one slice is gathered at ``dtype`` before
    use, its grad reduce-scattered at ``grad_dtype``. ``of(tree, where)``
    -> ``tree`` (a dict of leaves) with those leaves whole over "data":
    one flat gather (``distributed.fsdp_gather``); ``where`` is the
    placement subtree and ``lead`` the leading axes ``tree``'s leaves
    have dropped (1 for a group's slice of the stacked blocks)."""

    def __init__(self, mesh, shardings, dtype, grad_dtype):
        self.mesh, self.dtype, self.grad_dtype = mesh, dtype, grad_dtype
        self.shardings = shardings

    def of(self, tree, where, lead: int = 0):
        leaves = tree_leaves(tree)
        dims = [sh.dim("data") - lead if sh.fsdp() else -1
                for sh in tree_leaves(where)]
        cut = [i for i, d in enumerate(dims) if d >= 0]
        fulls = fsdp_gather(self.mesh, [leaves[i] for i in cut],
                            [dims[i] for i in cut], self.dtype,
                            self.grad_dtype)
        for i, f in zip(cut, fulls):
            leaves[i] = f
        return tree_unflatten(tree, leaves)


def _fsdp_of(cfg: ModelConfig, shardings, grad_dtype=torch.float32):
    """The forward's ``_Fsdp`` for ``shardings`` (None when no leaf is cut
    over "data" into more than one slice). ``grad_dtype=None``: a serving
    step's, which gathers each leaf at its own dtype (int8 Boolean
    weights as int8) and differentiates nothing."""
    if shardings is None:
        return None
    placed = tree_leaves(shardings)
    if not any(sh.fsdp() for sh in placed):
        return None
    return _Fsdp(placed[0].mesh, shardings,
                 None if grad_dtype is None else cfg.dtype, grad_dtype)


def _serve_split(cfg: ModelConfig, shardings):
    """A prefill or decode step's part of the placement -> (its config:
    ``moe_groups`` this rank's routing groups, the "model" split
    (``model_mesh``), its FSDP gathers (``_Fsdp``), the batch axes one
    routing group spans (a decode's one group over every batch rank:
    ``moe.moe_apply``) or ()). ``cfg.moe_groups`` counts the GLOBAL
    batch's routing groups, as the policy sets it."""
    mesh = model_mesh(cfg)
    if shardings is None:
        if mesh is not None:
            raise ValueError("a mesh splits the model over 'model': the "
                             "params must be placed (launch.shardings."
                             "train_param_specs) and their placement given")
        return cfg, None, None, ()
    placed_on = tree_leaves(shardings)[0].mesh
    dp = placed_on.size_of(cfg.batch_axes) if cfg.batch_axes else 1
    route = ()
    if cfg.n_experts and dp > 1:
        if cfg.moe_groups % dp == 0:
            cfg = cfg.scaled(moe_groups=cfg.moe_groups // dp)
        elif cfg.moe_groups == 1:
            route = tuple(cfg.batch_axes)
        else:
            raise ValueError(f"moe_groups={cfg.moe_groups} routing groups "
                             f"neither split over nor span {dp} batch "
                             "shards")
    return cfg, mesh, _fsdp_of(cfg, shardings, grad_dtype=None), route


def _logits(cfg: ModelConfig, params, h, mesh, fsdp):
    """The fp32 logits of ``h`` with the final norm applied by the caller:
    under a "model" split this rank's vocab columns, gathered over "model"
    to the whole vocab (the JAX package's logits leave the step whole)."""
    head = params["head"]
    if fsdp is not None:
        head = fsdp.of(head, fsdp.shardings["head"])
    logits = head_apply(cfg, head, h, mesh)
    if mesh is not None:
        logits = mesh.all_gather(logits, "model", logits.dim() - 1,
                                 count="vocab_gathers")
    return logits


def _apply_group(cfg: ModelConfig, roles, gp, x, positions, fsdp=None):
    """One group's blocks. Under FSDP (``fsdp``, an ``_Fsdp``) the group's
    weight slices are gathered first: inside the group's remat, they are
    freed after its forward and gathered again in its recompute, as the
    JAX package's scan does. ``block_grad_barriers`` changes nothing here:
    the JAX package's barrier between the blocks orders XLA's scheduling of
    their grad reductions, and eager autograd runs them as it reaches
    them."""
    if fsdp is not None:
        gp = fsdp.of(gp, fsdp.shardings["blocks"], lead=1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, role in enumerate(roles):
        x, a = _apply_block(cfg, gp[f"b{i}"], role, x, positions)
        aux = aux + a
    return x, aux


def _inputs_to_h(cfg: ModelConfig, params, batch, mesh=None, fsdp=None):
    """The first block's input: the scaled token embeddings (vocab-parallel
    over ``mesh``'s "model" axis, the table gathered over "data" under
    ``fsdp``), or with an embeddings frontend (the audio/vlm stub)
    ``batch["embeddings"]`` (B, S, d_model) as given."""
    if cfg.frontend == "embeddings":
        return batch["embeddings"].to(cfg.dtype)
    embed = params["embed"]
    if fsdp is not None:
        embed = fsdp.of(embed, fsdp.shardings["embed"])
    return embed_apply(cfg, embed, batch["tokens"], mesh).to(cfg.dtype)


def lm_forward(cfg: ModelConfig, params, batch, shardings=None,
               grad_dtype=torch.float32):
    """-> (logits fp32 (B, S, Vp), aux loss: the MoE blocks' load-balancing
    losses summed). With ``cfg.remat`` each group runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward (the JAX
    package's ``jax.checkpoint`` of the scanned body); under
    ``remat_policy="save_block_outs"`` each residual branch is instead
    (``_saved``).

    On a training mesh ``params`` are this rank's slices and ``shardings``
    their placement tree (``make_train_step(grad_shardings=)``): the
    weights cut over "data" are gathered per use (``_Fsdp``; their grads
    reduce-scattered at ``grad_dtype``), and under a "model" split
    (``model_mesh``) the logits are this rank's vocab columns,
    (B, S, Vp / tp)."""
    mesh = model_mesh(cfg)
    if mesh is not None and shardings is None:
        raise ValueError("a training mesh splits the model over 'model': "
                         "the params must be placed (launch.shardings."
                         "train_param_specs) and their placement given")
    fsdp = _fsdp_of(cfg, shardings, grad_dtype)
    h = _inputs_to_h(cfg, params, batch, mesh, fsdp)
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=h.device) \
        .expand(B, S)
    roles = block_roles(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for gp in unbind_tree(params["blocks"], cfg.n_groups):
        if cfg.remat and cfg.remat_policy != "save_block_outs":
            h, a = torch.utils.checkpoint.checkpoint(
                _apply_group, cfg, roles, gp, h, positions, fsdp,
                use_reentrant=False)
        else:
            h, a = _apply_group(cfg, roles, gp, h, positions, fsdp)
        aux = aux + a
    h = rmsnorm_apply(params["final_norm"], h)
    head = params["head"]
    if fsdp is not None:
        head = fsdp.of(head, fsdp.shardings["head"])
    return head_apply(cfg, head, h, mesh), aux


def _vocab_nll(cfg: ModelConfig, logits, labels, mesh=None):
    """The token NLLs from this "model" rank's vocab columns of the logits
    (rank r the columns [r·V, (r+1)·V)), never gathered: the padded slots
    masked by global id, the max over "model" (exact), the sum of
    exponentials over "model" (reassociated), the picked logit from the
    rank that owns the label, summed (exact: one term is non-zero). With
    no mesh the logits are the whole vocab and nothing is reduced."""
    vl = logits.shape[-1]
    lo = 0 if mesh is None else mesh.coords["model"] * vl
    ids = lo + torch.arange(vl, device=logits.device)
    logits = logits.masked_fill(~(ids < cfg.vocab_size), -1e30)
    # the shift cancels in the log-sum-exp: no grad flows through it
    m = logits.detach().amax(dim=-1, keepdim=True)
    if mesh is not None:
        mesh.all_reduce(m, "model", op=dist.ReduceOp.MAX,
                        count="vocab_reduces")
    se = torch.exp(logits - m).sum(dim=-1)
    idx = labels - lo
    mine = (idx >= 0) & (idx < vl)
    picked = torch.gather(logits, -1, idx.clamp(0, vl - 1)[..., None])[..., 0]
    picked = torch.where(mine, picked, torch.zeros(
        (), dtype=picked.dtype, device=picked.device))
    if mesh is not None:
        se = reduce_from_group(se, mesh, count="vocab_reduces")
        picked = reduce_from_group(picked, mesh, count="vocab_reduces")
    return torch.log(se) + m[..., 0] - picked


def lm_loss(cfg: ModelConfig, params, batch, shardings=None,
            grad_dtype=torch.float32):
    """Cross-entropy over the padded vocab with the padded slots masked,
    a max-shifted log-sum-exp, optional ``loss_mask`` weights, and
    ``+ 0.01 · aux``. -> (loss, {"nll", "aux"}). ``shardings`` and
    ``grad_dtype``: ``lm_forward``'s; under a "model" split the vocab
    stays split through the softmax (``_vocab_nll``), as the JAX package
    keeps it: the (B, S, Vp) logits are never gathered."""
    logits, aux = lm_forward(cfg, params, batch, shardings, grad_dtype)
    labels = batch["labels"].long()
    nll = _vocab_nll(cfg, logits, labels, model_mesh(cfg))
    weights = batch.get("loss_mask")
    if weights is None:
        weights = torch.ones_like(labels, dtype=torch.float32)
    loss = (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------
def lm_prefill(cfg: ModelConfig, params, batch, cache=None,
               max_len: Optional[int] = None, length: Optional[int] = None,
               offset: Optional[int] = None, prefix=None,
               prefix_len: Optional[int] = None, prefix_pages=None,
               prefix_ids=None, ssm_init=None, state_at=None,
               shardings=None):
    """Prefill over (B, S) inputs (``batch["tokens"]``, or
    ``batch["embeddings"]`` with an embeddings frontend) -> (last-position
    logits (B, 1, Vp) fp32, cache with the prompt's K/V rows written at
    0..S-1 and each mamba block's end state).

    ``length`` marks the true prompt length when the inputs are right-
    padded to a bucket: logits come from position ``length - 1``, and the
    SSM recurrence freezes at and past it, so its state is the state after
    the true prompt. Attention rows at and past ``length`` are causally
    invisible to the rows before it; the caller masks them out of the pool
    (``commit_prefill``).

    Prefix-cache TAIL prefill: the inputs are the uncached tail of a prompt
    whose first ``offset`` tokens already live in pool pages. ``offset``
    shifts the positions (RoPE is absolute); ``prefix_pages`` ({"b{i}": an
    attention block's pool leaves, stacked (n_groups, ...)}) and
    ``prefix_ids`` ((npp,) int32 physical pages on the pool's device, rows
    valid below ``prefix_len``) let the tail's queries attend over the
    cached rows read in place; ``ssm_init`` ({"b{i}": {"h", "conv"}},
    leading n_groups) resumes each mamba recurrence from the prefix-
    boundary state. ``state_at`` (positions, tail-relative) also returns
    the mamba snapshots there as a third result {"b{i}": {"h": (n_groups,
    B, len, DI, N), "conv": ...}}: the page-boundary states a finished
    request donates to the prefix index. All None is exactly the cold
    prefill. The JAX package's gathered ``prefix=`` route (its gather
    fallback) is the plain version of ``paged_prefix_attention`` here.

    On a training mesh ``params`` are this rank's slices, ``shardings``
    their placement (``distributed.placement.named(mesh,
    launch.shardings.train_param_specs(...))``) and ``batch`` this rank's
    rows: each layer group's FSDP slices are gathered over "data" (one
    flat gather, no grad), the model runs on its "model" slices, the
    cache holds its slab of ``max_len`` (default S) rows over
    ``cfg.cache_seq_axes`` (``cache_init`` at the slab's rows) and its
    d_inner channels of each mamba state, and the logits are gathered
    over "model" to the whole vocab. A sharded prefill is the cold one
    (no prefix, ``offset`` or ``state_at``).
    """
    if prefix is not None:
        raise NotImplementedError(
            "the gathered prefix= route is the plain version of "
            "paged_prefix_attention in the port; pass prefix_pages= and "
            "prefix_ids=")
    tail = prefix_pages is not None
    if tail and (prefix_ids is None or prefix_len is None or offset is None):
        raise ValueError("a tail prefill needs offset, prefix_len, "
                         "prefix_pages and prefix_ids")
    cfg, mesh, fsdp, _ = _serve_split(cfg, shardings)
    if shardings is not None and (tail or offset or ssm_init is not None
                                  or state_at is not None):
        raise NotImplementedError("a sharded prefill is the cold prefill")
    h = _inputs_to_h(cfg, params, batch, mesh, fsdp)
    B, S = h.shape[:2]
    rows = max_len or S
    seq = cfg.use_sharding_constraints and bool(cfg.cache_seq_axes)
    if cache is None:
        n = get_mesh().size_of(cfg.cache_seq_axes) if seq else 1
        if rows % n:
            raise ValueError(f"{rows} cache rows do not split over {n} "
                             "slabs")
        cache = cache_init(cfg, B, rows // n, h.device)
    off = 0 if offset is None else int(offset)
    positions = (torch.arange(S, dtype=torch.int32, device=h.device) + off) \
        .expand(B, S)
    roles = block_roles(cfg)
    snaps: Dict[str, Dict[str, list]] = {}
    for g in range(cfg.n_groups):
        gp = index_tree(params["blocks"], g)
        if fsdp is not None:
            gp = fsdp.of(gp, fsdp.shardings["blocks"], lead=1)
        for i, role in enumerate(roles):
            bi = f"b{i}"
            pages = None
            if tail and bi in prefix_pages:
                pages = index_tree(prefix_pages[bi], g)
            init = None
            if ssm_init is not None and bi in ssm_init:
                init = index_tree(ssm_init[bi], g)
            h, c, snap = _apply_block_prefill(
                cfg, gp[bi], role, h, positions, length=length, offset=off,
                prefix_len=prefix_len, prefix_pages=pages,
                prefix_ids=prefix_ids, ssm_init=init, state_at=state_at,
                mesh=mesh, rows=rows)
            if seq and mesh is None and role["mixer"] != "mamba":
                # every head on this rank: its slab of the rows
                c = A.cache_slab(cfg, c, rows)
            for name, t in c.items():
                if role["mixer"] == "mamba":
                    cache["blocks"][bi][name][g] = t
                else:
                    cache["blocks"][bi][name][g, :, :t.shape[1]] = t
            if snap is not None:
                for name, t in snap.items():
                    snaps.setdefault(bi, {}).setdefault(name, []).append(t)
    h = rmsnorm_apply(params["final_norm"], h)
    last = S if length is None else int(length)
    logits = _logits(cfg, params, h[:, last - 1:last], mesh, fsdp)
    new_cache = {"blocks": cache["blocks"], "pos": last + off}
    if state_at is not None:
        return logits, new_cache, {
            bi: {name: torch.stack(ts) for name, ts in leaves.items()}
            for bi, leaves in snaps.items()}
    return logits, new_cache


def lm_decode_step(cfg: ModelConfig, params, cache, tokens,
                   shardings=None):
    """One-token decode -> (logits (B, 1, Vp) fp32, cache), the cache
    updated in place. A contiguous cache (``cache_init``, after
    ``lm_prefill``) is {"blocks", "pos": int}, every row at position pos; a
    paged one (``lm_decode_step_paged``) is {"blocks": the page pool,
    "block_table": (L, C) int32, "pos": (L,) int32}. tokens (B, 1).

    On a training mesh (``shardings``: the params' placement, as in
    ``lm_prefill``) ``tokens`` and the contiguous cache are this rank's
    rows, the cache its slab of the rows over ``cfg.cache_seq_axes`` and
    its d_inner channels of each mamba state; each layer group's FSDP
    slices are gathered over "data" (no grad), q (and split k/v) gathered
    over "model" before the slab's read (``attention.attention_decode``),
    and the logits gathered over "model" to the whole vocab. A decode's
    one routing group (``cfg.moe_groups`` 1) spans the batch ranks: the
    tokens' expert choices are gathered over them (``moe.moe_apply``)."""
    block_table = cache.get("block_table")
    pos = cache["pos"]
    cfg, mesh, fsdp, route = _serve_split(cfg, shardings)
    if shardings is not None and block_table is not None:
        raise NotImplementedError("a sharded decode reads a contiguous "
                                  "cache")
    embed = params["embed"]
    if fsdp is not None:
        embed = fsdp.of(embed, fsdp.shardings["embed"])
    h = embed_apply(cfg, embed, tokens, mesh).to(cfg.dtype)
    roles = block_roles(cfg)
    for g in range(cfg.n_groups):
        gp = index_tree(params["blocks"], g)
        if fsdp is not None:
            gp = fsdp.of(gp, fsdp.shardings["blocks"], lead=1)
        for i, role in enumerate(roles):
            gcache = index_tree(cache["blocks"][f"b{i}"], g)
            h = _apply_block_decode(cfg, gp[f"b{i}"], role, gcache, h, pos,
                                    block_table, route)
    h = rmsnorm_apply(params["final_norm"], h)
    logits = _logits(cfg, params, h, mesh, fsdp)
    new_cache = {"blocks": cache["blocks"], "pos": pos + 1}
    if block_table is not None:
        new_cache["block_table"] = block_table
    return logits, new_cache


def lm_decode_step_paged(cfg: ModelConfig, params, cache, tokens):
    """One decode step over L scheduler lanes with a block-table paged
    cache. Every lane sits at its own position (attention reads and writes
    go through the block table, mamba state is lane-indexed); the lane
    count L is the stable batch shape — admission and eviction only
    rewrite the block table and the pos vector."""
    return lm_decode_step(cfg, params, cache, tokens)
