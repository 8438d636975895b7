"""Decoder LM on the dense path: block roles, init, the training forward and
loss, bucketed prefill and the paged decode step.

Block parameters are stacked on a leading ``n_groups`` axis, as in the JAX
package's ``models/lm.py``; its ``lax.scan`` over groups becomes a Python
loop over groups that indexes each stacked leaf. The decode step updates the
preallocated page pool in place, the counterpart of the donated scan carry.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.utils.checkpoint

from . import attention as A
from . import ffn as F
from .modules import (ModelConfig, embed_apply, embed_init, head_apply,
                      head_init, rmsnorm_apply, rmsnorm_init)


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


def _dense_roles(cfg: ModelConfig):
    roles = block_roles(cfg)
    for r in roles:
        if r["mixer"] == "mamba" or r["ffn"] not in ("dense", None):
            raise NotImplementedError(
                f"{cfg.name}: block role {r} is not ported yet (the mamba and "
                "MoE families come in a later slice)")
    return roles


def index_tree(tree, i):
    """Slice every stacked leaf (tensor or PackedBool) of ``tree`` at ``i``."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def lm_init(cfg: ModelConfig, generator: torch.Generator):
    """Random params on ``generator``'s device, in the JAX package's tree:
    {"embed", "blocks": {"b{i}": stacked (n_groups, ...) leaves},
    "final_norm", "head"}."""
    dev = generator.device
    lead = (cfg.n_groups,)
    blocks = {}
    for i, role in enumerate(_dense_roles(cfg)):
        bp = {"norm1": rmsnorm_init(cfg.d_model, dev, lead),
              "attn": A.attention_init(generator, cfg, lead)}
        if role["ffn"] is not None:
            bp["norm2"] = rmsnorm_init(cfg.d_model, dev, lead)
            bp["ffn"] = F.ffn_init(generator, cfg, cfg.d_ff, lead)
        blocks[f"b{i}"] = bp
    return {"embed": embed_init(generator, cfg), "blocks": blocks,
            "final_norm": rmsnorm_init(cfg.d_model, dev),
            "head": head_init(generator, cfg)}


def cache_init(cfg: ModelConfig, batch: int, max_len: int, device):
    """Stacked (n_groups, batch, max_len, KVp, hd) K/V cache + pos scalar:
    the batch-1 prefill scratch of the serving session."""
    blocks = {f"b{i}": A.attention_cache_init(cfg, batch, max_len, device,
                                              lead=(cfg.n_groups,))
              for i, _ in enumerate(_dense_roles(cfg))}
    return {"blocks": blocks, "pos": 0}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _ffn_residual(cfg: ModelConfig, bp, role, x):
    if role["ffn"] is None:
        return x
    return x + F.ffn_apply(cfg, bp["ffn"], rmsnorm_apply(bp["norm2"], x))


def _apply_block_prefill(cfg: ModelConfig, bp, role, x, positions):
    """One block of cold prefill -> (x, cache entry {"k", "v"})."""
    B, S, _ = x.shape
    h = rmsnorm_apply(bp["norm1"], x)
    q, k, v = A._qkv(cfg, bp["attn"], h, positions)
    hp, kvp = cfg.heads_padded(), cfg.kv_heads_padded()
    out = A.flash_attention(
        q, A._repeat_kv(k, hp // kvp), A._repeat_kv(v, hp // kvp),
        causal=True,
        window=cfg.sliding_window if role["mixer"] == "attn_local" else 0,
        softcap_val=cfg.attn_logit_softcap, chunk=cfg.attn_chunk)
    out = A._head_mask(cfg, out)
    x = x + A._wo_project(cfg, bp["attn"]["wo"],
                          out.reshape(B, S, hp * cfg.head_dim_))
    return _ffn_residual(cfg, bp, role, x), A.kv_cache_entry(cfg, k, v)


def _apply_block_decode(cfg: ModelConfig, bp, role, bcache, x, pos,
                        block_table):
    h = rmsnorm_apply(bp["norm1"], x)
    mix, new_c = A.attention_decode_paged(
        cfg, bp["attn"], h, bcache, block_table, pos,
        local=(role["mixer"] == "attn_local"))
    return _ffn_residual(cfg, bp, role, x + mix), new_c


# ---------------------------------------------------------------------------
# Forward (train) and loss
# ---------------------------------------------------------------------------
def unbind_tree(tree, n: int):
    """Stacked (n, ...) leaves -> n per-group trees of views. Its backward
    stacks the groups' grads once (``torch.unbind``), where indexing each
    group would scatter into a zeroed full-size grad per group."""
    if isinstance(tree, dict):
        parts = {k: unbind_tree(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return torch.unbind(tree, 0)


def _apply_block(cfg: ModelConfig, bp, role, x, positions):
    h = rmsnorm_apply(bp["norm1"], x)
    x = x + A.attention_apply(cfg, bp["attn"], h, positions,
                              local=(role["mixer"] == "attn_local"))
    return _ffn_residual(cfg, bp, role, x)


def _apply_group(cfg: ModelConfig, roles, gp, x, positions):
    for i, role in enumerate(roles):
        x = _apply_block(cfg, gp[f"b{i}"], role, x, positions)
    return x


def lm_forward(cfg: ModelConfig, params, batch):
    """-> (logits fp32 (B, S, Vp), aux_loss scalar). With ``cfg.remat`` each
    group runs under ``torch.utils.checkpoint`` and is recomputed in the
    backward (the JAX package's ``jax.checkpoint`` of the scanned body)."""
    if cfg.frontend != "tokens":
        raise NotImplementedError("embedding frontends are not ported yet")
    tokens = batch["tokens"]
    h = embed_apply(cfg, params["embed"], tokens).to(cfg.dtype)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device) \
        .expand(B, S)
    roles = _dense_roles(cfg)
    for gp in unbind_tree(params["blocks"], cfg.n_groups):
        if cfg.remat:
            h = torch.utils.checkpoint.checkpoint(
                _apply_group, cfg, roles, gp, h, positions,
                use_reentrant=False)
        else:
            h = _apply_group(cfg, roles, gp, h, positions)
    h = rmsnorm_apply(params["final_norm"], h)
    logits = head_apply(cfg, params["head"], h)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def lm_loss(cfg: ModelConfig, params, batch):
    """Cross-entropy over the padded vocab with the padded slots masked,
    a max-shifted log-sum-exp, optional ``loss_mask`` weights, and
    ``+ 0.01 · aux``. -> (loss, {"nll", "aux"})."""
    logits, aux = lm_forward(cfg, params, batch)
    labels = batch["labels"].long()
    pad_mask = torch.arange(cfg.vocab_padded, device=logits.device) \
        < cfg.vocab_size
    logits = logits.masked_fill(~pad_mask, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - picked
    weights = batch.get("loss_mask")
    if weights is None:
        weights = torch.ones_like(labels, dtype=torch.float32)
    loss = (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------
def lm_prefill(cfg: ModelConfig, params, batch, cache=None,
               max_len: Optional[int] = None, length: Optional[int] = None):
    """Prefill over (B, S) ``batch["tokens"]`` -> (last-position logits
    (B, 1, Vp) fp32, cache with the prompt's K/V rows written at 0..S-1).

    ``length`` marks the true prompt length when the tokens are right-
    padded to a bucket: logits come from position ``length - 1``. Rows at
    and past ``length`` are causally invisible to the rows before it; the
    caller masks them out of the pool (``commit_prefill``).
    """
    if cfg.frontend != "tokens":
        raise NotImplementedError("embedding frontends are not ported yet")
    tokens = batch["tokens"]
    h = embed_apply(cfg, params["embed"], tokens).to(cfg.dtype)
    B, S = tokens.shape
    if cache is None:
        cache = cache_init(cfg, B, max_len or S, h.device)
    positions = torch.arange(S, dtype=torch.int32, device=h.device) \
        .expand(B, S)
    roles = _dense_roles(cfg)
    for g in range(cfg.n_groups):
        gp = index_tree(params["blocks"], g)
        for i, role in enumerate(roles):
            h, c = _apply_block_prefill(cfg, gp[f"b{i}"], role, h, positions)
            for name, rows in c.items():
                cache["blocks"][f"b{i}"][name][g, :, :S] = rows
    h = rmsnorm_apply(params["final_norm"], h)
    last = S if length is None else int(length)
    logits = head_apply(cfg, params["head"], h[:, last - 1:last])
    return logits, {"blocks": cache["blocks"], "pos": last}


def lm_decode_step(cfg: ModelConfig, params, cache, tokens):
    """One-token decode over a block-table paged cache -> (logits (L, 1,
    Vp) fp32, cache). cache: {"blocks": the page pool (updated in place),
    "block_table": (L, C) int32, "pos": (L,) int32}; tokens (L, 1).
    Contiguous (non-paged) caches are not ported yet."""
    block_table = cache.get("block_table")
    if block_table is None:
        raise NotImplementedError("contiguous-cache decode is not ported yet; "
                                  "pass a paged cache with a block_table")
    pos = cache["pos"]
    h = embed_apply(cfg, params["embed"], tokens).to(cfg.dtype)
    roles = _dense_roles(cfg)
    for g in range(cfg.n_groups):
        gp = index_tree(params["blocks"], g)
        for i, role in enumerate(roles):
            gcache = index_tree(cache["blocks"][f"b{i}"], g)
            h, _ = _apply_block_decode(cfg, gp[f"b{i}"], role, gcache, h, pos,
                                       block_table)
    h = rmsnorm_apply(params["final_norm"], h)
    logits = head_apply(cfg, params["head"], h)
    return logits, {"blocks": cache["blocks"], "block_table": block_table,
                    "pos": pos + 1}


def lm_decode_step_paged(cfg: ModelConfig, params, cache, tokens):
    """One decode step over L scheduler lanes with a block-table paged
    cache. Every lane sits at its own position; the lane count L is the
    stable batch shape — admission and eviction only rewrite the block
    table and the pos vector."""
    return lm_decode_step(cfg, params, cache, tokens)
