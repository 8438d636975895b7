"""Analytic per-cell FLOPs / HBM-bytes accounting (per device, per step):
the JAX package's ``launch/flops_model.py``, its formulas unchanged.

The dry run counts the collectives it traces (``hlo_analysis``), not the
FLOPs: the roofline's compute and memory terms come from these
transparent formulas, validated against ``torch.utils.flop_counter`` on
loop-free calibration configs (``dryrun --calibrate``).

Conventions:
  FLOPs: matmul (m,k)x(k,n) = 2·m·k·n. Train pass factor over forward:
  fwd(1) + bwd(2) + remat-recompute(1) = 4 for scanned blocks, 3 for the
  unrematted head/loss. Waste terms are counted honestly: padded heads,
  causal-flash full-S² masking, sliding-window overscan, MoE dispatch
  einsums, capacity slack.

  Bytes: weights are sharded over "model" only (each device reads P/16 per
  pass); activations shard over all axes. Boolean weights move as int8 (+ a
  once-per-step bf16 view in training); FP leaves as bf16. These are the
  JAX package's placements, and the port's (``launch/shardings.py``) in
  every cell but for what a rank does whole over "model", which these
  terms count at its 1/chips share: the dry run's two stated differences
  (k/v where the KV heads do not divide the axis, ``wo``), the MoE router
  and, in decode, whose one routing group spans the batch ranks, each
  rank's C capacity slots of its experts. The MoE dispatch einsums are
  counted, though the port computes their function by index
  (``models/moe.py``). The formulas stay the JAX package's (its tests
  hold them equal): the dry run's ``roofline_placement`` says so.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models import block_roles


def _mesh_info(mesh):
    """(chips, "model" shards, batch shards) of a ``TrainMesh`` (its
    ``shape`` a dict of axis sizes), or of any object with ``axis_names``
    and ``devices.shape`` / ``devices.size`` (a JAX-style mesh)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        shape = dict(mesh.shape)
        chips = 1
        for n in shape.values():
            chips *= n
    else:
        shape = dict(zip(mesh.axis_names, mesh.devices.shape))
        chips = int(mesh.devices.size)
    model = shape.get("model", 1)
    batch_shards = chips // model
    return chips, model, batch_shards


def analytic_cell_cost(cfg, shape, mesh, microbatches: int = 1) -> Dict:
    chips, model_shards, batch_shards = _mesh_info(mesh)
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    D, hd = cfg.d_model, cfg.head_dim_
    hp, kvp = cfg.heads_padded(), cfg.kv_heads_padded()
    roles = block_roles(cfg)
    G = cfg.n_groups

    train = kind == "train"
    decode = kind == "decode"
    T = B * (1 if decode else S)            # tokens this step (global)
    blk_factor = 4.0 if (train and cfg.remat) else (3.0 if train else 1.0)
    head_factor = 3.0 if train else 1.0

    flops = 0.0            # total, all chips
    w_bool = 0.0           # boolean weight params in blocks
    w_fp_blocks = 0.0      # fp params in blocks
    act_bytes = 0.0        # activation traffic (global)

    def linear(t, din, dout, factor):
        nonlocal flops, act_bytes
        flops += factor * 2.0 * t * din * dout
        act_bytes += factor * 2.0 * t * (din + dout)   # bf16 in/out

    # ---- per-group costs ---------------------------------------------------
    for role in roles:
        if role["mixer"] == "mamba":
            DI, N, R = cfg.d_inner_, cfg.ssm_state, cfg.dt_rank_
            for (din, dout) in ((D, DI), (D, DI), (DI, R + 2 * N), (R, DI),
                                (DI, D)):
                linear(T, din, dout, blk_factor)
                w_bool += din * dout
            w_fp_blocks += DI * (N + cfg.conv_width + 2)
            # selective scan: ~14 flops/elem fwd (decay/exp/fma, assoc-scan
            # 2x), x3 for bwd+remat in training
            ssm_f = 14.0 * T * DI * N
            flops += ssm_f * (3.0 if train else 1.0)
            act_bytes += (4.0 * T * DI * N) * (2.0 if train else 1.0)
        else:
            local = role["mixer"] == "attn_local" and cfg.sliding_window > 0
            for (din, dout) in ((D, hp * hd), (D, kvp * hd), (D, kvp * hd),
                                (hp * hd, D)):
                linear(T, din, dout, blk_factor)
                w_bool += din * dout
            # attention matmuls (activation×activation)
            if decode:
                ctx = min(S, cfg.sliding_window) if local else S
                a_f = 2.0 * B * ctx * hp * hd * 2.0
                act_bytes += B * ctx * kvp * hd * 2 * (
                    1 if cfg.kv_cache_quant else 2)   # cache re-read
                if cfg.kv_cache_quant:
                    # per-(token,head) fp32 dequant scales ride with the rows
                    act_bytes += B * ctx * kvp * 2 * 4
            else:
                # chunked flash computes every (qc,kc) pair then masks:
                # full S² (2x causal waste); window layers overscan to the
                # chunk granularity.
                cq = min(cfg.attn_chunk, S)
                if local:
                    w_chunks = min(-(-cfg.sliding_window // cq) + 1, S // cq)
                    pairs = S * w_chunks * cq
                else:
                    pairs = float(S) * S
                a_f = 2.0 * B * pairs * hp * hd * 2.0
                # k/v chunk re-reads per q-chunk
                act_bytes += B * pairs / cq * kvp * hd * 2 * 2
            flops += a_f * blk_factor
        if role["ffn"] is None:
            continue
        if "moe" in role["ffn"]:
            E, k, F = cfg.n_experts, cfg.top_k, cfg.d_ff
            Tg = max(T // max(cfg.moe_groups, 1), 1)
            C = max(8, int(Tg * k / E * cfg.capacity_factor))
            linear(T, D, E, blk_factor)                 # router
            w_fp_blocks += D * E
            if cfg.moe_impl == "einsum":
                # dispatch + combine einsums: 2 x (2·T·D·E·C)
                flops += blk_factor * 4.0 * T * D * E * C
                act_bytes += blk_factor * 2.0 * T * E * C * 2
            # expert GEMMs over E·C·G ≈ T·k·cf slots
            slots = cfg.moe_groups * E * C
            for (din, dout) in ((D, F), (D, F), (F, D)):
                linear(slots, din, dout, blk_factor)
                w_bool += din * dout * E
        if "dense" in role["ffn"]:
            F = cfg.dense_ff_
            for (din, dout) in ((D, F), (D, F), (F, D)):
                linear(T, din, dout, blk_factor)
                w_bool += din * dout

    flops *= G
    act_bytes *= G
    w_bool *= G
    w_fp_blocks *= G

    # ---- embed / head / loss ----------------------------------------------
    V = cfg.vocab_padded
    w_embed = 2.0 * V * D
    t_head = B * S if train else B      # prefill/decode: last position only
    flops += head_factor * 2.0 * t_head * D * V
    act_bytes += head_factor * 2.0 * t_head * (D + V)
    if train:
        flops += 8.0 * t_head * V          # softmax xent fwd+bwd
    # embedding lookup: gather, no flops; bytes:
    act_bytes += T * D * 2 * 2

    # ---- optimizer / gradient pass bytes ------------------------------------
    M = max(microbatches, 1)
    passes = 3.0 if (train and cfg.remat) else (2.0 if train else 1.0)
    if train:
        weight_bytes = (
            w_bool * 1.0                      # int8 read for the view
            + w_bool * 2.0                    # bf16 view write
            + (w_bool + w_fp_blocks) * 2.0 * passes * M   # reads per pass
            + (w_bool + w_fp_blocks) * 4.0 * 2 * M        # fp32 grad acc r/w
            + (w_bool + w_fp_blocks) * 4.0 * 3            # optimizer r/w
            + w_embed * (2.0 * passes * M + 4.0 * 2 * M + 4.0 * 3)
        )
    elif decode:
        # int8 weights read once + transient bf16 view per layer (w=5P r/w)
        weight_bytes = (w_bool * 5.0 + (w_fp_blocks + w_embed) * 2.0)
    else:
        weight_bytes = (w_bool * 5.0 + (w_fp_blocks + w_embed) * 2.0)

    # KV-cache write traffic (decode/prefill)
    cache_bytes = 0.0
    if kind == "prefill":
        n_attn = sum(1 for r in roles if r["mixer"] != "mamba") * G
        cache_bytes = n_attn * B * S * kvp * hd * 2 * 2
    elif decode:
        n_attn = sum(1 for r in roles if r["mixer"] != "mamba") * G
        cache_bytes = n_attn * B * kvp * hd * 2 * 2   # one-token writes

    flops_per_dev = flops / chips
    bytes_per_dev = (act_bytes + cache_bytes) / chips \
        + weight_bytes / model_shards
    return {
        "flops_per_device": flops_per_dev,
        "bytes_per_device": bytes_per_dev,
        "flops_total": flops,
        "weight_bytes_per_device": weight_bytes / model_shards,
        "act_bytes_per_device": (act_bytes + cache_bytes) / chips,
        "w_bool_params": w_bool,
        "w_fp_params": w_fp_blocks + w_embed,
    }
