#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--out build/chip_smoke.json]

Run from the repository root on a host with one CUDA card (Hopper: the
kernels are built for sm_90a). Phases, each fatal on failure:

1. build   -- nvcc builds every kernel of the path from src/repro_torch/csrc
              (one nvcc per source, in parallel) into build/;
2. kernels -- each kernel against its plain PyTorch version on the card, at
              the shapes its path gives it at gemma2-2b widths (serving for
              the GEMV and paged decode, one training microbatch for the
              weight backward), with the stated tolerance;
              kernel, plain-version and library times (CUDA events, median
              of 20 launches, L2 flushed before each) beside the bound;
3. serve   -- gemma2-2b at its published widths (26 layers, d_model 2304,
              vocab 256000, bf16), packed Boolean weights from the port's
              lm_init on a seeded generator, through ServeEngine.session:
              16 requests of 16..600 prompt tokens, 32 tokens each, some
              submitted mid-flight and one cancelled. The launch counters
              are zeroed just before and read just after; both kernels must
              have run exactly as often as the path calls them;
4. check   -- a small fp32 model (gemma2-2b smoke widths, head_dim 64)
              served on the card with the kernels and on the CPU with the
              plain versions: logits within tolerance, greedy tokens
              identical;
5. train   -- gemma2-2b at its published widths, bf16, remat on, trained
              through make_train_step + TrainLoop with hybrid_optimizer
              (the launcher's cosine schedules) on the SyntheticLM
              pipeline: 4 sequences x 512 tokens a step in 2 microbatches,
              2 warm-up steps, then 5 timed steps with the launch counters
              zeroed just before; every Boolean projection's votes must have
              gone through boolean_weight_bwd (7 x 26 launches a
              microbatch). One more step runs under torch.profiler;
6. train check -- a small fp32 model (gemma2-2b smoke widths) trained 3
              steps on the card (kernels) and on the CPU (plain versions)
              from the same state each step: losses within tolerance, flip
              decisions identical except counted ties, and a checkpoint of
              the card's params and optimizer state round-trips bit for bit.

The last lines are one JSON object of kernel results, the card's name and
power limit as nvidia-smi reports them, and the result object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): memory rate, bf16
# tensor-core rate, fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
GEMV_SHAPES = (("wqkv", 2304, 6144), ("wo", 4096, 2304),
               ("wgu", 2304, 18432), ("wd", 9216, 2304))
FLUSH_BYTES = 1 << 30            # > the 50 MB L2; zeroing it keeps the card
                                 # busy ~0.3 ms while the host enqueues the
                                 # timed launch, so host time stays outside


def bound(bytes_moved: float, flops: float, kind: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, flush, iters: int = 20) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush, from CUDA events around the launch alone."""
    for _ in range(3):
        fn()
    marks = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 2. kernel checks
# ---------------------------------------------------------------------------
def check_gemv(torch, flush, gen):
    from repro_torch.kernels import (pack_bits, packed_xnor_gemv,
                                     packed_xnor_gemv_plain)

    rows, worst = [], 0.0
    for name, K, N in GEMV_SHAPES:
        w = (torch.randint(0, 2, (K, N), generator=gen, device="cuda",
                           dtype=torch.int8) * 2 - 1).to(torch.int8)
        wp = pack_bits(w, axis=0)
        w_bf16 = w.to(torch.bfloat16)
        for M in (8, 128):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            y = packed_xnor_gemv(x, wp, k_valid=K)
            ref = packed_xnor_gemv_plain(x, wp, k_valid=K)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            # fp32 sums of K bf16 terms in two association orders
            tol = 1e-5 * ref.abs().max().item() + 1e-4
            print(f"  gemv {name:4s} M={M:3d} K={K} N={N}: max_abs_err={err:.3g}"
                  f" (tol {tol:.3g})")
            assert err <= tol, f"gemv {name} M={M}: {err} > {tol}"
            worst = max(worst, err)
            ms = time_ms(torch, lambda: packed_xnor_gemv(x, wp, k_valid=K), flush)
            plain = time_ms(torch, lambda: packed_xnor_gemv_plain(x, wp, k_valid=K),
                            flush)
            lib = time_ms(torch, lambda: torch.matmul(x, w_bf16), flush)
            b_ms, b_by = bound(x.numel() * 2 + wp.numel() * 4 + M * N * 4,
                               2.0 * M * K * N, "bf16")
            rows.append({"proj": name, "M": M, "K": K, "N": N,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by})
            print(f"    kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                  f"matmul(bf16 ±1) {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
    return rows, worst


def check_paged_decode(torch, flush, gen, cfg):
    from repro_torch.kernels import paged_flash_decode, paged_flash_decode_plain

    L, page, C = 8, 16, 1024 // 16
    KV, hd = cfg.kv_heads_padded(), cfg.head_dim_
    R = cfg.heads_padded() // KV
    n_pages = L * C + 1
    q = torch.randn((L, KV, R, hd), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((n_pages, page, KV, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vp = torch.randn((n_pages, page, KV, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = perm[:L * C].reshape(L, C).to(torch.int32).contiguous()
    # ragged: pos 0, mid-page, page ends, the table's last row, and one lane
    # past its table (its writes go to the garbage page; all rows valid)
    pos = torch.tensor([0, 17, 100, 255, 511, 700, 1023, 1100],
                       dtype=torch.int32, device="cuda")
    bt[0, 1:] = 0                       # a short request: the rest garbage
    live_rows = sum(min(C, (p + page) // page) * page for p in pos.tolist())
    rows, worst = [], 0.0
    for label, window in (("global", 0), ("local", cfg.sliding_window),
                          ("window-100", 100)):
        kw = dict(window=window, softcap_val=cfg.attn_logit_softcap)
        out = paged_flash_decode(q, kp, vp, bt, pos, **kw)
        ref = paged_flash_decode_plain(q, kp, vp, bt, pos, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-4        # fp32 online softmax vs one softmax, |v| < ~5
        print(f"  paged decode {label}: max_abs_err={err:.3g} (tol {tol})")
        assert err <= tol, f"paged decode {label}: {err} > {tol}"
        worst = max(worst, err)
        ms = time_ms(torch, lambda: paged_flash_decode(q, kp, vp, bt, pos, **kw),
                     flush)
        plain = time_ms(torch, lambda: paged_flash_decode_plain(
            q, kp, vp, bt, pos, **kw), flush)
        b_ms, b_by = bound(q.numel() * 2 + live_rows * KV * hd * 2 * 2
                           + bt.numel() * 4 + pos.numel() * 4 + out.numel() * 4,
                           4.0 * live_rows * KV * R * hd, "bf16")
        rows.append({"layer": label, "window": window, "L": L, "KV": KV,
                     "R": R, "hd": hd, "live_rows": live_rows,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
        print(f"    kernel {ms:.4f} ms  plain {plain:.4f} ms  bound "
              f"{b_ms:.4f} ms ({b_by}); library: none (no single PyTorch call "
              "computes softcapped attention over a paged pool)")
    return rows, worst


# one training microbatch of phase 5 (2 sequences x 512 tokens) through each
# Boolean projection of a gemma2-2b layer: (name, M = fan-in, N = fan-out)
WBWD_TOKENS = 1024
WBWD_SHAPES = (("wq", 2304, 4096), ("wk", 2304, 1024), ("wv", 2304, 1024),
               ("wo", 4096, 2304), ("wg", 2304, 9216), ("wu", 2304, 9216),
               ("wd", 9216, 2304))


def check_weight_bwd(torch, flush, gen):
    from repro_torch.core import preactivation_alpha
    from repro_torch.kernels import boolean_weight_bwd, boolean_weight_bwd_plain

    B = WBWD_TOKENS
    ffn_alpha = preactivation_alpha(1)          # the FFN's fan_in-1 window
    cases = [(name, M, N, torch.bfloat16, alpha) for name, M, N in WBWD_SHAPES
             for alpha in (0.0, ffn_alpha)]
    cases.append(("wg", 2304, 9216, torch.int8, 0.0))
    rows, worst = [], 0.0
    for name, M, N, x_dtype, alpha in cases:
        x = torch.randn((B, M), generator=gen, device="cuda")
        x = (torch.where(x >= 0, 1, -1).to(torch.int8) if x_dtype == torch.int8
             else x.to(x_dtype))
        z = torch.randn((B, N), generator=gen, device="cuda").to(torch.bfloat16)
        d = (torch.randn((B, N), generator=gen, device="cuda").to(torch.bfloat16)
             if alpha else None)
        y = boolean_weight_bwd(x, z, d, alpha=alpha)
        ref = boolean_weight_bwd_plain(x, z, d, alpha=alpha)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        # fp32 sums of B exact products in another association order
        tol = 1e-5 * ref.abs().max().item() + 1e-4
        label = f"{name} {str(x_dtype)[6:]} x, alpha={alpha:.4f}"
        print(f"  weight bwd {label} B={B} M={M} N={N}: max_abs_err={err:.3g}"
              f" (tol {tol:.3g})")
        assert err <= tol, f"weight bwd {label}: {err} > {tol}"
        worst = max(worst, err)
        ms = time_ms(torch, lambda: boolean_weight_bwd(x, z, d, alpha=alpha), flush)
        plain = time_ms(torch, lambda: boolean_weight_bwd_plain(x, z, d, alpha=alpha),
                        flush)
        lib = (time_ms(torch, lambda: torch.mm(x.t(), z, out_dtype=torch.float32),
                       flush) if alpha == 0.0 and x.dtype == z.dtype else None)
        b_ms, b_by = bound(x.numel() * x.element_size() + z.numel() * 2
                           + (d.numel() * 2 if alpha else 0) + M * N * 4,
                           2.0 * B * M * N, "bf16")
        rows.append({"proj": name, "x_dtype": str(x_dtype), "alpha": alpha,
                     "B": B, "M": M, "N": N, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                     "bound_by": b_by})
        print(f"    kernel {ms:.4f} ms  plain {plain:.4f} ms  mm(x.T, z) "
              f"{'-' if lib is None else f'{lib:.4f}'} ms  bound {b_ms:.4f} ms "
              f"({b_by})")
    return rows, worst


# ---------------------------------------------------------------------------
# 3. serve gemma2-2b at published widths
# ---------------------------------------------------------------------------
KERNEL_GROUPS = (("packed_xnor_gemv", ("xnor_gemv",)),
                 ("paged_flash_decode", ("paged_decode",)),
                 ("gemm (head, cuBLAS)", ("gemm", "sm90_", "cutlass", "nvjet")))


def profile_segment(torch, engine, prompts, n_tok):
    """Device time by kernel group over one decode segment at 8 busy lanes,
    from torch.profiler (CUPTI), against the segment's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import SamplingParams

    sess = engine.session(lanes=8, page_size=16, segment=8)
    for p in prompts:
        sess.submit(p, SamplingParams(max_tokens=n_tok))
    sess.step()                                  # admission round
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sess.step()                              # one decode segment
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    sess.close()
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other kernels"] = 0.0
    n_kernels = 0
    for e in prof.events():
        if str(e.device_type) != "DeviceType.CUDA":
            continue
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        n_kernels += 1
        for g, keys in KERNEL_GROUPS:
            if any(k in name for k in keys):
                groups[g] += ms
                break
        else:
            groups["other kernels"] += ms
    busy = sum(groups.values())
    out = {"wall_ms": wall_ms, "steps": sess.segment, "device_ms": busy,
           "device_events": n_kernels,
           "idle_share": (1 - busy / wall_ms) if busy else None,
           "device_ms_by_group": groups}
    if busy:
        print(f"  profiled segment: wall {wall_ms:.1f} ms for {sess.segment} "
              f"steps, device busy {busy:.2f} ms (idle share "
              f"{out['idle_share']:.3f}), {n_kernels} device events")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"    {g}: {ms:.3f} ms")
    else:
        print("  profiled segment: the profiler reported no device time "
              "(device breakdown not measured)")
    return out

def serve(torch, seed: int):
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, packed_xnor_gemv, paged_flash_decode
    from repro_torch.models import lm_init
    from repro_torch.serve import RequestStatus, SamplingParams, ServeEngine

    cfg = get_config("gemma2-2b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    engine = ServeEngine(cfg, lm_init(cfg, gen), max_len=1024, packed=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"  gemma2-2b {cfg.n_layers} layers d_model {cfg.d_model} vocab "
          f"{cfg.vocab_size} {cfg.dtype}: init + pack {setup_s:.1f} s")

    import numpy as np
    rng = np.random.default_rng(seed)
    lens = [16, 40, 100, 200, 250, 600, 300, 20, 64, 130, 500, 33, 256, 90,
            480, 17]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    n_tok, first_wave, cancel_rid = 32, 10, 3

    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    sess = engine.session(lanes=8, page_size=16, segment=8)
    submitted, first_at, handles = {}, {}, []

    def submit(i):
        submitted[i] = time.perf_counter()
        handles.append(sess.submit(prompts[i], SamplingParams(max_tokens=n_tok)))

    def note_first_tokens():
        now = time.perf_counter()
        for h in handles:
            if h.rid not in first_at and h.tokens_ready:
                first_at[h.rid] = now

    for i in range(first_wave):
        submit(i)
    seg_ms, decode_tokens, decode_s, steps = [], 0, 0.0, 0
    t_serve = time.perf_counter()
    while sess.step():
        steps += 1
        note_first_tokens()
        if steps == 2:                       # after the first decode segment
            for i in range(first_wave, len(prompts)):
                submit(i)
        if steps == 3:
            assert handles[cancel_rid].cancel()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = {"packed_xnor_gemv": packed_xnor_gemv.launches,
                "paged_flash_decode": paged_flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()

    # the same run again, timed per segment, for the step and token rates
    sess2 = engine.session(lanes=8, page_size=16, segment=8)
    for i in range(8):
        sess2.submit(prompts[i], SamplingParams(max_tokens=n_tok))
    while sess2.step():
        if not sess2.sched.pending and all(
                len(r.emitted) for r in sess2.sched.active.values()):
            break
    while not sess2.idle:
        before = sum(len(r.emitted) for r in sess2.sched.active.values())
        lanes_live = len(sess2.sched.active)
        torch.cuda.synchronize()
        t = time.perf_counter()
        sess2.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        seg_ms.append(dt * 1e3 / sess2.segment)
        decode_tokens += min(lanes_live * sess2.segment,
                             lanes_live * n_tok - before)
        decode_s += dt

    profile = profile_segment(torch, engine, prompts[:8], n_tok)

    stats = sess.stats
    d_steps = stats["decode_steps"]
    gemv_prefills = sum(c for b, c in stats["prefills"].items() if b <= 256)
    per_layer = 4 * cfg.n_layers
    want = {"packed_xnor_gemv": per_layer * (d_steps + gemv_prefills),
            "paged_flash_decode": cfg.n_layers * d_steps}
    print(f"  served {len(handles)} requests in {serve_s:.2f} s: "
          f"{d_steps} decode steps, prefill buckets {dict(stats['prefills'])}")
    print(f"  launches {launches}, expected {want} ({per_layer} GEMV per decode "
          f"step and per prefill of <= 256 rows, {cfg.n_layers} paged decode "
          "per decode step)")
    assert launches == want, (launches, want)
    assert all(v > 0 for v in launches.values()), launches
    for h in handles:
        toks = h.tokens_so_far()
        assert all(0 <= t < cfg.vocab_size for t in toks), h.rid
        if h.rid == cancel_rid:
            assert h.status is RequestStatus.CANCELLED and len(toks) < n_tok
        else:
            assert h.status is RequestStatus.DONE and len(toks) == n_tok, \
                (h.rid, h.status, len(toks))
    ttft = [1e3 * (first_at[r] - submitted[r]) for r in first_at]
    metrics = {
        "requests": len(handles), "decode_steps": d_steps,
        "prefill_buckets": {str(b): c for b, c in stats["prefills"].items()},
        "serve_s": serve_s, "setup_s": setup_s,
        "ttft_ms_median": statistics.median(ttft),
        "ttft_ms_max": max(ttft),
        "step_ms_median": statistics.median(seg_ms),
        "decode_tokens_per_s": decode_tokens / decode_s,
        "max_memory_allocated_bytes": peak,
        "launches": launches,
        "profiled_segment": profile,
    }
    print(f"  decode {metrics['decode_tokens_per_s']:.1f} tokens/s at 8 lanes, "
          f"median step {metrics['step_ms_median']:.2f} ms, median TTFT "
          f"{metrics['ttft_ms_median']:.1f} ms, max_memory_allocated "
          f"{peak / 2**30:.2f} GiB")

    # finite logits of the expected shapes from the served weights
    from repro_torch.models import lm_prefill
    tokens = torch.from_numpy(prompts[0][None]).cuda()
    logits, _ = lm_prefill(cfg, engine.params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert tuple(logits.shape) == (1, 1, cfg.vocab_padded), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    return launches, metrics


# ---------------------------------------------------------------------------
# 4. small model: card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------
def agree_with_cpu(torch, seed: int):
    import numpy as np
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm_init, lm_prefill
    from repro_torch.serve import SamplingParams, ServeEngine

    cfg = get_smoke("gemma2-2b").scaled(head_dim=64, dtype=torch.float32)
    params = lm_init(cfg, torch.Generator().manual_seed(seed))
    engines = [ServeEngine(cfg, params, max_len=128, packed=True, device=d)
               for d in ("cuda", "cpu")]
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (7, 30, 64, 5, 21, 50)]
    tok = torch.from_numpy(prompts[2][None])
    lg = [lm_prefill(cfg, e.params, {"tokens": tok.to(e.device)})[0].cpu()
          for e in engines]
    err = (lg[0] - lg[1]).abs().max().item()
    print(f"  smoke fp32 prefill logits card vs CPU: max_abs_err={err:.3g}")
    assert err <= 1e-3, err      # fp32, sums reassociated across 4 layers

    outs = []
    for e in engines:
        with e.session(lanes=4, page_size=16, segment=4) as s:
            hs = [s.submit(p, SamplingParams(max_tokens=12)) for p in prompts[:4]]
            s.step()
            s.step()
            hs += [s.submit(p, SamplingParams(max_tokens=12)) for p in prompts[4:]]
            s.step()
            hs[1].cancel()
            s.run_until_idle()
            outs.append([h.tokens_so_far() for h in hs])
    same = sum(a == b for a, b in zip(*outs))
    print(f"  smoke greedy streams identical card vs CPU: {same}/{len(prompts)}")
    assert outs[0] == outs[1], outs
    return {"smoke_logits_max_abs_err": err, "smoke_streams_identical": same}


# ---------------------------------------------------------------------------
# 5. train gemma2-2b at published widths
# ---------------------------------------------------------------------------
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 512, 4, 2
WARMUP_STEPS, TIMED_STEPS = 2, 5
TRAIN_GROUPS = (("boolean_weight_bwd", ("weight_bwd",)),
                ("gemm (cuBLAS)", ("gemm", "sm90_", "cutlass", "nvjet")))


def _device_groups(prof, groups):
    """Device ms by kernel group (first key match), the event count, and the
    ten device kernels with the most time."""
    out = {g: 0.0 for g, _ in groups}
    out["other kernels"] = 0.0
    by_name = {}
    n = 0
    for e in prof.events():
        if str(e.device_type) != "DeviceType.CUDA":
            continue
        n += 1
        name = e.name.lower()
        ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + ms
        for g, keys in groups:
            if any(k in name for k in keys):
                out[g] += ms
                break
        else:
            out["other kernels"] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return out, n, top


def train(torch, seed: int):
    import gc
    import math
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.optimizer import (cosine_schedule, hybrid_optimizer,
                                            tree_leaves)
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import KERNELS, boolean_weight_bwd
    from repro_torch.models import lm_init
    from repro_torch.train import TrainLoop, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("gemma2-2b")
    assert cfg.remat and cfg.dtype == torch.bfloat16
    total = WARMUP_STEPS + TIMED_STEPS + 1          # + the profiled step
    t0 = time.perf_counter()
    params = lm_init(cfg, torch.Generator(device="cuda").manual_seed(seed))
    opt = hybrid_optimizer(
        eta=cosine_schedule(4.0, total, warmup=total // 20),
        fp_lr=cosine_schedule(1e-3, total, warmup=total // 20))
    loop = TrainLoop(make_train_step(cfg, opt, TRAIN_MICRO), params,
                     opt.init(params),
                     make_pipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=seed),
                     log_every=1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_bool = sum(p.numel() for p in tree_leaves(params) if p.dtype == torch.int8)
    print(f"  gemma2-2b {cfg.n_layers} layers d_model {cfg.d_model} vocab "
          f"{cfg.vocab_size} {cfg.dtype}, {n_bool / 1e9:.3f} G Boolean weights: "
          f"init + optimizer state {setup_s:.1f} s; {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens a step in {TRAIN_MICRO} microbatches")

    flips = []

    def one_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        loop.run(1, install_signal_handlers=False)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        flips.append(sum(float(f) for f in tree_leaves(loop.opt_state.boolean.flips)))
        return dt

    warm_ms = [one_step() for _ in range(WARMUP_STEPS)]
    for k in KERNELS:
        k.launches = 0
    step_ms = [one_step() for _ in range(TIMED_STEPS)]
    launches = {k.__name__: k.launches for k in KERNELS}
    per_mb = 7 * cfg.n_layers
    want = {"packed_xnor_gemv": 0, "paged_flash_decode": 0,
            "boolean_weight_bwd": TIMED_STEPS * TRAIN_MICRO * per_mb}
    peak = torch.cuda.max_memory_allocated()
    print(f"  launches over the {TIMED_STEPS} timed steps {launches}, expected "
          f"{want} ({per_mb} weight-backward launches a microbatch)")
    assert launches == want, (launches, want)
    assert boolean_weight_bwd.launches > 0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_ms = one_step()
    groups, n_events, top = _device_groups(prof, TRAIN_GROUPS)
    busy = sum(groups.values())

    losses = loop.history
    assert len(losses) == total and all(math.isfinite(x) for x in losses), losses
    w = loop.params["blocks"]["b0"]["ffn"]["wg"]["w"]
    assert w.dtype == torch.int8 and bool(((w == 1) | (w == -1)).all())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(step_ms)
    metrics = {
        "config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                   "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
                   "dtype": str(cfg.dtype), "remat": cfg.remat,
                   "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                   "microbatches": TRAIN_MICRO},
        "setup_s": setup_s, "losses": losses, "flips": flips,
        "warmup_step_ms": warm_ms, "step_ms": step_ms,
        "step_ms_median": med, "tokens_per_s": tokens / (med / 1e3),
        "max_memory_allocated_bytes": peak, "launches": launches,
        "profiled_step": {"wall_ms": prof_ms, "device_ms": busy,
                          "device_events": n_events,
                          "idle_share": (1 - busy / prof_ms) if busy else None,
                          "device_ms_by_group": groups,
                          "top_kernels_ms": top},
    }
    print("  loss per step " + " ".join(f"{x:.4f}" for x in losses))
    print("  flips per step " + " ".join(f"{x:.0f}" for x in flips))
    print(f"  median step {med:.1f} ms ({tokens / (med / 1e3):.0f} tokens/s), "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if busy:
        print(f"  profiled step: wall {prof_ms:.1f} ms, device busy {busy:.1f} ms "
              f"(idle share {1 - busy / prof_ms:.3f}), {n_events} device events")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"    {g}: {ms:.2f} ms ({ms / busy:.3f} of device time)")
        print("  kernels with the most device time:")
        for name, ms in top:
            print(f"    {ms:8.2f} ms  {name}")
    else:
        print("  profiled step: the profiler reported no device time "
              "(device breakdown not measured)")
    return launches, metrics


# ---------------------------------------------------------------------------
# 6. small model training: card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------
def _to(tree, device):
    """A copy of a tree of dicts / NamedTuples / tensors on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_to(v, device) for v in tree))
    return tree.to(device, copy=True)


def train_agree_with_cpu(torch, seed: int):
    import tempfile

    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_smoke
    from repro_torch.core.optimizer import hybrid_optimizer
    from repro_torch.data import make_pipeline
    from repro_torch.models import lm_init
    from repro_torch.train import make_train_step

    cfg = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params = lm_init(cfg, torch.Generator().manual_seed(seed))
    opt = hybrid_optimizer(eta=1000.0, fp_lr=1e-3)  # flips at smoke width
    state = opt.init(params)
    step = make_train_step(cfg, opt, 2)
    pipe = make_pipeline(cfg, 32, 4, seed=seed)
    loss_err, n_flips, n_ties = 0.0, 0, 0
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
        before = {k: v.clone() for k, v in _flatten(params).items()}
        p_c, s_c, m_c = step(_to(params, "cuda"), _to(state, "cuda"),
                             {k: v.cuda() for k, v in batch.items()})
        params, state, m_h = step(params, state, batch)      # CPU, in place
        err = abs(float(m_c["loss"]) - float(m_h["loss"]))
        # fp32, 4 layers, votes and sums reassociated on the card
        assert err <= 1e-4, (i, float(m_c["loss"]), float(m_h["loss"]))
        loss_err = max(loss_err, err)
        card, host = _flatten(p_c), _flatten(params)
        acc_c = _flatten(s_c.boolean.accum)
        acc_h = _flatten(state.boolean.accum)
        for key, w0 in before.items():
            if w0.dtype != torch.int8:
                continue
            wc, wh = card[key].cpu(), host[key]
            n_flips += int((wh != w0).sum())
            differ = wc != wh
            if differ.any():
                # one side flipped and the other did not: a tie only if the
                # side that kept its weight sits at the threshold (m·w ≥ 1),
                # within the bf16 accumulator's resolution
                kept = torch.where(wc == w0, acc_c[key].cpu(), acc_h[key])
                margin = kept[differ].float() * w0[differ].float()
                assert bool((margin >= 1 - 2 ** -7).all()), (key, margin.min())
                n_ties += int(differ.sum())
    print(f"  smoke fp32 training card vs CPU, 3 steps x 2 microbatches: loss "
          f"max_abs_err={loss_err:.3g}, {n_flips} flips on the CPU, {n_ties} "
          "differing decisions (all ties at the threshold)")
    assert n_flips > 0

    tree = {"params": p_c, "opt": s_c}
    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(tree, tmp, 3, sync=True)
        back, step_no = restore_pytree(_to(tree, "cuda"), tmp)
    assert step_no == 3
    flat_a, flat_b = _flatten(tree), _flatten(back)
    assert flat_a.keys() == flat_b.keys()
    for k, a in flat_a.items():
        b = flat_b[k]
        assert b.is_cuda and b.dtype == a.dtype and torch.equal(a, b), k
    print(f"  checkpoint of the card's params and optimizer state: "
          f"{len(flat_a)} leaves round-trip bit for bit")
    return {"train_smoke_loss_max_abs_err": loss_err,
            "train_smoke_flips": n_flips, "train_smoke_ties": n_ties}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    device_line = smi_line()
    print(f"device: {device_line}")

    print("1. build")
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"  built {secs} in {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("2. kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gemv_rows, gemv_err = check_gemv(torch, flush, gen)
    dec_rows, dec_err = check_paged_decode(torch, flush, gen,
                                           get_config("gemma2-2b"))
    wbwd_rows, wbwd_err = check_weight_bwd(torch, flush, gen)
    del flush

    print("3. serve gemma2-2b (published widths) through the packed session")
    launches, metrics = serve(torch, args.seed)

    print("4. small fp32 model: card kernels vs CPU plain versions")
    metrics.update(agree_with_cpu(torch, args.seed))

    print("5. train gemma2-2b (published widths) through make_train_step + TrainLoop")
    train_launches, train_metrics = train(torch, args.seed)

    print("6. small fp32 model training: card kernels vs CPU plain versions")
    train_metrics.update(train_agree_with_cpu(torch, args.seed))

    decode_m8 = [r for r in gemv_rows if r["M"] == 8]
    layer_votes = [r for r in wbwd_rows if r["alpha"] == 0.0
                   and r["x_dtype"] == "torch.bfloat16"]
    local = next(r for r in dec_rows if r["layer"] == "local")
    kernels = [
        {"name": "packed_xnor_gemv", "route": "cuda",
         "source": "src/repro_torch/csrc/packed_xnor_gemv.cu",
         "replaces": "src/repro/kernels/packed_xnor.py:168",
         "launches": launches["packed_xnor_gemv"], "max_abs_err": gemv_err,
         "ms": sum(r["ms"] for r in decode_m8),
         "plain_ms": sum(r["plain_ms"] for r in decode_m8),
         "bound_ms": sum(r["bound_ms"] for r in decode_m8),
         "bound_by": ("bytes" if sum(r["bound_by"] == "bytes" for r in decode_m8)
                      * 2 >= len(decode_m8) else "operations"),
         "library_ms": sum(r["library_ms"] for r in decode_m8),
         "shape": "sum over one layer's wqkv, wo, wgu, wd at M=8 lanes, bf16 x"},
        {"name": "paged_flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_flash_decode.cu",
         "replaces": "src/repro/kernels/paged_attention.py:156",
         "launches": launches["paged_flash_decode"], "max_abs_err": dec_err,
         "ms": local["ms"], "plain_ms": local["plain_ms"],
         "bound_ms": local["bound_ms"], "bound_by": local["bound_by"],
         "library_ms": None,
         "shape": f"{local['L']} lanes, {local['KV']} KV heads x {local['R']} "
                  f"q heads, head_dim {local['hd']}, bf16 pool, "
                  f"{local['live_rows']} live rows, window {local['window']}"},
        {"name": "boolean_weight_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/boolean_weight_bwd.cu",
         "replaces": "src/repro/kernels/boolean_bwd.py:52",
         "launches": train_launches["boolean_weight_bwd"],
         "max_abs_err": wbwd_err,
         "ms": sum(r["ms"] for r in layer_votes),
         "plain_ms": sum(r["plain_ms"] for r in layer_votes),
         "bound_ms": sum(r["bound_ms"] for r in layer_votes),
         "bound_by": ("bytes" if sum(r["bound_by"] == "bytes" for r in layer_votes)
                      * 2 >= len(layer_votes) else "operations"),
         "library_ms": sum(r["library_ms"] for r in layer_votes),
         "shape": f"sum over one layer's wq, wk, wv, wo, wg, wu, wd votes at "
                  f"B={WBWD_TOKENS} tokens (one microbatch), bf16 x and z, "
                  "alpha=0"},
    ]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": device_line, "seed": args.seed,
                               "build_s": secs, "gemv": gemv_rows,
                               "paged_decode": dec_rows, "weight_bwd": wbwd_rows,
                               "serve": metrics, "train": train_metrics,
                               "kernels": kernels}, indent=1))
    print(f"details written to {out}")
    print(json.dumps({"kernels": kernels}))
    print(device_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
