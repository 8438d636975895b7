#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--out build/chip_smoke.json]

Run from the repository root on a host with one CUDA card (Hopper: the
kernels are built for sm_90a). Phases, each fatal on failure:

1. build   -- nvcc builds every kernel of the paths from src/repro_torch/csrc
              (seven sources, one nvcc each, all started together) into
              build/; ptxas's registers and spills of each wgmma + TMA
              kernel (csrc/hopper_gemm.cuh's ring_kernel) by instance;
2. kernels -- each kernel against its plain PyTorch version on the card, at
              the shapes its path gives it at gemma2-2b widths (serving for
              the GEMV, paged decode over bf16 and int8 pools, the flash
              prefill and the paged prefix attention; one training
              microbatch for the weight backward), with the stated
              tolerance (per element for the two prefill kernels, whose
              query rows are scaled so the softcap binds; the prefix kernel
              also over a garbage-padded page list); the weight backward's
              tensor-core route also bit-exact on small-integer operands at
              each projection's shape, and its CUDA-core route at alpha > 0,
              int8 x and a ragged bf16 shape; the two ±1 GEMMs
              (boolean_matmul in counts and fused-threshold mode,
              packed_xnor_matmul) bit-exact at the four ±1-input convs of
              VGG-SMALL at batch 100, one SMALL-EDSR block conv and a ragged
              shape; kernel, plain-version and library times (CUDA
              events, median of 20 launches, L2 flushed before each) beside
              the bound, and boolean_matmul's operand copy alone;
3. serve   -- gemma2-2b at its published widths (26 layers, d_model 2304,
              vocab 256000, bf16), packed Boolean weights from the port's
              lm_init on a seeded generator, through ServeEngine.session:
              16 requests of 16..600 prompt tokens, 32 tokens each, some
              submitted mid-flight and one cancelled. The launch counters
              are zeroed just before and read just after; every kernel must
              have run exactly as often as the path calls it (the flash
              prefill once a layer of every prefill);
4. check   -- a small fp32 model (gemma2-2b smoke widths, head_dim 64)
              served on the card with the kernels and on the CPU with the
              plain versions: logits within tolerance, greedy tokens
              identical, also under prefix-cached traffic with and without
              kv-quant;
5. train   -- gemma2-2b at its published widths, bf16, remat on, trained
              through make_train_step + TrainLoop with hybrid_optimizer
              (the launcher's cosine schedules) on the SyntheticLM
              pipeline: 4 sequences x 512 tokens a step in 2 microbatches,
              2 warm-up steps, then 5 timed steps with the launch counters
              zeroed just before; every Boolean projection's votes must have
              gone through boolean_weight_bwd (7 x 26 launches a
              microbatch), every launch on its tensor-core route. One more
              step runs under torch.profiler;
6. train check -- a small fp32 model (gemma2-2b smoke widths) trained 3
              steps on the card (kernels) and on the CPU (plain versions)
              from the same state each step: losses within tolerance, flip
              decisions identical except counted ties, and a checkpoint of
              the card's params and optimizer state round-trips bit for bit;
7. prefix  -- gemma2-2b at its published widths served through
              ServeEngine(packed=True, prefix_cache=True).session, once
              over a bf16 KV pool and once with kv_cache_quant (int8 pools
              with fp32 per-row scales): a 512-token system prompt shared
              by 16 requests (distinct tails of 16..256 tokens, 32 tokens
              each; the first cold, the rest partial hits), then 4 repeats
              of earlier full prompts. Launch counters exact (flash prefill
              per cold prefill, paged prefix attention per tail prefill,
              paged decode per decode step, none for an exact hit), prefix
              statistics as expected, exact-hit streams bit-identical to
              the streams that seeded their records, pages conserved after
              the drain; each partial-hit stream is compared with a cold run
              of its full prompt (a divergence where the cold run's top-2
              logit margin exceeds 1.0 fails), and for the longest tail the
              first layer's committed K/V rows and attention output must
              match the cold prefill's at the same positions within bf16
              roundings, element by element. TTFT by admission kind, the
              decode step and peak memory are reported;
8. vision  -- Boolean VGG-SMALL at published widths (stages 128/256/512,
              fc 1024, 32x32x3, 10 classes; weights from vgg_init on the
              seed) over 10 batches of 100 synthetic class-conditional
              images, evaluated with float-view, int8 and PackedBool
              Boolean leaves, without and with BN: launch counters exact (4
              a batch for the route's kernel, 0 for every other), the
              kernel routes' ±1 activations and predictions identical to
              the plain route's (the GEMMs' plain versions on the card) and
              to each other, the float route's (cuDNN) differences counted;
              3 training steps of the example (flip rule + Adam) at batch
              100; SMALL-EDSR (8 blocks, width 64, x2) on 4 x 128x128
              through the three leaf forms (8 launches a kernel forward,
              outputs identical to the plain route). Images/s per route.

The last lines are one JSON object of kernel results, the card's name and
power limit as nvidia-smi reports them, and the result object.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): memory rate, bf16
# tensor-core rate, fp32 rate outside the tensor cores, int8 tensor-core
# rate (integer operations a second).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
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
    # int8 pools with per-(row, head) scales, |v| < ~5 like the bf16 pool
    k8 = torch.randint(-127, 128, kp.shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, kp.shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    ks = torch.rand(kp.shape[:3], generator=gen, device="cuda") * 0.035 + 0.005
    vs = torch.rand(kp.shape[:3], generator=gen, device="cuda") * 0.035 + 0.005
    pools = {"bf16": (kp, vp, None, None), "int8": (k8, v8, ks, vs)}
    rows, worst = [], 0.0
    for pool, (k_, v_, ks_, vs_) in pools.items():
        row_bytes = hd * k_.element_size() + (4 if ks_ is not None else 0)
        for label, window in (("global", 0), ("local", cfg.sliding_window),
                              ("window-100", 100)):
            kw = dict(window=window, softcap_val=cfg.attn_logit_softcap)
            args = (q, k_, v_, bt, pos, ks_, vs_)
            out = paged_flash_decode(*args, **kw)
            ref = paged_flash_decode_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 1e-4    # fp32 online softmax vs one softmax, |v| < ~5
            print(f"  paged decode {pool} pool {label}: max_abs_err={err:.3g} "
                  f"(tol {tol})")
            assert err <= tol, f"paged decode {pool} {label}: {err} > {tol}"
            worst = max(worst, err)
            ms = time_ms(torch, lambda: paged_flash_decode(*args, **kw), flush)
            plain = time_ms(torch, lambda: paged_flash_decode_plain(*args, **kw),
                            flush)
            b_ms, b_by = bound(q.numel() * 2 + live_rows * KV * row_bytes * 2
                               + bt.numel() * 4 + pos.numel() * 4
                               + out.numel() * 4,
                               4.0 * live_rows * KV * R * hd, "bf16")
            rows.append({"pool": pool, "layer": label, "window": window,
                         "L": L, "KV": KV, "R": R, "hd": hd,
                         "live_rows": live_rows, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain, "library_ms": None,
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"    kernel {ms:.4f} ms  plain {plain:.4f} ms  bound "
                  f"{b_ms:.4f} ms ({b_by}); library: none (no single PyTorch "
                  "call computes softcapped attention over a paged pool)")
    return rows, worst


def _live_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) attention over S rows needs:
    sum over t of min(t + 1, window)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


# gemma2-2b prefill of one layer (16 padded q heads over 4 KV heads, head_dim
# 256): (label, S, window, dtype)
FLASH_CASES = (("global", 256, 0, "bf16"), ("local", 256, 4096, "bf16"),
               ("global", 1024, 0, "bf16"), ("local", 1024, 4096, "bf16"),
               ("window-256", 1024, 256, "bf16"), ("global", 256, 0, "fp32"))


def check_flash(torch, flush, gen, cfg):
    from repro_torch.kernels import flash_attention_fwd, flash_attention_plain

    H, KV, hd = cfg.heads_padded(), cfg.kv_heads_padded(), cfg.head_dim_
    n_rep = H // KV
    rows, worst = [], 0.0
    for label, S, window, dt in FLASH_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        # q x 8: scores of std ~8 reach |s| ~ 40, where the softcap of 50
        # moves them by up to ~10 (a kernel without the tanh fails)
        q = (8 * torch.randn((H, S, hd), generator=gen, device="cuda")).to(dtype)
        k = torch.randn((KV, S, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((KV, S, hd), generator=gen, device="cuda").to(dtype)
        kw = dict(causal=True, window=window, softcap=cfg.attn_logit_softcap,
                  n_rep=n_rep)
        out = flash_attention_fwd(q, k, v, **kw).float()
        ref = flash_attention_plain(q, k, v, **kw).float()
        absv = flash_attention_plain(q, k, v.abs(), **kw).float()
        torch.cuda.synchronize()
        # per element: fp32 reassociation (2^-17 of sum p|v| / l), and for
        # bf16 outputs one rounding of each side to the nearest bf16, at
        # most one ulp of the larger apart
        tol = 2.0 ** -17 * absv
        if dt == "bf16":
            tol = tol + 2.0 ** -7 * torch.maximum(out.abs(), ref.abs())
        diff = (out - ref).abs()
        err, ratio = diff.max().item(), (diff / tol).max().item()
        print(f"  flash prefill {label} S={S} window={window} {dt}: "
              f"max_abs_err={err:.3g}, max err/tol {ratio:.3g}")
        assert ratio <= 1.0, f"flash {label} S={S} {dt}: err/tol {ratio}"
        worst = max(worst, err)
        ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, **kw), flush)
        plain = time_ms(torch, lambda: flash_attention_plain(q, k, v, **kw),
                        flush)
        kr, vr = (x.repeat_interleave(n_rep, 0)[None] for x in (k, v))
        sdpa = time_ms(torch, lambda: torch.nn.functional
                       .scaled_dot_product_attention(q[None], kr, vr,
                                                     is_causal=True), flush)
        pairs = H * _live_pairs(S, window)
        b_ms, b_by = bound((q.numel() * 2 + k.numel() * 2) * q.element_size(),
                           4.0 * hd * pairs, "bf16")
        rows.append({"case": label, "S": S, "window": window, "dtype": dt,
                     "BH": H, "KV": KV, "hd": hd, "live_pairs": pairs,
                     "max_abs_err": err, "max_err_over_tol": ratio, "ms": ms,
                     "plain_ms": plain, "library_ms": None,
                     "sdpa_causal_no_softcap_ms": sdpa, "bound_ms": b_ms,
                     "bound_by": b_by})
        print(f"    kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms:.4f} "
              f"ms ({b_by}); library: none (no single PyTorch call computes "
              f"softcapped attention); sdpa(is_causal, no softcap or window: "
              f"not the same function) {sdpa:.4f} ms")
    return rows, worst


# the prefix-cache tail prefill of phase 7: a 512-row prefix in 32 scattered
# pages of 16 rows, tail buckets of 128 and 256 rows (5 padded rows each);
# and a 45-row prefix in 3 live pages bucketed to 4, the padding entry the
# garbage page 0 (filled with values that would wreck any row read from it)
PREFIX_ROWS, PREFIX_PAGE = 512, 16
# (tail bucket T, live prefix rows, page_ids entries)
PREFIX_CASES = ((128, 512, 32), (256, 512, 32), (128, 45, 4))


def check_prefix(torch, flush, gen, cfg):
    from repro_torch.kernels import (paged_prefix_attention,
                                     paged_prefix_attention_plain)

    H, KV, hd = cfg.heads_padded(), cfg.kv_heads_padded(), cfg.head_dim_
    n_rep, page = H // KV, PREFIX_PAGE
    n_pages = 8 * (1024 // page) + 1
    shape = (n_pages, page, KV, hd)
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).to(torch.int32)
    kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    k8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    ks = torch.rand(shape[:3], generator=gen, device="cuda") * 0.035 + 0.005
    vs = torch.rand(shape[:3], generator=gen, device="cuda") * 0.035 + 0.005
    kp[0], vp[0], ks[0], vs[0] = 1e4, 1e4, 1e3, 1e3     # the garbage page
    pools = {"bf16": (kp, vp, None, None), "int8": (k8, v8, ks, vs)}
    rows, worst = [], 0.0
    for T, prefix_len, npp in PREFIX_CASES:
        length = T - 5
        n_live = -(-prefix_len // page)
        page_ids = torch.zeros((npp,), dtype=torch.int32, device="cuda")
        page_ids[:n_live] = perm[:n_live]
        # q x 8: the softcap of 50 binds (scores of std ~8)
        q = (8 * torch.randn((H, T, hd), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        kt = torch.randn((T, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
        vt = torch.randn((T, KV, hd), generator=gen, device="cuda").to(torch.bfloat16)
        for pool, (k_, v_, ks_, vs_) in pools.items():
            args = (q, kt, vt, k_, v_, page_ids, prefix_len, prefix_len,
                    length, ks_, vs_)
            kw = dict(n_rep=n_rep, window=0, softcap_val=cfg.attn_logit_softcap)
            out = paged_prefix_attention(*args, **kw)
            ref = paged_prefix_attention_plain(*args, **kw)
            absv = paged_prefix_attention_plain(
                q, kt, vt.abs(), k_, v_.abs(), page_ids, prefix_len,
                prefix_len, length, ks_, vs_, **kw)
            torch.cuda.synchronize()
            # per element: both cast p to bf16 before the value product,
            # each against its own running max, so each p_j may be one bf16
            # rounding off on either side: 2^-7 of sum p|v| / l, plus 2^-12
            # of it for fp32 reassociation and the rounding inside absv
            tol = (2.0 ** -7 + 2.0 ** -12) * absv
            diff = (out - ref).abs()
            err, ratio = diff.max().item(), (diff / tol).max().item()
            print(f"  paged prefix {pool} pool T={T} (length {length}) over "
                  f"{prefix_len} prefix rows in {n_live} of {npp} pages: "
                  f"max_abs_err={err:.3g}, max err/tol {ratio:.3g}")
            assert bool(torch.isfinite(out).all()) and ratio <= 1.0, \
                f"paged prefix {pool} T={T} prefix {prefix_len}: {ratio}"
            worst = max(worst, err)
            ms = time_ms(torch, lambda: paged_prefix_attention(*args, **kw),
                         flush)
            plain = time_ms(torch, lambda: paged_prefix_attention_plain(
                *args, **kw), flush)
            row_bytes = hd * k_.element_size() + (4 if ks_ is not None else 0)
            pairs = H * sum(prefix_len + min(t + 1, length) for t in range(T))
            b_ms, b_by = bound(q.numel() * 2 + kt.numel() * 2 * 2
                               + prefix_len * KV * row_bytes * 2
                               + page_ids.numel() * 4 + out.numel() * 4,
                               4.0 * hd * pairs, "bf16")
            rows.append({"pool": pool, "T": T, "length": length,
                         "prefix_rows": prefix_len, "live_pages": n_live,
                         "page_ids": npp, "H": H, "KV": KV, "hd": hd,
                         "live_pairs": pairs, "max_abs_err": err,
                         "max_err_over_tol": ratio, "ms": ms,
                         "plain_ms": plain, "library_ms": None,
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"    kernel {ms:.4f} ms  plain {plain:.4f} ms  bound "
                  f"{b_ms:.4f} ms ({b_by}); library: none (no single PyTorch "
                  "call computes softcapped attention over a paged pool)")
    return rows, worst


# one training microbatch of phase 5 (2 sequences x 512 tokens) through each
# Boolean projection of a gemma2-2b layer: (name, M = fan-in, N = fan-out)
WBWD_TOKENS = 1024
WBWD_SHAPES = (("wq", 2304, 4096), ("wk", 2304, 1024), ("wv", 2304, 1024),
               ("wo", 4096, 2304), ("wg", 2304, 9216), ("wu", 2304, 9216),
               ("wd", 9216, 2304))


def check_weight_bwd(torch, flush, gen):
    """boolean_weight_bwd on both routes at one training microbatch's
    shapes: bf16 x and z at alpha 0 (the tensor-core route, every launch of
    phase 5) bit-exact on small-integer operands, whose fp32 sums are exact
    in any order, so a layout error cannot hide under the tolerance; random
    operands within the tolerance on both routes (alpha > 0, int8 x and a
    bf16 shape with M, N not multiples of 8 take the CUDA-core route);
    kernel, plain-version and torch.mm times."""
    from repro_torch.core import preactivation_alpha
    from repro_torch.kernels import (boolean_weight_bwd, boolean_weight_bwd_plain,
                                     weight_bwd_route)

    B = WBWD_TOKENS
    for name, M, N in WBWD_SHAPES:
        x = torch.randint(-2, 3, (B, M), generator=gen, device="cuda").to(torch.bfloat16)
        z = torch.randint(-2, 3, (B, N), generator=gen, device="cuda").to(torch.bfloat16)
        route = weight_bwd_route(x, z)
        y, ref = boolean_weight_bwd(x, z), boolean_weight_bwd_plain(x, z)
        torch.cuda.synchronize()
        same = bool(torch.equal(y, ref))
        print(f"  weight bwd {name} integer-valued bf16 x, z in [-2, 2] B={B} "
              f"M={M} N={N}: route {route}, bit-exact {same}")
        assert route == "tensor_cores" and same, (name, route, same)
    ffn_alpha = preactivation_alpha(1)          # the FFN's fan_in-1 window
    cases = [(name, M, N, torch.bfloat16, alpha) for name, M, N in WBWD_SHAPES
             for alpha in (0.0, ffn_alpha)]
    cases.append(("wg", 2304, 9216, torch.int8, 0.0))
    cases.append(("ragged", 2300, 1020, torch.bfloat16, 0.0))
    rows, worst = [], 0.0
    for name, M, N, x_dtype, alpha in cases:
        x = torch.randn((B, M), generator=gen, device="cuda")
        x = (torch.where(x >= 0, 1, -1).to(torch.int8) if x_dtype == torch.int8
             else x.to(x_dtype))
        z = torch.randn((B, N), generator=gen, device="cuda").to(torch.bfloat16)
        d = (torch.randn((B, N), generator=gen, device="cuda").to(torch.bfloat16)
             if alpha else None)
        route = weight_bwd_route(x, z, alpha)
        want = ("tensor_cores" if x_dtype == torch.bfloat16 and alpha == 0.0
                and name != "ragged" else "cuda_cores")
        assert route == want, (name, route, want)
        y = boolean_weight_bwd(x, z, d, alpha=alpha)
        ref = boolean_weight_bwd_plain(x, z, d, alpha=alpha)
        mm = (torch.mm(x.t(), z, out_dtype=torch.float32)
              if alpha == 0.0 and x.dtype == z.dtype else None)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        mm_err = None if mm is None else (mm - ref).abs().max().item()
        # fp32 sums of B exact products in another association order
        tol = 1e-5 * ref.abs().max().item() + 1e-4
        label = f"{name} {str(x_dtype)[6:]} x, alpha={alpha:.4f}"
        print(f"  weight bwd {label} B={B} M={M} N={N}: route {route}, "
              f"max_abs_err={err:.3g} (tol {tol:.3g}"
              + ("" if mm_err is None else f"; torch.mm's {mm_err:.3g}") + ")")
        assert err <= tol, f"weight bwd {label}: {err} > {tol}"
        worst = max(worst, err)
        ms = time_ms(torch, lambda: boolean_weight_bwd(x, z, d, alpha=alpha), flush)
        plain = time_ms(torch, lambda: boolean_weight_bwd_plain(x, z, d, alpha=alpha),
                        flush)
        lib = (time_ms(torch, lambda: torch.mm(x.t(), z, out_dtype=torch.float32),
                       flush) if mm is not None else None)
        b_ms, b_by = bound(x.numel() * x.element_size() + z.numel() * 2
                           + (d.numel() * 2 if alpha else 0) + M * N * 4,
                           2.0 * B * M * N, "bf16")
        rows.append({"proj": name, "x_dtype": str(x_dtype), "alpha": alpha,
                     "B": B, "M": M, "N": N, "route": route,
                     "max_abs_err": err, "library_max_abs_err": mm_err,
                     "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": b_ms, "bound_by": b_by})
        print(f"    {route} kernel {ms:.4f} ms  plain {plain:.4f} ms  mm(x.T, z) "
              f"{'-' if lib is None else f'{lib:.4f}'} ms  bound {b_ms:.4f} ms "
              f"({b_by})")
    return rows, worst


# the ±1-input Boolean convs of phase 8 as GEMMs (M pixels, K = 9·Cin, N =
# Cout): VGG-SMALL at batch 100 (stages 1 and 2), one SMALL-EDSR block conv
# on 4 x 128 x 128, and a ragged shape (K not a multiple of 16, M and N not
# of the 128 tile, N not of 4: the kernels' byte-load path)
GEMM_SHAPES = (("vgg s1c0", 25600, 1152, 256), ("vgg s1c1", 25600, 2304, 256),
               ("vgg s2c0", 6400, 2304, 512), ("vgg s2c1", 6400, 4608, 512),
               ("edsr block", 65536, 576, 64), ("ragged", 1000, 100, 70))
VGG_GEMMS = GEMM_SHAPES[:4]
# H100 SXM: 132 SMs x 16 population counts a clock (compute capability 9.0,
# NVIDIA's CUDA C++ Programming Guide) x 1.98 GHz boost clock
POPC_PER_S = 132 * 16 * 1.98e9


def check_bool_gemm(torch, flush, gen):
    """boolean_matmul (counts and the fused threshold at tau 0) and
    packed_xnor_matmul at the phase-8 shapes, each bit-exact against its
    plain version; torch._int_mm (cuBLASLt int8) on the unpacked operands,
    the faster of w row-major and column-major, as the library yardstick
    where it takes the shape. boolean_matmul's time includes its operand
    preparation (w transposed, K padded), which is also timed alone."""
    from repro_torch.kernels import (boolean_matmul, boolean_matmul_operands,
                                     boolean_matmul_plain, pack_bits,
                                     packed_xnor_matmul,
                                     packed_xnor_matmul_plain)

    rows = []
    for name, M, K, N in GEMM_SHAPES:
        x = torch.where(torch.rand((M, K), generator=gen, device="cuda") < 0.5,
                        1, -1).to(torch.int8)
        w = torch.where(torch.rand((K, N), generator=gen, device="cuda") < 0.5,
                        1, -1).to(torch.int8)
        xp, wp = pack_bits(x, axis=1), pack_bits(w, axis=0)
        Kw = xp.shape[1]
        # the yardstick only; the port never calls it. w is a stored weight,
        # so it is timed both row-major and column-major (cuBLASLt's int8
        # tensor-core kernels want B column-major), and the faster counts.
        lib_layouts = {}
        if K % 8 == 0 and N % 8 == 0 and M > 16:
            for layout, wl in (("row_major", w), ("col_major", w.t().contiguous().t())):
                try:
                    assert torch.equal(torch._int_mm(x, wl), torch._int_mm(x, w))
                    lib_layouts[layout] = time_ms(
                        torch, lambda wl=wl: torch._int_mm(x, wl), flush)
                except RuntimeError as e:
                    print(f"  torch._int_mm refused {name} ({layout} w): {e}")
        lib = min(lib_layouts.values()) if lib_layouts else None
        if lib_layouts:
            print(f"  torch._int_mm {name}: " + "  ".join(
                f"{k} w {v:.4f} ms" for k, v in lib_layouts.items()))
        ops = 2.0 * M * K * N
        xk, wt = boolean_matmul_operands(x, w)
        torch.cuda.synchronize()
        same = bool(torch.equal(wt[:, :K], w.t()) and not wt[:, K:].any()
                    and torch.equal(xk[:, :K], x) and not xk[:, K:].any())
        operands_ms = time_ms(torch, lambda: boolean_matmul_operands(x, w), flush)
        print(f"  boolean_matmul operands {name} (w transposed by the library's "
              f"transpose kernel, K padded to {xk.shape[1]}): bit-exact {same}, "
              f"{operands_ms:.4f} ms")
        assert same, f"boolean_matmul operands {name}: differ from w.t()"
        del xk, wt
        cases = (
            ("boolean_matmul counts", lambda: boolean_matmul(x, w),
             lambda: boolean_matmul_plain(x, w), M * K + K * N + 4 * M * N, lib),
            ("boolean_matmul fused", lambda: boolean_matmul(
                x, w, fuse_threshold=True, tau=0.0), lambda: boolean_matmul_plain(
                x, w, fuse_threshold=True, tau=0.0), M * K + K * N + M * N, None),
            ("packed_xnor_matmul", lambda: packed_xnor_matmul(xp, wp, k_valid=K),
             lambda: packed_xnor_matmul_plain(xp, wp, k_valid=K),
             4 * (M * Kw + Kw * N) + 4 * M * N, lib))
        for kernel, fn, plain_fn, nbytes, lib_ms in cases:
            y, ref = fn(), plain_fn()
            torch.cuda.synchronize()
            same = bool(torch.equal(y, ref))
            err = (y.to(torch.int64) - ref.to(torch.int64)).abs().max().item()
            print(f"  {kernel} {name} M={M} K={K} N={N}: bit-exact {same} "
                  f"(max_abs_err {err})")
            assert same, f"{kernel} {name}: differs from its plain version"
            ms = time_ms(torch, fn, flush)
            plain = time_ms(torch, plain_fn, flush)
            b_ms, b_by = bound(nbytes, ops, "int8")
            row = {"kernel": kernel, "shape": name, "M": M, "K": K, "N": N,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
            if lib_ms is not None:
                row["library_layouts_ms"] = lib_layouts
            if kernel == "packed_xnor_matmul":
                row["popc_floor_ms"] = M * N * Kw / POPC_PER_S * 1e3
            else:
                row["operands_ms"] = operands_ms
            rows.append(row)
            print(f"    kernel {ms:.4f} ms  plain {plain:.4f} ms  _int_mm "
                  f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms  bound "
                  f"{b_ms:.4f} ms ({b_by})"
                  + (f"  popcount floor {row['popc_floor_ms']:.4f} ms"
                     if "popc_floor_ms" in row else ""))
        del x, w, xp, wp
    return rows


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
    from repro_torch.kernels import KERNELS
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
    launches = {k.__name__: k.launches for k in KERNELS}
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
            "paged_flash_decode": cfg.n_layers * d_steps,
            "boolean_weight_bwd": 0,
            "flash_attention_fwd": cfg.n_layers * sum(stats["prefills"].values()),
            "paged_prefix_attention": 0, "boolean_matmul": 0,
            "packed_xnor_matmul": 0}
    print(f"  served {len(handles)} requests in {serve_s:.2f} s: "
          f"{d_steps} decode steps, prefill buckets {dict(stats['prefills'])}")
    print(f"  launches {launches}, expected {want} ({per_layer} GEMV per decode "
          f"step and per prefill of <= 256 rows, {cfg.n_layers} paged decode "
          f"per decode step, {cfg.n_layers} flash prefill per prefill)")
    assert launches == want, (launches, want)
    for name in ("packed_xnor_gemv", "paged_flash_decode", "flash_attention_fwd"):
        assert launches[name] > 0, launches
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
    return engine, launches, metrics


# ---------------------------------------------------------------------------
# prefix-cached traffic (phases 4 and 7)
# ---------------------------------------------------------------------------
def prefix_traffic(torch, engine, prompts, repeats, n_tok, *, lanes, page,
                   segment):
    """Request 0 alone (cold), then requests 1.. together (partial hits on
    the shared system prompt), then, once they are done, repeats of the
    prompts ``repeats`` (exact hits, or partial hits where no exact record
    exists). The launch counters are zeroed just before and read after the
    drain, and around the repeats' admission round. Returns the streams,
    each request's admission kind, TTFT by kind (the session's own
    submit-to-first-token stamps), decode step times, session stats and
    launch counts; the pages must be conserved after the drain."""
    from repro_torch.kernels import KERNELS
    from repro_torch.serve import SamplingParams

    cuda = engine.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for k in KERNELS:
        k.launches = 0
    sess = engine.session(lanes=lanes, page_size=page, segment=segment,
                          prefix_cache=True)
    handles, kinds, step_ms = [], {}, []

    def submit(i):
        handles.append(sess.submit(prompts[i], SamplingParams(max_tokens=n_tok)))

    def note_kinds():
        for h in handles:
            if h.rid not in kinds and h.tokens_ready:
                hit = h._req.hit
                kinds[h.rid] = ("cold" if hit is None else
                                "exact" if hit.exact else "partial")

    def drain():
        while True:
            sync()
            t = time.perf_counter()
            steps0 = sess.stats["decode_steps"]
            if not sess.step():
                return
            sync()
            if sess.stats["decode_steps"] > steps0:
                step_ms.append((time.perf_counter() - t) * 1e3 / segment)
            note_kinds()

    submit(0)
    drain()
    for i in range(1, len(prompts)):
        submit(i)
    drain()
    before = {k.__name__: k.launches for k in KERNELS}
    for i in repeats:
        submit(i)
    sess.step()                                  # the repeats' admission
    sync()
    repeat_round = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
    note_kinds()
    drain()
    launches = {k.__name__: k.launches for k in KERNELS}
    alloc = sess.sched.alloc                     # page conservation
    assert alloc.refs[0] == 1 and all(alloc.refs[p] == 0 for p in alloc.free_pages)
    assert not sess.sched.active
    assert sess.prefix.owned_pages + alloc.n_free == alloc.n_pages - 1
    audit = sess.audit()
    stats = {"decode_steps": sess.stats["decode_steps"],
             "prefills": sum(sess.stats["prefills"].values()),
             "tail_prefills": sum(sess.stats["tail_prefills"].values()),
             "buckets": {str(b): c for b, c in (sess.stats["prefills"]
                                                + sess.stats["tail_prefills"])
                         .items()},
             "exact_admits": sess.stats["exact_admits"],
             "prefix": dict(sess.prefix.stats)}
    sess.close()
    ttft, admit = {}, {}
    for h in handles:
        ttft.setdefault(kinds[h.rid], []).append(h.ttft_ms)
        admit.setdefault(kinds[h.rid], []).append(h.admit_ms)
    return {"streams": [h.tokens_so_far() for h in handles],
            "kinds": [kinds[h.rid] for h in handles], "ttft_ms": ttft,
            "admit_ms": admit,
            "step_ms": step_ms, "stats": stats, "launches": launches,
            "repeat_round_launches": repeat_round, "audit": audit}


def expected_kinds(n, repeats, quant):
    """Request 0 cold, the rest of the first n partial; a repeat is exact
    where its prompt left an exact record — every prompt on a bf16 pool,
    only the cold one under kv-quant (a kv-quant tail prefill never seeds
    a record)."""
    return (["cold"] + ["partial"] * (n - 1)
            + ["exact" if (i == 0 or not quant) else "partial" for i in repeats])


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

    # prefix-cached traffic, scaled down: a 32-token system prompt, 6 tails
    system = rng.integers(0, cfg.vocab_size, (32,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
             for n in (5, 17, 9, 30, 12, 3)]
    pfx_prompts = [np.concatenate([system, t]) for t in tails]
    repeats = (0, 2, 4)
    pfx = {}
    for quant in (False, True):
        qcfg = cfg.scaled(kv_cache_quant=quant)
        res = [prefix_traffic(torch, ServeEngine(qcfg, params, max_len=128,
                                                 packed=True, device=d),
                              pfx_prompts, repeats, 8, lanes=4, page=16,
                              segment=4)
               for d in ("cuda", "cpu")]
        label = "kv-quant" if quant else "bf16-layout fp32"
        want = expected_kinds(len(pfx_prompts), repeats, quant)
        assert res[0]["kinds"] == res[1]["kinds"] == want, \
            (res[0]["kinds"], res[1]["kinds"], want)
        n_same = sum(a == b for a, b in zip(res[0]["streams"],
                                            res[1]["streams"]))
        print(f"  smoke prefix traffic ({label}): kinds {res[0]['kinds']}; "
              f"streams identical card vs CPU {n_same}/{len(want)}")
        assert res[0]["streams"] == res[1]["streams"], \
            (res[0]["streams"], res[1]["streams"])
        assert res[0]["stats"]["prefix"] == res[1]["stats"]["prefix"]
        pfx["kv_quant" if quant else "fp32_pool"] = n_same
    return {"smoke_logits_max_abs_err": err, "smoke_streams_identical": same,
            "smoke_prefix_streams_identical": pfx}


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
    boolean_weight_bwd.tc_launches = boolean_weight_bwd.cc_launches = 0
    step_ms = [one_step() for _ in range(TIMED_STEPS)]
    launches = {k.__name__: k.launches for k in KERNELS}
    routes = {"tensor_cores": boolean_weight_bwd.tc_launches,
              "cuda_cores": boolean_weight_bwd.cc_launches}
    per_mb = 7 * cfg.n_layers
    want = {"packed_xnor_gemv": 0, "paged_flash_decode": 0,
            "boolean_weight_bwd": TIMED_STEPS * TRAIN_MICRO * per_mb,
            "flash_attention_fwd": 0, "paged_prefix_attention": 0,
            "boolean_matmul": 0, "packed_xnor_matmul": 0}
    peak = torch.cuda.max_memory_allocated()
    print(f"  launches over the {TIMED_STEPS} timed steps {launches}, expected "
          f"{want} ({per_mb} weight-backward launches a microbatch)")
    assert launches == want, (launches, want)
    assert boolean_weight_bwd.launches > 0
    print(f"  weight-backward launches by route {routes}")
    assert routes == {"tensor_cores": want["boolean_weight_bwd"],
                      "cuda_cores": 0}, routes

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
        "weight_bwd_routes": routes,
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


# ---------------------------------------------------------------------------
# 7. prefix-cached serving of gemma2-2b at published widths
# ---------------------------------------------------------------------------
PFX_SYSTEM, PFX_REQUESTS, PFX_TOKENS, PFX_REPEATS = 512, 16, 32, (0, 3, 7, 12)


def _margin(logits_row) -> float:
    """Top-1 minus top-2 logit."""
    top = logits_row.float().topk(2).values.tolist()
    return top[0] - top[1]


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@contextlib.contextmanager
def first_call(owner, name: str):
    """Keep the arguments and output of the first call of ``owner.name``
    while the block runs; the call itself is unchanged."""
    fn = getattr(owner, name)
    seen = {}

    def keep(*args, **kw):
        out = fn(*args, **kw)
        seen.setdefault("call", (args, kw, out))
        return out

    setattr(owner, name, keep)
    try:
        yield seen
    finally:
        setattr(owner, name, fn)


def tail_route_check(torch, eng, prompt, hit: int, page: int):
    """The first layer of a partial hit's tail prefill against the cold
    prefill of its full prompt at the same positions, both through
    ``ServeEngine.prefill_commit`` as the session calls it: the K/V rows
    each commits to the pool and, over a bf16 pool, the attention output.
    Only the projections' summation order (the GEMV at <= 256 rows, the
    unpacked matmul above) and the attention's p (fp32 in the flash kernel,
    bf16 in the prefix kernel) differ, so every element must agree within
    bf16 roundings; a wrong offset, page, prefix length or mask in the tail
    route moves whole rows. Under kv-quant the tail attends over the prefix
    rows dequantised from the pool, so the cold attention is recomputed over
    those same rows (its own rows from the tail on). Returns the readings;
    fails past a tolerance."""
    import numpy as np
    import repro_torch.models.attention as A
    import repro_torch.models.lm as LM
    from repro_torch.kernels.paged_attention import gather_prefix_rows
    from repro_torch.serve import paged_pool_init

    cfg = eng.cfg
    assert hit % page == 0 and hit < len(prompt)
    S, T = len(prompt), len(prompt) - hit
    n_cold, n_tail = -(-S // page), -(-T // page)
    pool = paged_pool_init(cfg, 1 + n_cold + n_tail, page, eng.device)
    cold_ids = np.zeros((_pow2(S) // page,), np.int32)
    cold_ids[:n_cold] = np.arange(1, 1 + n_cold)
    tail_ids = np.zeros((_pow2(T) // page,), np.int32)
    tail_ids[:n_tail] = np.arange(1 + n_cold, 1 + n_cold + n_tail)
    prefix_ids = np.zeros((_pow2(hit // page),), np.int32)
    prefix_ids[:hit // page] = cold_ids[:hit // page]
    padded = np.zeros((_pow2(S),), np.int32)
    padded[:S] = prompt
    with first_call(LM, "flash_attention_fwd") as cold:
        eng.prefill_commit(pool, padded, S, cold_ids, page)
    padded = np.zeros((_pow2(T),), np.int32)
    padded[:T] = prompt[hit:]
    with first_call(A, "flash_prefix_attention_paged") as tail:
        eng.prefill_commit(pool, padded, T, tail_ids, page, offset=hit,
                           prefix_ids=prefix_ids)

    KV, quant = cfg.kv_heads_padded(), cfg.kv_cache_quant

    def rows(name, ids, lo, hi, block="b0", group=0):
        """Committed rows lo..hi of pages ``ids`` of one layer, fp32."""
        blk = pool[block]
        idx = torch.from_numpy(ids).to(eng.device)
        scale = blk[f"{name}_scale"][group] if quant else None
        r = gather_prefix_rows(blk[name][group], idx, scale)[lo:hi]
        step = 0.0
        if quant:                       # one int8 step of each row
            step = scale.index_select(0, idx.long()).reshape(-1, KV)[lo:hi,
                                                                     :, None]
        return r, step

    def compare(a, b, tol):
        diff = (a - b).abs()
        return {"max_abs_err": diff.max().item(),
                "max_err_over_tol": (diff / tol).max().item(),
                "share_not_equal": (diff > 0).float().mean().item()}

    out = {}
    for name in ("k", "v"):
        a, step_a = rows(name, tail_ids[:n_tail], 0, T)   # the tail's commit
        b, step_b = rows(name, cold_ids[:n_cold], hit, S)  # cold rows there
        # a last-bit difference of a projection sum, carried through RoPE
        # (which mixes each pair d, d + hd/2) and the bf16 rounding; under
        # kv-quant it may move a code by one step of the row's scale
        mag = torch.maximum(a.abs(), b.abs())
        if name == "k":
            mag = mag + mag.roll(cfg.head_dim_ // 2, dims=-1)
        tol = 2.0 ** -6 * mag + 1e-6
        if quant:
            tol = tol + torch.maximum(step_a, step_b)
        out[name] = compare(a, b, tol)
    (qc, kc, vc), kw, out_c = cold["call"]
    if quant:       # the cold prefill over the prefix rows the tail reads
        kc, vc = kc.clone(), vc.clone()
        for name, x in (("k", kc), ("v", vc)):
            r, _ = rows(name, cold_ids[:n_cold], 0, hit)
            x[:, :hit] = r.transpose(0, 1).to(x.dtype)
        out_c = LM.flash_attention_fwd(qc, kc, vc, **kw)
    absv = LM.flash_attention_fwd(qc, kc, vc.abs(), **kw)
    hp, hd = cfg.heads_padded(), cfg.head_dim_
    b, absv = (x.reshape(hp, -1, hd)[:, hit:S].float() for x in (out_c, absv))
    a = tail["call"][2][0, :T].transpose(0, 1).float()
    # p one bf16 rounding apart and the scores moved by the projections'
    # last bits: 2^-7 of sum p|v| / l; then both outputs rounded to bf16,
    # each by up to 2^-8 of the value
    tol = 2.0 ** -7 * (absv + torch.maximum(a.abs(), b.abs())) + 1e-6
    out["attention"] = compare(a, b, tol)
    # not checked, read: how the difference grows through the layers (the
    # relative L2 difference of each layer's committed K rows)
    drift = []
    for g in range(cfg.n_groups):
        for i in range(len(pool)):
            a = rows("k", tail_ids[:n_tail], 0, T, f"b{i}", g)[0]
            b = rows("k", cold_ids[:n_cold], hit, S, f"b{i}", g)[0]
            drift.append((torch.linalg.vector_norm(a - b)
                          / torch.linalg.vector_norm(b)).item())
    for what, r in out.items():
        print(f"    layer-0 {what} of the {T}-row tail at offset {hit} vs the "
              f"cold prefill: max_abs_err {r['max_abs_err']:.3g}, max err/tol "
              f"{r['max_err_over_tol']:.3g}, share not bit-equal "
              f"{r['share_not_equal']:.3g}")
    print("    relative difference of the committed K rows by layer: "
          + " ".join(f"{d:.2g}" for d in drift))
    bad = {w: r for w, r in out.items() if not r["max_err_over_tol"] <= 1.0}
    assert not bad, f"tail route disagrees with the cold prefill: {bad}"
    return dict(out, k_rows_relative_difference_by_layer=drift)


def serve_prefix(torch, engine, seed: int):
    import numpy as np
    from repro_torch.models import lm_prefill
    from repro_torch.serve import SamplingParams, ServeEngine

    cfg = engine.cfg
    V = cfg.vocab_size
    rng = np.random.default_rng(seed + 7)
    system = rng.integers(0, V, (PFX_SYSTEM,)).astype(np.int32)
    tail_lens = rng.integers(16, 257, (PFX_REQUESTS,))
    prompts = [np.concatenate([system, rng.integers(0, V, (n,)).astype(np.int32)])
               for n in tail_lens]
    out = {}
    for quant in (False, True):
        label = "kv-quant" if quant else "bf16"
        eng = engine if not quant else ServeEngine(
            cfg.scaled(kv_cache_quant=True), engine.params, max_len=1024,
            packed=True)
        gc_collect(torch)
        torch.cuda.reset_peak_memory_stats()
        res = prefix_traffic(torch, eng, prompts, PFX_REPEATS, PFX_TOKENS,
                             lanes=8, page=16, segment=8)
        peak = torch.cuda.max_memory_allocated()
        st, launches = res["stats"], res["launches"]
        want_kinds = expected_kinds(PFX_REQUESTS, PFX_REPEATS, quant)
        assert res["kinds"] == want_kinds, (res["kinds"], want_kinds)
        n_exact = want_kinds.count("exact")
        n_partial = want_kinds.count("partial")
        pstats = st["prefix"]
        assert (pstats["exact_hits"], pstats["partial_hits"], pstats["misses"]) \
            == (n_exact, n_partial, 1), pstats
        assert (st["exact_admits"], st["prefills"], st["tail_prefills"]) \
            == (n_exact, 1, n_partial), st
        L = cfg.n_layers
        # the projections of a prefill of <= 256 rows take the GEMV
        gemv_prefills = sum(c for b, c in st["buckets"].items() if int(b) <= 256)
        want = {"packed_xnor_gemv": 4 * L * (st["decode_steps"] + gemv_prefills),
                "paged_flash_decode": L * st["decode_steps"],
                "boolean_weight_bwd": 0,
                "flash_attention_fwd": L * st["prefills"],
                "paged_prefix_attention": L * st["tail_prefills"],
                "boolean_matmul": 0, "packed_xnor_matmul": 0}
        print(f"  {label}: kinds {dict((k, want_kinds.count(k)) for k in ('cold', 'partial', 'exact'))}, "
              f"prefix stats {pstats}")
        print(f"  {label}: launches {launches}, expected {want}")
        assert launches == want, (launches, want)
        for name in ("paged_flash_decode", "flash_attention_fwd",
                     "paged_prefix_attention"):
            assert launches[name] > 0, launches
        rr = res["repeat_round_launches"]
        n_rep_partial = sum(k == "partial" for k in want_kinds[PFX_REQUESTS:])
        assert rr["flash_attention_fwd"] == 0 and \
            rr["paged_prefix_attention"] == L * n_rep_partial, rr
        streams = res["streams"]
        exact_same = []
        for j, i in enumerate(PFX_REPEATS):
            s_rep = streams[PFX_REQUESTS + j]
            if want_kinds[PFX_REQUESTS + j] == "exact":
                assert s_rep == streams[i], (label, i, s_rep, streams[i])
                exact_same.append(i)
        print(f"  {label}: exact-hit streams bit-identical to the streams that "
              f"seeded their records: prompts {exact_same}")

        # each partial-hit stream against a cold run of its full prompt
        cold = eng.generate_batch(prompts, PFX_TOKENS, lanes=8, page_size=16,
                                  segment=8, prefix_cache=False)
        agree, diverged = [], []
        for i in range(1, PFX_REQUESTS):
            a, b = streams[i], cold[i].tolist()
            n = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), len(b))
            agree.append(n)
            if n < len(b):
                ctx = np.concatenate([prompts[i], np.asarray(b[:n], np.int32)])
                lg, _ = lm_prefill(cfg, eng.params, {"tokens": torch.from_numpy(
                    ctx[None]).to(eng.device)})
                m = _margin(lg[0, -1, :V])
                diverged.append({"request": i, "step": n, "cold_margin": m})
                print(f"    request {i}: partial hit diverges from the cold run "
                      f"at step {n}, cold top-2 logit margin {m:.4f}")
        print(f"  {label}: partial-hit tokens agreeing with a cold run before "
              f"the first divergence: {agree} (of {PFX_TOKENS} each)")
        for d in diverged:
            assert d["cold_margin"] <= 1.0, (label, d)
        # the longest tail: its bucket takes the GEMV, the cold one does not
        i = max(range(1, PFX_REQUESTS), key=lambda j: len(prompts[j]))
        route = tail_route_check(torch, eng, prompts[i], PFX_SYSTEM, 16)

        ttft = {k: statistics.median(v) for k, v in res["ttft_ms"].items()}
        admit = {k: statistics.median(v) for k, v in res["admit_ms"].items()}
        step = statistics.median(res["step_ms"])
        print(f"  {label}: TTFT median (admission work alone) cold "
              f"{ttft['cold']:.1f} ({admit['cold']:.1f}) ms, partial "
              f"{ttft['partial']:.1f} ({admit['partial']:.1f}) ms, exact "
              f"{ttft['exact']:.1f} ({admit['exact']:.1f}) ms; decode step "
              f"median {step:.2f} ms; max_memory_allocated "
              f"{peak / 2**30:.2f} GiB")
        out[label] = {"kinds": want_kinds, "stats": st, "launches": launches,
                      "repeat_round_launches": rr, "ttft_ms_median": ttft,
                      "admit_ms_median": admit, "ttft_ms": res["ttft_ms"],
                      "admit_ms": res["admit_ms"], "step_ms_median": step,
                      "max_memory_allocated_bytes": peak,
                      "partial_agreement": agree, "divergences": diverged,
                      "tail_route": route,
                      "exact_identical": exact_same, "audit": res["audit"]}
        if quant:
            del eng
    return out


# ---------------------------------------------------------------------------
# 8. Boolean VGG-SMALL and SMALL-EDSR at published widths
# ---------------------------------------------------------------------------
VGG_BATCH, VGG_BATCHES, VGG_TRAIN_STEPS = 100, 10, 3
EDSR_BLOCKS, EDSR_WIDTH, EDSR_SCALE, EDSR_BATCH, EDSR_HW = 8, 64, 2, 4, 128
LEAF_FORMS = ("float", "int8", "packed")


@contextlib.contextmanager
def plain_kernels():
    """While the block runs, the inference convs call the two GEMM kernels'
    plain versions (on the card) instead of their wrappers, whose counters
    therefore do not move."""
    import repro_torch.core.boolean_conv as BC
    from repro_torch.kernels import boolean_matmul_plain, packed_xnor_matmul_plain

    saved = BC.boolean_matmul, BC.packed_xnor_matmul
    BC.boolean_matmul = boolean_matmul_plain
    BC.packed_xnor_matmul = packed_xnor_matmul_plain
    try:
        yield
    finally:
        BC.boolean_matmul, BC.packed_xnor_matmul = saved


def leaf_form(torch, w, form):
    """A Boolean leaf as a float ±1 view, int8, or PackedBool."""
    from repro_torch.core import pack_boolean_weight

    if form == "float":
        return w.to(torch.float32)
    return w if form == "int8" else pack_boolean_weight(w)


def vgg_leaves(torch, params, form):
    return {k: ({c: {**l, "w": leaf_form(torch, l["w"], form)}
                 for c, l in v.items()} if k.startswith("s") else v)
            for k, v in params.items()}


def counted(torch, fn, want_kernel, n_launches):
    """Run ``fn`` with the launch counters zeroed just before and read just
    after; every kernel but ``want_kernel`` must stay at 0 and that one must
    reach ``n_launches``. Returns (result, launches, seconds)."""
    from repro_torch.kernels import KERNELS

    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {k.__name__: k.launches for k in KERNELS}
    want = {k.__name__: 0 for k in KERNELS}
    if want_kernel is not None:
        want[want_kernel] = n_launches
    assert launches == want, (launches, want)
    return out, launches, dt


def vgg_routes(torch, cfg, params, batches, label):
    """Each leaf form over the batches (launches counted, images/s); the
    kernel routes against the plain route and each other; the float route's
    differences counted."""
    from repro_torch.vision import vgg_forward

    n_pm1 = sum(n for _, n in cfg.stages) - 2      # ±1-input Boolean convs
    kernel_of = {"float": None, "int8": "boolean_matmul",
                 "packed": "packed_xnor_matmul"}
    runs, out = {}, {"images": len(batches) * batches[0].shape[0]}
    with torch.no_grad():
        for form in LEAF_FORMS:
            p = vgg_leaves(torch, params, form)
            vgg_forward(p, cfg, batches[0])                  # warm-up
            res, launches, dt = counted(
                torch, lambda: [vgg_forward(p, cfg, x) for x in batches],
                kernel_of[form], n_pm1 * len(batches))
            runs[form] = res
            out[form] = {"launches": launches, "seconds": dt,
                         "images_per_s": out["images"] / dt}
            if form != "float":
                with plain_kernels():
                    plain = [vgg_forward(p, cfg, x) for x in batches]
                torch.cuda.synchronize()
                for (lg, acts), (lg_p, acts_p) in zip(res, plain):
                    assert all(torch.equal(a, b) for a, b in zip(acts, acts_p)), \
                        f"{label} {form}: ±1 activations differ from the plain route"
                    assert torch.equal(lg.argmax(-1), lg_p.argmax(-1))
                out[form]["logits_max_abs_diff_vs_plain"] = max(
                    (lg - lg_p).abs().max().item()
                    for (lg, _), (lg_p, _) in zip(res, plain))
    n_acts = n_pm1 + 1
    for (lg8, a8), (lgp, ap) in zip(runs["int8"], runs["packed"]):
        assert len(a8) == len(ap) == n_acts
        assert all(torch.equal(a, b) for a, b in zip(a8, ap)), \
            f"{label}: int8 and packed routes' ±1 activations differ"
        assert torch.equal(lg8.argmax(-1), lgp.argmax(-1))
        assert tuple(lg8.shape) == (batches[0].shape[0], cfg.n_classes)
        assert bool(torch.isfinite(lg8).all())
    diff = [0] * n_acts
    pred_diff, logit_diff = 0, 0.0
    for (lgf, af), (lg8, a8) in zip(runs["float"], runs["int8"]):
        for i, (a, b) in enumerate(zip(af, a8)):
            diff[i] += int((a.to(torch.int8) != b).sum())
        pred_diff += int((lgf.argmax(-1) != lg8.argmax(-1)).sum())
        logit_diff = max(logit_diff, (lgf - lg8).abs().max().item())
    total = [sum(a[i].numel() for _, a in runs["int8"]) for i in range(n_acts)]
    out["float_route"] = {"differing_activations_by_layer": diff,
                          "activations_by_layer": total,
                          "differing_predictions": pred_diff,
                          "logits_max_abs_diff_vs_int8": logit_diff}
    print(f"  {label}: kernel routes' ±1 activations identical to the plain "
          f"route and to each other in all {n_acts} Boolean layers of "
          f"{len(batches)} batches; predictions identical")
    print(f"  {label}: float route (cuDNN fp32) differs from the int8 route in "
          f"{diff} of {total} activations by layer, {pred_diff} of "
          f"{out['images']} predictions, logits by up to {logit_diff:.3g}")
    for form in LEAF_FORMS:
        r = out[form]
        print(f"  {label} {form}: {r['images_per_s']:.0f} images/s "
              f"({r['seconds'] * 1e3 / len(batches):.2f} ms a batch of "
              f"{batches[0].shape[0]}), launches {r['launches']}")
    return out


def vision(torch, seed: int):
    from repro_torch.configs import get_config
    from repro_torch.core.optimizer import adam, boolean_optimizer, tree_leaves
    from repro_torch.examples import finetune_boolean_cnn as example
    from repro_torch.vision import edsr_apply, edsr_init, vgg_init

    gc_collect(torch)
    cfg = get_config("bold-vgg-small")
    print(f"  VGG-SMALL stages {cfg.stages}, fc {cfg.fc_dim}, "
          f"{cfg.input_hw}x{cfg.input_hw}x{cfg.in_channels}, {cfg.n_classes} "
          f"classes; {VGG_BATCHES} batches of {VGG_BATCH}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    xs, ys = example.synthetic_task(gen, VGG_BATCH * VGG_BATCHES,
                                    cfg.input_hw, cfg.n_classes)
    batches, labels = list(xs.split(VGG_BATCH)), list(ys.split(VGG_BATCH))
    out = {}
    for bn in (False, True):
        c = cfg.scaled(with_bn=bn)
        params = vgg_init(c, torch.Generator(device="cuda").manual_seed(seed))
        out["vgg_bn" if bn else "vgg"] = vgg_routes(
            torch, c, params, batches, "VGG-SMALL" + (" with BN" if bn else ""))

    # training: the example's step (flip rule + Adam) at batch 100
    gc_collect(torch)
    params = vgg_init(cfg, torch.Generator(device="cuda").manual_seed(seed))
    bool_t, fp_t = example.split_params(params)
    bopt, fopt = boolean_optimizer(6.0), adam(2e-3)
    bstate, fstate = bopt.init(bool_t), fopt.init(fp_t)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(VGG_TRAIN_STEPS):
        j = i % len(batches)
        (loss, acc, _), launches, dt = counted(torch, lambda: example.train_step(
            cfg, bopt, fopt, bool_t, fp_t, bstate, fstate, batches[j],
            labels[j]), None, 0)
        steps.append({"ms": dt * 1e3, "loss": float(loss), "acc": float(acc),
                      "flips": sum(float(f) for f in tree_leaves(bstate.flips))})
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(s["loss"]) for s in steps), steps
    assert all(bool(((w == 1) | (w == -1)).all()) for w in tree_leaves(bool_t))
    out["vgg_train"] = {"steps": steps, "max_memory_allocated_bytes": peak}
    print("  VGG-SMALL training (example step, flip rule + Adam, batch "
          f"{VGG_BATCH}): " + ", ".join(
              f"{s['ms']:.1f} ms loss {s['loss']:.4f} flips {s['flips']:.0f}"
              for s in steps) + f"; max_memory_allocated {peak / 2**30:.2f} GiB")

    # SMALL-EDSR through the int8 and packed routes
    gc_collect(torch)
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    params = edsr_init(gen, EDSR_BLOCKS, EDSR_WIDTH, EDSR_SCALE)
    x = torch.rand((EDSR_BATCH, EDSR_HW, EDSR_HW, 3), generator=gen,
                   device="cuda")

    def blocks(form):
        return {k: ({j: leaf_form(torch, w, form) for j, w in v.items()}
                    if k.startswith("b") else v) for k, v in params.items()}

    kernel_of = {"float": None, "int8": "boolean_matmul",
                 "packed": "packed_xnor_matmul"}
    edsr, ys_ = {}, {}
    with torch.no_grad():
        for form in LEAF_FORMS:
            p = blocks(form)
            edsr_apply(p, x, EDSR_BLOCKS, EDSR_SCALE)               # warm-up
            y, launches, dt = counted(
                torch, lambda: edsr_apply(p, x, EDSR_BLOCKS, EDSR_SCALE),
                kernel_of[form], EDSR_BLOCKS)
            assert tuple(y.shape) == (EDSR_BATCH, EDSR_HW * EDSR_SCALE,
                                      EDSR_HW * EDSR_SCALE, 3), y.shape
            assert bool(torch.isfinite(y).all())
            ys_[form] = y
            edsr[form] = {"launches": launches, "ms": dt * 1e3,
                          "images_per_s": EDSR_BATCH / dt}
            if form != "float":
                with plain_kernels():
                    y_plain = edsr_apply(p, x, EDSR_BLOCKS, EDSR_SCALE)
                assert torch.equal(y, y_plain), f"EDSR {form}: differs from plain"
    assert torch.equal(ys_["int8"], ys_["packed"])
    edsr["float_route_max_abs_diff_vs_int8"] = \
        (ys_["float"] - ys_["int8"]).abs().max().item()
    out["edsr"] = edsr
    print(f"  SMALL-EDSR ({EDSR_BLOCKS} blocks, width {EDSR_WIDTH}, x{EDSR_SCALE}) "
          f"on {EDSR_BATCH} x {EDSR_HW}x{EDSR_HW}: int8 and packed routes "
          f"identical to the plain route and to each other; float route within "
          f"{edsr['float_route_max_abs_diff_vs_int8']:.3g}")
    for form in LEAF_FORMS:
        r = edsr[form]
        print(f"  SMALL-EDSR {form}: {r['ms']:.2f} ms a forward "
              f"({r['images_per_s']:.1f} images/s), launches {r['launches']}")
    return out


def ring_kernels(build):
    """ptxas's registers and spills for each instance of the wgmma + TMA
    skeleton (csrc/hopper_gemm.cuh's ring_kernel), by policy <BN, STAGES,
    BLOCKS[, FUSE]>, with the dynamic shared memory its ring takes, which
    ptxas does not see: STAGES x (a 16 KB box set of the A operand + BN
    rows of 128 bytes of the B operand), 1 KB of alignment slack and the
    barriers."""
    import re
    out = {}
    for name in ("boolean_weight_bwd", "boolean_matmul"):
        label = None
        for line in build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\S*ring_kernel\S*)'", line)
            if m:
                k = re.search(r"(weight_bwd_tc|boolean_matmul_tc)I((?:L[a-z]+\d+E)+)",
                              m.group(1))
                args = [int(a) for a in re.findall(r"L[a-z]+(\d+)E", k.group(2))]
                label = f"{k.group(1)}<{','.join(map(str, args))}>"
                bn, stages = args[:2]
                out[label] = {"smem_bytes": 1024 + stages * (16384 + 128 * bn + 16)}
            elif "Compiling entry function" in line:
                label = None
            elif label and ("registers" in line or "spill" in line):
                out[label]["ptxas"] = (out[label].get("ptxas", "") + " "
                                       + line.split("info    :")[-1].strip()).strip()
    return out


def gc_collect(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


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
    ring = ring_kernels(build)
    for label, info in ring.items():
        print(f"  wgmma kernel {label}: {info}")

    print("2. kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gemv_rows, gemv_err = check_gemv(torch, flush, gen)
    dec_rows, dec_err = check_paged_decode(torch, flush, gen,
                                           get_config("gemma2-2b"))
    flash_rows, flash_err = check_flash(torch, flush, gen, get_config("gemma2-2b"))
    pfx_rows, pfx_err = check_prefix(torch, flush, gen, get_config("gemma2-2b"))
    wbwd_rows, wbwd_err = check_weight_bwd(torch, flush, gen)
    gemm_rows = check_bool_gemm(torch, flush, gen)
    del flush

    print("3. serve gemma2-2b (published widths) through the packed session")
    engine, launches, metrics = serve(torch, args.seed)

    print("4. small fp32 model: card kernels vs CPU plain versions")
    metrics.update(agree_with_cpu(torch, args.seed))

    print("5. train gemma2-2b (published widths) through make_train_step + TrainLoop")
    train_launches, train_metrics = train(torch, args.seed)

    print("6. small fp32 model training: card kernels vs CPU plain versions")
    train_metrics.update(train_agree_with_cpu(torch, args.seed))

    print("7. prefix-cached serving of gemma2-2b (published widths), bf16 and "
          "int8 KV pools")
    prefix_metrics = serve_prefix(torch, engine, args.seed)
    del engine

    print("8. Boolean VGG-SMALL and SMALL-EDSR (published widths): float, int8 "
          "and packed Boolean leaves")
    vision_metrics = vision(torch, args.seed)

    decode_m8 = [r for r in gemv_rows if r["M"] == 8]
    layer_votes = [r for r in wbwd_rows if r["alpha"] == 0.0
                   and r["x_dtype"] == "torch.bfloat16"
                   and r["proj"] in {name for name, _, _ in WBWD_SHAPES}]
    assert len(layer_votes) == len(WBWD_SHAPES)
    local = next(r for r in dec_rows if r["layer"] == "local"
                 and r["pool"] == "bf16")
    local8 = next(r for r in dec_rows if r["layer"] == "local"
                  and r["pool"] == "int8")
    flash = next(r for r in flash_rows if (r["case"], r["S"], r["dtype"])
                 == ("local", 1024, "bf16"))
    pfx = next(r for r in pfx_rows if (r["pool"], r["T"], r["prefix_rows"])
               == ("bf16", 256, PREFIX_ROWS))
    pfx8 = next(r for r in pfx_rows if (r["pool"], r["T"], r["prefix_rows"])
                == ("int8", 256, PREFIX_ROWS))
    p7 = prefix_metrics["bf16"]["launches"]

    def gemm_row(kernel, name):
        """One forward's four VGG ±1 GEMMs, summed, from phase 2; launches
        summed over phase 8's counted runs (VGG without and with BN, EDSR)."""
        rs = [r for r in gemm_rows if r["kernel"] == kernel
              and r["shape"] in {g[0] for g in VGG_GEMMS}]
        runs = [vision_metrics[v][f]["launches"][name]
                for v in ("vgg", "vgg_bn") for f in LEAF_FORMS]
        runs += [vision_metrics["edsr"][f]["launches"][name] for f in LEAF_FORMS]
        lib = [r["library_ms"] for r in rs]
        return {"launches": sum(runs),
                "max_abs_err": max(r["max_abs_err"] for r in gemm_rows
                                   if r["kernel"].startswith(name)),
                "ms": sum(r["ms"] for r in rs),
                "plain_ms": sum(r["plain_ms"] for r in rs),
                "bound_ms": sum(r["bound_ms"] for r in rs),
                "bound_by": ("bytes" if sum(r["bound_by"] == "bytes" for r in rs)
                             * 2 >= len(rs) else "operations"),
                "library_ms": None if None in lib else sum(lib)}

    fused = [r for r in gemm_rows if r["kernel"] == "boolean_matmul fused"
             and r["shape"] in {g[0] for g in VGG_GEMMS}]
    packed_rows = [r for r in gemm_rows if r["kernel"] == "packed_xnor_matmul"
                   and r["shape"] in {g[0] for g in VGG_GEMMS}]
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
         "int8_ms": local8["ms"], "int8_plain_ms": local8["plain_ms"],
         "int8_bound_ms": local8["bound_ms"],
         "shape": f"{local['L']} lanes, {local['KV']} KV heads x {local['R']} "
                  f"q heads, head_dim {local['hd']}, bf16 pool (int8_*: int8 "
                  f"pool + fp32 scales), {local['live_rows']} live rows, "
                  f"window {local['window']}"},
        {"name": "boolean_weight_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/boolean_weight_bwd.cu",
         "replaces": "src/repro/kernels/boolean_bwd.py:52",
         "launches": train_launches["boolean_weight_bwd"],
         "tc_launches": train_metrics["weight_bwd_routes"]["tensor_cores"],
         "max_abs_err": wbwd_err,
         "ms": sum(r["ms"] for r in layer_votes),
         "plain_ms": sum(r["plain_ms"] for r in layer_votes),
         "bound_ms": sum(r["bound_ms"] for r in layer_votes),
         "bound_by": ("bytes" if sum(r["bound_by"] == "bytes" for r in layer_votes)
                      * 2 >= len(layer_votes) else "operations"),
         "library_ms": sum(r["library_ms"] for r in layer_votes),
         "shape": f"sum over one layer's wq, wk, wv, wo, wg, wu, wd votes at "
                  f"B={WBWD_TOKENS} tokens (one microbatch), bf16 x and z, "
                  "alpha=0 (the tensor-core route; tc_launches: its launches "
                  "in phase 5)"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:87",
         "launches": p7["flash_attention_fwd"], "max_abs_err": flash_err,
         "ms": flash["ms"], "plain_ms": flash["plain_ms"],
         "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
         "library_ms": None,
         "sdpa_causal_no_softcap_ms": flash["sdpa_causal_no_softcap_ms"],
         "shape": f"one layer's cold prefill: {flash['BH']} q heads over "
                  f"{flash['KV']} KV heads, S={flash['S']}, head_dim "
                  f"{flash['hd']}, bf16, softcap 50, window {flash['window']}; "
                  "launches from phase 7 (bf16 pool)"},
        {"name": "paged_prefix_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_prefix_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:335",
         "launches": p7["paged_prefix_attention"], "max_abs_err": pfx_err,
         "ms": pfx["ms"], "plain_ms": pfx["plain_ms"],
         "bound_ms": pfx["bound_ms"], "bound_by": pfx["bound_by"],
         "library_ms": None,
         "int8_ms": pfx8["ms"], "int8_plain_ms": pfx8["plain_ms"],
         "int8_bound_ms": pfx8["bound_ms"],
         "shape": f"one layer's tail prefill: {pfx['H']} q heads over "
                  f"{pfx['KV']} KV heads, a {pfx['T']}-row tail bucket "
                  f"({pfx['length']} real) over {pfx['prefix_rows']} prefix "
                  "rows in 32 scattered pages, head_dim 256, bf16 pool "
                  "(int8_*: int8 pool + fp32 scales); launches from phase 7 "
                  "(bf16 pool)"},
        {"name": "boolean_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/boolean_matmul.cu",
         "replaces": "src/repro/kernels/boolean_matmul.py:59",
         **gemm_row("boolean_matmul counts", "boolean_matmul"),
         "operands_ms": sum(r["operands_ms"] for r in fused),
         "fused_ms": sum(r["ms"] for r in fused),
         "fused_plain_ms": sum(r["plain_ms"] for r in fused),
         "fused_bound_ms": sum(r["bound_ms"] for r in fused),
         "shape": "sum over one VGG-SMALL forward's four +-1-input convs at "
                  "batch 100 as GEMMs (M x K x N: 25600x1152x256, "
                  "25600x2304x256, 6400x2304x512, 6400x4608x512), int32 counts "
                  "(fused_*: the threshold at tau 0 fused, int8 out); "
                  "ms includes operands_ms, the wrapper's transposed copy of "
                  "w; library_ms: torch._int_mm, the faster of w row-major and "
                  "column-major; launches over phase 8"},
        {"name": "packed_xnor_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/packed_xnor_matmul.cu",
         "replaces": "src/repro/kernels/packed_xnor.py:239",
         **gemm_row("packed_xnor_matmul", "packed_xnor_matmul"),
         "popc_floor_ms": sum(r["popc_floor_ms"] for r in packed_rows),
         "shape": "the same four GEMMs with both operands bit-packed along K; "
                  "library_ms: torch._int_mm on the unpacked int8 operands "
                  "(the faster w layout); "
                  "popc_floor_ms: M*N*Kw population counts at 16 a clock an SM, "
                  "1.98 GHz; launches over phase 8"},
    ]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": device_line, "seed": args.seed,
                               "build_s": secs, "wgmma_kernels": ring,
                               "gemv": gemv_rows,
                               "paged_decode": dec_rows, "weight_bwd": wbwd_rows,
                               "flash_prefill": flash_rows,
                               "paged_prefix": pfx_rows,
                               "bool_gemm": gemm_rows,
                               "serve": metrics, "train": train_metrics,
                               "prefix_serve": prefix_metrics,
                               "vision": vision_metrics,
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
