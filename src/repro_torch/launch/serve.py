"""Serving launcher of the port, with the JAX package's single-device flags.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Continuous batching (a mixed-length request pool over the paged-cache lane
scheduler), a streaming session (requests submitted mid-flight, tokens
printed as decode segments complete) and prefix caching:

    ... --continuous --requests 8 --lanes 4 --gen 16
    ... --stream --requests 8 --lanes 4 --gen 16 [--prefix-cache]

Builds ``lm_init`` on a seeded generator and a ``ServeEngine`` (``--packed``:
bit-packed weights; ``--kv-quant``: int8 KV cache). Without ``--continuous``
or ``--stream`` it serves one fixed batch through ``generate`` (or the
per-token ``generate_eager`` with ``--eager``). ``--device`` defaults to
``cuda`` and raises on a host without a card; ``--device cpu`` runs the
kernels' plain versions. The JAX launcher's overload, fault, gateway, chaos
and mesh flags are accepted and refused: they come with the port's
overload-and-faults, gateway and multi-device slices.
"""
from __future__ import annotations

import argparse
import time

# the JAX launcher's flags of later slices: flag -> the slice that ports it
_LATER = {"audit": "overload and faults", "max_pending": "overload and faults",
          "deadline_ms": "overload and faults",
          "host_pages": "overload and faults (the host swap tier)",
          "chaos_soak": "overload and faults (chaos)",
          "chaos_seed": "overload and faults (chaos)",
          "chaos_rate": "overload and faults (chaos)",
          "http": "gateway", "metrics_tenants": "gateway",
          "watchdog_timeout": "gateway", "host": "gateway",
          "shards": "multi-device"}


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache with per-(token,head) dynamic scales")
    ap.add_argument("--packed", action="store_true",
                    help="bit-packed XNOR weight serving (32 weights/word)")
    ap.add_argument("--eager", action="store_true",
                    help="generate_eager: a fresh cache a call")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: a mixed-length request pool "
                         "through the paged-cache lane scheduler")
    ap.add_argument("--stream", action="store_true",
                    help="streaming session: submit/stream/cancel request "
                         "lifecycle, tokens printed as segments complete")
    ap.add_argument("--requests", type=int, default=8,
                    help="(--continuous/--stream) request pool size")
    ap.add_argument("--lanes", type=int, default=4,
                    help="(--continuous/--stream) fixed decode lane count")
    ap.add_argument("--page-size", type=int, default=16,
                    help="(--continuous/--stream) cache page size in tokens")
    ap.add_argument("--segment", type=int, default=2,
                    help="(--stream) decode steps between scheduling points")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="(--stream) radix-indexed prompt-page sharing: "
                         "requests share a system prompt; cache hits "
                         "prefill only their unique tail")
    ap.add_argument("--device", default="cuda")
    for flag in ("--audit",):
        ap.add_argument(flag, action="store_true", help="a later slice")
    for flag in ("--max-pending", "--host-pages", "--metrics-tenants",
                 "--http", "--chaos-soak", "--chaos-seed", "--shards"):
        ap.add_argument(flag, type=int, default=None, help="a later slice")
    for flag in ("--deadline-ms", "--watchdog-timeout", "--chaos-rate"):
        ap.add_argument(flag, type=float, default=None, help="a later slice")
    ap.add_argument("--host", default=None, help="a later slice")
    return ap


def _prompts(args, vocab: int):
    """The request pool of --continuous/--stream: mixed prompt lengths (with
    --prefix-cache, one shared system prompt and short unique tails),
    mixed token budgets; the JAX launcher's recipe."""
    import numpy as np

    rng = np.random.default_rng(1)
    if args.prefix_cache:
        sys_len = min(max(args.prompt_len * 3 // 4, 1),
                      max(args.prompt_len - 1, 1))
        sys_p = rng.integers(0, vocab, (sys_len,)).astype(np.int32)
        prompts = [np.concatenate([sys_p, rng.integers(
            0, vocab, (int(rng.integers(
                1, max(args.prompt_len - sys_len, 1) + 1)),)).astype(np.int32)]
        )[:args.prompt_len] for _ in range(args.requests)]
    else:
        prompts = [rng.integers(0, vocab, (int(rng.integers(
            4, args.prompt_len + 1)),)).astype(np.int32)
            for _ in range(args.requests)]
    gens = [int(rng.integers(max(args.gen // 2, 1), args.gen + 1))
            for _ in range(args.requests)]
    return prompts, gens


def _stream(engine, args, prompts, gens):
    from repro_torch.serve import SamplingParams

    with engine.session(lanes=args.lanes, page_size=args.page_size,
                        segment=args.segment,
                        prefix_cache=args.prefix_cache) as sess:
        # half up front, the rest one a step, mid-flight
        half = args.requests // 2
        handles = [sess.submit(p, SamplingParams(max_tokens=g))
                   for p, g in zip(prompts[:half], gens[:half])]
        printed = [0] * args.requests
        t0 = time.time()
        ttft = None
        injected = half
        while not sess.idle or injected < args.requests:
            if injected < args.requests:
                handles.append(sess.submit(prompts[injected], SamplingParams(
                    max_tokens=gens[injected])))
                injected += 1
            sess.step()
            for i, h in enumerate(handles):
                if h.tokens_ready > printed[i]:
                    if ttft is None:
                        ttft = time.time() - t0
                    new = h.tokens_so_far()[printed[i]:]
                    print(f"[serve] req{i} +{new} ({h.tokens_ready}/"
                          f"{gens[i]} {h.status.name.lower()})")
                    printed[i] = h.tokens_ready
        dt = time.time() - t0
        total = sum(h.tokens_ready for h in handles)
        if args.prefix_cache:
            st = sess.prefix.stats
            print(f"[serve] prefix cache: {st['exact_hits']} exact + "
                  f"{st['partial_hits']} partial hits / {st['lookups']} "
                  f"lookups, {st['hit_tokens']} prompt tokens served from "
                  f"cache, {st['cow_forks']} CoW forks, "
                  f"{st['evicted_pages']} pages LRU-evicted")
    print(f"[serve] stream: {args.requests} requests over {args.lanes} lanes "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s aggregate, first tokens "
          f"after {ttft:.2f}s)")
    return [h.tokens_so_far() for h in handles]


def main(argv=None):
    args = _parser().parse_args(argv)
    later = [f"--{k.replace('_', '-')}" for k, v in vars(args).items()
             if k in _LATER and v not in (None, False)]
    if later:
        raise SystemExit(
            f"[serve] {', '.join(later)}: not ported yet; they come with the "
            "port's " + ", ".join(sorted({_LATER[f[2:].replace('-', '_')]
                                          for f in later})) + " slice(s)")

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import lm_init
    from repro_torch.serve import ServeEngine, resolve_device

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.frontend == "embeddings":
        print(f"[serve] {args.arch} uses an embeddings frontend stub; "
              "serving decodes tokens after an embedded prompt.")
    cfg = cfg.scaled(kv_cache_quant=args.kv_quant)
    params = lm_init(cfg, torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(cfg, params, max_len=args.prompt_len + args.gen,
                         packed=args.packed, device=device)
    del params

    if args.stream or args.continuous:
        prompts, gens = _prompts(args, cfg.vocab_size)
    if args.stream:
        return _stream(engine, args, prompts, gens)
    if args.continuous:
        t0 = time.time()
        outs = engine.generate_batch(prompts, gens, lanes=args.lanes,
                                     page_size=args.page_size)
        dt = time.time() - t0
        mode = "continuous" + ("+packed" if args.packed else "")
        print(f"[serve] {mode}: {args.requests} mixed-length requests "
              f"(prompts {min(map(len, prompts))}-{max(map(len, prompts))}, "
              f"gens {min(gens)}-{max(gens)}) over {args.lanes} lanes in "
              f"{dt:.2f}s ({sum(gens) / dt:.1f} tok/s aggregate)")
        print("[serve] request 0:", outs[0][:12].tolist())
        return outs

    gen = engine.generate_eager if args.eager else engine.generate
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out = gen(prompts, args.gen)
    dt = time.time() - t0
    mode = ("eager" if args.eager else "generate") \
        + ("+packed" if args.packed else "")
    print(f"[serve] {mode}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s batched)")
    print("[serve] sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
