"""Serving launcher of the port, with the JAX package's flags.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Continuous batching (a mixed-length request pool over the paged-cache lane
scheduler), a streaming session (requests submitted mid-flight, tokens
printed as decode segments complete) and prefix caching:

    ... --continuous --requests 8 --lanes 4 --gen 16
    ... --stream --requests 8 --lanes 4 --gen 16 [--prefix-cache]

Overload control (a bounded queue, deadlines, the post-step invariant
audit, the host swap tier; sheds print with their typed reason, the audit
and swap counters at drain; ``REPRO_FAULTS=site@idx,...`` in the
environment arms fault injection) and chaos soaks (N seeded random fault
schedules run to drain against fresh sessions; a failing seed replays with
``--chaos-soak 1 --chaos-seed SEED``):

    ... --stream --requests 8 --lanes 4 --gen 16 \
        --max-pending 4 --deadline-ms 5000 --audit [--host-pages 32]
    ... --chaos-soak 25 --requests 6 --lanes 2 --gen 8 [--chaos-rate 0.1]

Serving over HTTP (the gateway, gateway/: POST /v1/generate streams tokens
as SSE, GET /metrics is Prometheus text, /healthz flips to 503 at drain;
SIGTERM drains gracefully — in-flight streams finish, new work gets 503).
On the card every kernel is built before the gateway listens, so the step
watchdog never times an ``nvcc`` build:

    ... --http 8080 --lanes 4 --max-pending 16 --prefix-cache

    curl -N localhost:8080/v1/generate \
        -d '{"prompt": [3, 1, 4, 1, 5], "max_tokens": 8}'
    curl localhost:8080/metrics

Tensor-parallel serving over a serve mesh of N processes, one a shard
(head-sharded q/k/v and KV page pools, one scheduler on rank 0; with
--stream or --continuous, as in the JAX launcher). This process is rank 0
and starts the N-1 others itself: NCCL on cuda:rank under ``--device
cuda`` (one card a rank: more shards than cards are refused), gloo under
``--device cpu``:

    ... --shards 2 --stream --requests 8 --lanes 4 --gen 16 --device cpu

Builds ``lm_init`` on a seeded generator and a ``ServeEngine`` (``--packed``:
bit-packed weights; ``--kv-quant``: int8 KV cache). Without ``--continuous``
or ``--stream`` it serves one fixed batch through ``generate`` (or the
per-token ``generate_eager`` with ``--eager``). ``--device`` defaults to
``cuda`` and raises on a host without a card; ``--device cpu`` runs the
kernels' plain versions.
"""
from __future__ import annotations

import argparse
import socket
import sys
import time


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
    ap.add_argument("--audit", action="store_true",
                    help="(--stream) run the allocator/prefix-index "
                         "invariant audit after every step and print the "
                         "robustness stats at drain")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="(--stream) bounded submit queue: overflow sheds "
                         "with a typed ShedError")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="(--stream) per-request deadline budget in wall "
                         "ms: unmeetable at admission sheds, passing it "
                         "mid-flight expires the request")
    ap.add_argument("--host-pages", type=int, default=None,
                    help="(--stream/--http) host swap tier budget in pages: "
                         "preempted lanes and cold prefix pages move to "
                         "pinned host buffers and come back bit-identical")
    ap.add_argument("--chaos-soak", type=int, default=0, metavar="N",
                    help="run N seeded random fault schedules against "
                         "fresh sessions instead of serving; exits nonzero "
                         "if any containment check fails")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="(--chaos-soak) base seed: schedule i uses seed+i")
    ap.add_argument("--chaos-rate", type=float, default=None,
                    help="(--chaos-soak) override every default per-site "
                         "firing probability with one value in [0,1]")
    ap.add_argument("--metrics-tenants", type=int, default=None,
                    help="(--http) per-tenant /metrics label budget: first "
                         "N distinct tenants get their own label, the rest "
                         "aggregate under tenant=\"other\"")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve over HTTP on this port: POST /v1/generate "
                         "(JSON body; tokens stream back as SSE), GET "
                         "/metrics (Prometheus text), GET /healthz. Honors "
                         "--lanes/--page-size/--segment/--prefix-cache/"
                         "--max-pending/--audit/--host-pages; SIGTERM "
                         "drains gracefully")
    ap.add_argument("--watchdog-timeout", type=float, default=300.0,
                    help="(--http) seconds one session.step() round may "
                         "run before the gateway watchdog declares the "
                         "step driver stalled: /healthz flips to degraded "
                         "and live SSE streams end with a typed 'watchdog' "
                         "error instead of hanging")
    ap.add_argument("--host", default="127.0.0.1",
                    help="(--http) bind address")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=0,
                    help="tensor-parallel serve mesh of N processes, one a "
                         "shard (head-axis sharded weights + KV page pools, "
                         "one mesh-wide scheduler on rank 0; NCCL one card a "
                         "rank on cuda, gloo on cpu). 0 = single-device")
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


def _chaos(engine, args, vocab: int) -> None:
    """``--chaos-soak N``: N seeded random fault schedules, each run to drain
    against a fresh audited session (serve/chaos.py); the JAX launcher's
    request pool and reports."""
    import numpy as np

    from repro_torch.serve import (DEFAULT_RATES, FaultSchedule,
                                   SamplingParams, soak_session)

    rates = dict(DEFAULT_RATES) if args.chaos_rate is None else \
        {s: args.chaos_rate for s in DEFAULT_RATES}
    rng = np.random.default_rng(12345)
    prompts = [rng.integers(0, vocab, (int(rng.integers(
        4, args.prompt_len + 1)),)).astype(np.int32)
        for _ in range(args.requests)]

    def make(inj):
        return engine.session(lanes=args.lanes, page_size=args.page_size,
                              segment=args.segment,
                              prefix_cache=args.prefix_cache, audit=True,
                              faults=inj)

    failed = 0
    for i in range(args.chaos_soak):
        seed = args.chaos_seed + i
        sched = FaultSchedule.random(seed, rates)
        rep = soak_session(
            make, prompts, sched,
            params_for=lambda i: SamplingParams(max_tokens=args.gen),
            preempt_period=7)
        print(f"[chaos] {rep.summary()}")
        if not rep.ok:
            failed += 1
            print(f"[chaos] FAILING SCHEDULE seed={seed} — replay with "
                  f"--chaos-soak 1 --chaos-seed {seed}")
            print(f"[chaos] plan: {sched.to_json()}")
            for f in rep.failures:
                print(f"[chaos]   {f}")
    if failed:
        raise SystemExit(f"[chaos] {failed}/{args.chaos_soak} schedules FAILED")
    print(f"[chaos] {args.chaos_soak} schedules drained clean "
          "(audit, terminal statuses, bit-identity)")


def _http(engine, args, device) -> None:
    """``--http PORT``: the gateway over ``engine`` until SIGTERM/SIGINT,
    then a graceful drain. On the card every kernel is built first (one
    ``nvcc`` a source, all at once), so no step the watchdog times holds a
    build."""
    from repro_torch.gateway import run_gateway

    if device.type == "cuda":
        from repro_torch.kernels import build

        t0 = time.perf_counter()
        build.build_all()
        print(f"[serve] kernels built in {time.perf_counter() - t0:.1f}s "
              "before listening")
    print(f"[serve] gateway listening on http://{args.host}:{args.http} "
          f"({args.lanes} lanes, page_size={args.page_size}, "
          f"segment={args.segment}"
          + (", prefix-cache" if args.prefix_cache else "")
          + (f", max_pending={args.max_pending}"
             if args.max_pending is not None else "")
          + ") — SIGTERM/Ctrl-C drains gracefully", flush=True)
    run_gateway(engine, host=args.host, port=args.http,
                lanes=args.lanes, page_size=args.page_size,
                segment=args.segment, prefix_cache=args.prefix_cache,
                max_pending=args.max_pending, audit=args.audit,
                host_page_budget=args.host_pages,
                metrics_tenants=args.metrics_tenants,
                watchdog_timeout=args.watchdog_timeout)
    print("[serve] gateway drained; exiting", flush=True)


def _stream(engine, args, prompts, gens):
    from repro_torch.serve import SamplingParams, ShedError

    with engine.session(lanes=args.lanes, page_size=args.page_size,
                        segment=args.segment,
                        prefix_cache=args.prefix_cache,
                        max_pending=args.max_pending, audit=args.audit,
                        host_page_budget=args.host_pages) as sess:
        def submit(p, g):
            try:
                return sess.submit(p, SamplingParams(
                    max_tokens=g, deadline_ms=args.deadline_ms))
            except ShedError as e:
                print(f"[serve] shed rid={e.rid} ({e.reason}): {e}")
                return None

        # half up front, the rest one a step, mid-flight
        half = args.requests // 2
        handles = [submit(p, g) for p, g in zip(prompts[:half], gens[:half])]
        printed = [0] * args.requests
        t0 = time.time()
        ttft = None
        injected = half
        while not sess.idle or injected < args.requests:
            if injected < args.requests:
                handles.append(submit(prompts[injected], gens[injected]))
                injected += 1
            sess.step()
            for i, h in enumerate(handles):
                if h is not None and h.tokens_ready > printed[i]:
                    if ttft is None:
                        ttft = time.time() - t0
                    new = h.tokens_so_far()[printed[i]:]
                    print(f"[serve] req{i} +{new} ({h.tokens_ready}/"
                          f"{gens[i]} {h.status.name.lower()})")
                    printed[i] = h.tokens_ready
        dt = time.time() - t0
        total = sum(h.tokens_ready for h in handles if h is not None)
        for i, h in enumerate(handles):
            if h is not None and h.error is not None:
                print(f"[serve] req{i} left abnormally: "
                      f"{h.status.name} ({h.error})")
        if args.audit:
            a = sess.audit()
            st = sess.sched.stats
            print(f"[serve] audit clean at drain: "
                  f"{a['alloc']['n_owned']} pages owned / "
                  f"{a['alloc']['n_free']} free; "
                  f"admitted={st['admitted']} shed={st['shed']} "
                  f"expired={st['expired']} failed={st['failed']} "
                  f"preemptions={st['preemptions']}")
        if args.prefix_cache:
            st = sess.prefix.stats
            print(f"[serve] prefix cache: {st['exact_hits']} exact + "
                  f"{st['partial_hits']} partial hits / {st['lookups']} "
                  f"lookups, {st['hit_tokens']} prompt tokens served from "
                  f"cache, {st['cow_forks']} CoW forks, "
                  f"{st['evicted_pages']} pages LRU-evicted")
        if args.host_pages is not None:
            sw = sess.swap_mgr.stats_dict()
            st = sess.sched.stats
            print(f"[serve] swap tier: {sw['swap_outs']} captures / "
                  f"{sw['swap_ins']} restores ({sw['swap_out_bytes']}B out, "
                  f"{sw['swap_in_bytes']}B in; {sw['host_used']}/"
                  f"{sw['host_pages']} host pages used; preempt "
                  f"swap={st['preempt_swap']} "
                  f"recompute={st['preempt_recompute']})")
    print(f"[serve] stream: {args.requests} requests over {args.lanes} lanes "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s aggregate, first tokens "
          f"after {ttft:.2f}s)")
    return [h.tokens_so_far() if h is not None else None for h in handles]


def _engine(args, device, mesh=None):
    """The launcher's model: lm_init on a generator seeded 0 on ``device``
    (every rank of a mesh draws the same whole tree), then the engine."""
    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import lm_init
    from repro_torch.serve import ServeEngine

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.scaled(kv_cache_quant=args.kv_quant)
    params = lm_init(cfg, torch.Generator(device=device).manual_seed(0))
    return cfg, ServeEngine(cfg, params, max_len=args.prompt_len + args.gen,
                            packed=args.packed, device=device, mesh=mesh)


def _rank(rank: int, init_method: str, argv) -> None:
    """A rank > 0 of ``--shards N``: join the world, build the same engine
    and follow rank 0's calls until its engine closes."""
    from repro_torch.distributed import serve_worker
    from repro_torch.launch.mesh import init_serve_world, make_serve_mesh

    args = _parser().parse_args(argv)
    device = init_serve_world(rank, args.shards, init_method, args.device)
    mesh = make_serve_mesh(args.shards, device)
    try:
        _, engine = _engine(args, device, mesh)
        serve_worker.run(engine)
    finally:
        mesh.close()


def _mesh_ranks(args, argv):
    """Rank 0 of ``--shards N``: check the world fits, start the N-1 other
    ranks (``torch.multiprocessing``, the same arguments) at a free
    localhost port, and join the world with them. Returns (device, mesh,
    the other ranks' processes)."""
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import (check_serve_world, init_serve_world,
                                         make_serve_mesh)
    from repro_torch.serve import resolve_device

    if not (args.stream or args.continuous):
        raise SystemExit("--shards requires --stream or --continuous (the "
                         "paged serve path; generate() is single-device)")
    try:
        check_serve_world(args.shards, resolve_device(args.device),
                          args.shards)
    except ValueError as e:
        raise SystemExit(f"[serve] {e}") from None
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, init, argv))
             for r in range(1, args.shards)]
    for p in procs:
        p.start()
    device = init_serve_world(0, args.shards, init, args.device)
    mesh = make_serve_mesh(args.shards, device)
    print(f"[serve] tensor-parallel mesh: {args.shards} shards over "
          f"{mesh.device.type} (head-axis sharded weights + KV page pools)",
          flush=True)
    return device, mesh, procs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    from repro_torch.serve import resolve_device

    mesh, procs, engine = None, [], None
    if args.shards:
        device, mesh, procs = _mesh_ranks(args, argv)
    else:
        device = resolve_device(args.device)
    try:
        cfg, engine = _engine(args, device, mesh)
        if cfg.frontend == "embeddings":
            print(f"[serve] {args.arch} uses an embeddings frontend stub; "
                  "serving decodes tokens after an embedded prompt.")
        return _serve(engine, cfg, args, device)
    finally:
        if engine is not None:
            engine.close()
        if mesh is not None:
            mesh.close()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()


def _serve(engine, cfg, args, device):
    """Serve as the flags say: a chaos soak, the gateway, a stream, a
    continuous pool, or one fixed batch."""
    import numpy as np

    if args.chaos_soak:
        return _chaos(engine, args, cfg.vocab_size)
    if args.http is not None:
        return _http(engine, args, device)
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
