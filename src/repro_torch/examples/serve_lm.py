"""Serve a B⊕LD LM with batched requests on the port — the JAX package's
``examples/serve_lm.py``: prefill + greedy decode on int8 Boolean weights
(optionally bit-packed, optionally over an int8 KV cache), then a
continuous-batching pass — mixed-length requests flowing through the paged
cache pool and lane scheduler, token-identical to serving them one by one —
then a streaming session (submit / stream / cancel, a request injected
mid-flight), and a prefix-cached session whose exact hit is bit-identical
to its cold run.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --batch 4 \\
        --gen 24 [--packed] [--kv-quant] [--device cpu]

Weights come from a seeded generator on the CPU (seed 0), ``generate``'s
prompts from another (seed 1); the pool's prompts are the JAX example's
own ``numpy.random.default_rng(0)`` draws. Every clock read follows a
device synchronise, and the first ``generate`` (which builds the kernels
on first use) is left out of the timings. ``--device`` defaults to
``cuda`` and raises on a host without a card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import PackedBool
from repro_torch.core.optimizer import tree_leaves
from repro_torch.models import lm_init
from repro_torch.serve import SamplingParams, ServeEngine, resolve_device


def resident_mib(tree) -> float:
    """Bytes of a parameter tree's leaves (a packed leaf's words), MiB."""
    leaves = [p.bits if isinstance(p, PackedBool) else p
              for p in tree_leaves(tree)]
    return sum(p.numel() * p.element_size() for p in leaves) / 2 ** 20


def pool_prompts(prompt_len: int, vocab: int):
    """The JAX example's five mixed-length pool prompts, same draws."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (L,)).astype(np.int32)
            for L in (prompt_len, prompt_len // 2, prompt_len // 4 + 1,
                      prompt_len - 1, prompt_len // 2 + 3)]


def main(argv=None) -> dict:
    """-> the streams each check compared (for callers that hold them to
    another engine)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--packed", action="store_true",
                    help="serve bit-packed weights through the XNOR GEMV "
                         "kernel (32 Booleans per word)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    cfg = get_smoke(args.arch).scaled(kv_cache_quant=args.kv_quant)
    params = lm_init(cfg, torch.Generator().manual_seed(0))
    print(f"[serve] {cfg.name}: resident weights {resident_mib(params):.1f} "
          f"MiB (Boolean leaves stored int8)")

    engine = ServeEngine(cfg, params, max_len=args.prompt_len + args.gen,
                         packed=args.packed, device=dev)
    del params
    if args.packed:
        print(f"[serve] packed serving: resident weights "
              f"{resident_mib(engine.params):.1f} MiB (Boolean projections "
              f"at 32 weights/word)")
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32)
    # warm-up: the first call builds the kernels and fills the cache pool
    engine.generate(prompts, args.gen)
    t0 = clock()
    out = engine.generate(prompts, args.gen)
    dt = clock() - t0
    print(f"[serve] batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}: {args.batch*args.gen/dt:.1f} tok/s")
    for b in range(min(args.batch, 2)):
        print(f"[serve] request {b}: {out[b, :12].tolist()} ...")
    # greedy decode is deterministic — same prompt, same continuation
    out2 = engine.generate(prompts, args.gen)
    assert torch.equal(out, out2)
    print("[serve] determinism check passed")

    # -- continuous batching: a mixed-length request pool shares one paged
    # cache pool; more requests than lanes, so the scheduler admits and
    # finishes as lanes free up. Greedy outputs are token-identical to
    # serving each request alone through `generate`.
    pool = pool_prompts(args.prompt_len, cfg.vocab_size)
    half_gen = max(args.gen // 2, 1)
    pool_gens = [args.gen, half_gen, args.gen, half_gen, args.gen]
    t0 = clock()
    outs = engine.generate_batch(pool, pool_gens, lanes=3, page_size=8,
                                 segment=2)
    dt = clock() - t0
    print(f"[serve] continuous batching: {len(pool)} mixed-length "
          f"requests over 3 lanes in {dt:.1f}s "
          f"({sum(pool_gens)/dt:.1f} tok/s aggregate)")
    ref1 = engine.generate(pool[1][None], pool_gens[1])
    assert (np.asarray(outs[1]) == ref1[0].cpu().numpy()).all()
    print("[serve] continuous-batching parity check passed")

    # -- streaming session: submit, read tokens as segments complete,
    # inject a request mid-flight, cancel one — the freed lane and pages
    # are reused at once. Greedy streams stay token-identical to
    # `generate`.
    with engine.session(lanes=2, page_size=8, segment=2) as sess:
        h0 = sess.submit(pool[0], SamplingParams(max_tokens=args.gen))
        h1 = sess.submit(pool[1], SamplingParams(max_tokens=args.gen))
        stream = h0.tokens()
        first = [next(stream) for _ in range(min(2, args.gen))]
        print(f"[serve] session: req0 streamed {first} mid-flight "
              f"(req0 {h0.tokens_ready}/{args.gen} tokens ready)")
        h2 = sess.submit(pool[2], SamplingParams(max_tokens=args.gen))
        h1.cancel()       # frees its lane + pages for h2 at once
        rest = list(stream)
        out_h2 = h2.result()
        print(f"[serve] session: req0 done ({len(first + rest)} tokens), "
              f"req1 cancelled at {h1.tokens_ready}, req2 (submitted "
              f"mid-flight) done ({len(out_h2)} tokens)")
    ref0 = engine.generate(pool[0][None], args.gen)[0].cpu().numpy()
    assert first + rest == ref0.tolist()
    ref2 = engine.generate(pool[2][None], args.gen)[0].cpu().numpy()
    assert (np.asarray(out_h2) == ref2).all()
    print("[serve] session streaming parity check passed")

    # -- prefix caching: an identical prompt re-admits with no prefill
    # (its first token from the stored end-of-prompt logits, decode
    # re-reading the very same page bytes — bit-identical to the cold
    # run), and a shared-prefix prompt prefills only its unique tail.
    sys_p = pool[0]
    # same length, diverging in the last tokens: shares every full page
    # of sys_p's prompt and stays inside max_len
    shared_p = sys_p.copy()
    shared_p[-2:] = (shared_p[-2:] + 1) % cfg.vocab_size
    with engine.session(lanes=2, page_size=8, segment=2,
                        prefix_cache=True) as sess:
        t0 = clock()
        cold = sess.submit(sys_p, SamplingParams(max_tokens=args.gen))
        out_cold = np.asarray(cold.result())
        t_cold = clock() - t0
        t0 = clock()
        hit = sess.submit(sys_p, SamplingParams(max_tokens=args.gen))
        out_hit = np.asarray(hit.result())
        t_hit = clock() - t0
        shared = sess.submit(shared_p, SamplingParams(max_tokens=args.gen))
        out_shared = np.asarray(shared.result())
        st = sess.prefix.stats
        print(f"[serve] prefix cache: exact hit served in {t_hit:.2f}s vs "
              f"{t_cold:.2f}s cold ({st['exact_hits']} exact + "
              f"{st['partial_hits']} partial hits, "
              f"{st['hit_tokens']} prompt tokens from cache, "
              f"{st['cow_forks']} CoW forks)")
    assert (out_hit == out_cold).all()       # bit-identical, by re-reading
    assert (out_cold == ref0).all()
    print("[serve] prefix-cache bit-identity check passed")
    return {"generate": out.cpu().numpy(), "batch": [np.asarray(o)
                                                     for o in outs],
            "stream0": np.asarray(first + rest), "stream2": out_h2,
            "cold": out_cold, "hit": out_hit, "shared": out_shared,
            "prefix_stats": dict(st)}


if __name__ == "__main__":
    main()
