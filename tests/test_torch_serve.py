"""The port's serving stack against the JAX package at gemma2-2b smoke width
in fp32: page accounting bit for bit, and greedy session tokens identical
under live traffic (mid-flight submits and a cancel).

The JAX session runs with ``paged_kernel_override(False)``, its gather path,
which the JAX package pins bitwise equal to its Pallas paged kernel and
which saves interpret time; its packed GEMV runs in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import attention as JA
from repro.models import lm_init as jax_lm_init
from repro.models import lm_prefill as jax_prefill
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro.serve import SamplingParams as JParams
from repro.serve import pages_for as jax_pages_for
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.models import lm_prefill
from repro_torch.serve import (Request, RequestStatus, SamplingParams,
                               Scheduler, ServeEngine, ShedError, pages_for)

MAX_LEN = 64
LENS = [5, 12, 20, 9, 17, 3]
NTOK = [8, 12, 6, 10, 7, 9]


@pytest.fixture(scope="module")
def engines():
    cfg_j = jax_smoke("gemma2-2b").scaled(dtype=jnp.float32)
    cfg_t = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    return (JEngine(cfg_j, params_j, max_len=MAX_LEN, packed=True),
            ServeEngine(cfg_t, params_t, max_len=MAX_LEN, packed=True,
                        device="cpu"))


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in LENS]


def test_pages_for_matches():
    for prompt, n, page in [(1, 1, 16), (16, 1, 16), (16, 2, 16), (5, 30, 4),
                            (600, 32, 16), (1023, 1, 16)]:
        assert pages_for(prompt, n, page) == jax_pages_for(prompt, n, page)


def test_scheduler_page_ids_match_under_admit_finish_cancel():
    """The same admit/finish/cancel sequence hands out the same lanes and
    physical page ids, and leaves the same FIFO free list."""
    lanes, n_pages, page = 3, 12, 4
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, 50, (n,)).astype(np.int32), t)
            for n, t in [(5, 4), (9, 3), (3, 6), (11, 2), (2, 2), (7, 5)]]
    js, ts = JScheduler(lanes, n_pages, page), Scheduler(lanes, n_pages, page)
    jr = [JRequest(i, p, n_tokens=t) for i, (p, t) in enumerate(reqs)]
    tr = [Request(i, p, SamplingParams(max_tokens=t))
          for i, (p, t) in enumerate(reqs)]

    def same():
        assert {ln: r.pages for ln, r in js.active.items()} == \
            {ln: r.pages for ln, r in ts.active.items()}
        assert js.free_pages == ts.alloc.free_pages
        assert [r.rid for r in js.pending] == [r.rid for r in ts.pending]
        ts.alloc.audit({p: 1 for r in ts.active.values() for p in r.pages})

    for a, b in zip(jr, tr):
        js.submit(a)
        ts.submit(b)
    assert [r.rid for r in js.admit()] == [r.rid for r in ts.admit()]
    same()
    js.finish(jr[1].lane), ts.finish(tr[1].lane)
    js.cancel(jr[4]), ts.cancel(tr[4])            # pending cancel
    assert [r.rid for r in js.admit()] == [r.rid for r in ts.admit()]
    same()
    js.cancel(jr[0]), ts.cancel(tr[0])            # active cancel
    js.finish(jr[2].lane), ts.finish(tr[2].lane)
    assert [r.rid for r in js.admit()] == [r.rid for r in ts.admit()]
    same()
    assert tr[4].status is RequestStatus.CANCELLED


def _drive(sess, make_params, prompts):
    """Four requests up front, two submitted mid-flight, request 1
    cancelled mid-decode; returns every request's tokens."""
    hs = [sess.submit(p, make_params(n))
          for p, n in zip(prompts[:4], NTOK[:4])]
    sess.step()                      # admission round: first tokens
    sess.step()                      # one decode segment
    hs += [sess.submit(p, make_params(n))
           for p, n in zip(prompts[4:], NTOK[4:])]
    sess.step()
    assert hs[1].cancel()
    sess.run_until_idle()
    return [list(map(int, h.tokens_so_far())) for h in hs]


def _margin(logits_row):
    top = np.sort(np.asarray(logits_row, np.float64))[-2:]
    return float(top[1] - top[0])


def test_session_tokens_identical_to_jax_session(engines):
    jeng, teng = engines
    prompts = _prompts(teng.cfg.vocab_size)
    with JA.paged_kernel_override(False):
        with jeng.session(lanes=4, page_size=16, segment=4) as s:
            want = _drive(s, lambda n: JParams(max_tokens=n), prompts)
    with teng.session(lanes=4, page_size=16, segment=4) as s:
        got = _drive(s, lambda n: SamplingParams(max_tokens=n), prompts)
    assert [len(t) for t in got] == [len(t) for t in want]
    assert len(got[1]) < NTOK[1]                 # the cancel cut it short
    for rid, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        step = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        ctx = np.concatenate([prompts[rid], np.asarray(w[:step], np.int32)])
        lj, _ = jax_prefill(jeng.cfg, jeng.params,
                            {"tokens": jnp.asarray(ctx[None])})
        lt, _ = lm_prefill(teng.cfg, teng.params,
                           {"tokens": torch.from_numpy(ctx[None])})
        V = teng.cfg.vocab_size
        pytest.fail(
            f"request {rid} diverges at step {step}: jax {w[step]} vs torch "
            f"{g[step]}; top-2 logit margin jax "
            f"{_margin(np.asarray(lj)[0, -1, :V]):.3g}, torch "
            f"{_margin(lt.numpy()[0, -1, :V]):.3g}")


def test_generate_batch_and_handle_lifecycle(engines):
    _, teng = engines
    prompts = _prompts(teng.cfg.vocab_size)[:3]
    outs = teng.generate_batch(prompts, [3, 1, 5], lanes=2, segment=2)
    assert [len(o) for o in outs] == [3, 1, 5]
    with teng.session(lanes=2, page_size=16, segment=2) as s:
        h = s.submit(prompts[0], SamplingParams(max_tokens=5))
        assert h.status is RequestStatus.QUEUED
        toks = list(h.tokens())
        assert toks[:3] == outs[0].tolist() and h.result().tolist() == toks
        assert h.status is RequestStatus.DONE and not h.cancel()
        stop = s.submit(prompts[0], SamplingParams(max_tokens=5,
                                                    stop_token=toks[1]))
        assert stop.result().tolist() == toks[:toks.index(toks[1]) + 1]
        # sampled decoding: a seeded request's stream is its seed's alone,
        # whichever lane and request id it gets
        seeded = [s.submit(prompts[0], SamplingParams(
            max_tokens=4, temperature=0.7, seed=5)).result() for _ in range(2)]
        assert len(seeded[0]) == 4
        assert seeded[0].tolist() == seeded[1].tolist()
        with pytest.raises(ValueError):
            s.submit(prompts[0], SamplingParams(max_tokens=MAX_LEN))
    small = teng.session(lanes=1, page_size=4, n_pages=3)
    with pytest.raises(ShedError) as e:
        small.submit(prompts[2], SamplingParams(max_tokens=4))
    assert e.value.reason == "page-budget"
