"""The port's prefix cache against the JAX package.

Host-only units drive the radix index, the allocator and prefix-aware
admission of both packages in lockstep and compare their whole state after
every operation: the same hits (lengths, pages), splits, dedup frees, LRU
evictions and reclaim results. Session tests serve gemma2-2b at smoke width
in fp32 through both packages with ``prefix_cache=True`` and require
token-identical streams, with and without kv-quant (kv-quant is held
against the JAX package's kv-quant session, never against bf16).

The JAX sessions run with ``paged_kernel_override(False)``, the gather path
(its decode and its tail prefill's ``prefix=`` route), which the JAX
package pins bitwise equal to its Pallas kernels and which saves interpret
time.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_smoke as jax_smoke
from repro.models import attention as JA
from repro.models import lm_init as jax_lm_init
from repro.serve import PrefixCache as JPrefixCache
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JParams
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.serve import (PrefixCache, Request, RequestStatus,
                               SamplingParams, Scheduler, ServeEngine)


# ---------------------------------------------------------------------------
# host-only: both indexes and schedulers in lockstep
# ---------------------------------------------------------------------------
def _tree(cache):
    """Every node root-first in key order: (depth, key, pages, ref, tick)."""
    out, stack = [], [(cache.root, 0)]
    while stack:
        node, d = stack.pop()
        if node is not cache.root:
            out.append((d, node.key.tobytes(), tuple(node.pages), node.ref,
                        node.tick))
        for kb in sorted(node.children, reverse=True):
            stack.append((node.children[kb], d + 1))
    return out


def _state(sched):
    c = sched.prefix_cache
    hit = lambda h: None if h is None else (h.exact, h.hit_len, tuple(h.pages))
    return {
        "active": {ln: (r.rid, tuple(r.pages), tuple(r.shared_pages),
                        tuple(r.private_pages), hit(r.hit))
                   for ln, r in sched.active.items()},
        "pending": [r.rid for r in sched.pending],
        "free": tuple(sched.alloc.free_pages),
        "refs": list(sched.alloc.refs),
        "tree": _tree(c),
        "records": sorted((kb, r.page, r.n_tokens, r.tick)
                          for kb, r in c.records.items()),
        "stats": dict(c.stats), "tick": c._tick,
        "quarantined": c.quarantined,
    }


class Lockstep:
    """One JAX and one port scheduler + index, driven alike."""

    def __init__(self, lanes, n_pages, page, max_records=256):
        self.j = JScheduler(lanes, n_pages, page,
                            prefix_cache=JPrefixCache(page, max_records))
        self.t = Scheduler(lanes, n_pages, page,
                           prefix_cache=PrefixCache(page, max_records))
        self.reqs = {}

    def check(self):
        assert _state(self.j) == _state(self.t)
        assert self.j.prefix_cache.owned_pages == self.t.prefix_cache.owned_pages

    def submit(self, rid, toks, n):
        toks = np.asarray(toks, np.int32)
        pair = (JRequest(rid, toks, n_tokens=n),
                Request(rid, toks, SamplingParams(max_tokens=n)))
        self.reqs[rid] = pair
        self.j.submit(pair[0])
        self.t.submit(pair[1])

    def admit(self):
        got = [r.rid for r in self.j.admit()], [r.rid for r in self.t.admit()]
        assert got[0] == got[1]
        self.check()
        return got[1]

    def finish(self, rid):
        """Stand in for the session: attach what a prefill would have kept
        (host test — opaque logits suffice) and finish."""
        for req, sched in zip(self.reqs[rid], (self.j, self.t)):
            req.cache_extras = {"tokens": np.asarray(req.prompt, np.int32),
                                "offset": req.hit.hit_len if req.hit else 0,
                                "logits": object(), "end_ssm": {},
                                "snaps": {}}
            sched.finish(req.lane)
        self.check()

    def cancel(self, rid):
        a, b = (s.cancel(r) for s, r in zip((self.j, self.t), self.reqs[rid]))
        assert a == b
        self.check()

    def reclaim(self, need):
        a = self.j.prefix_cache.reclaim(self.j.alloc, need)
        b = self.t.prefix_cache.reclaim(self.t.alloc, need)
        assert a == b
        self.check()
        return b

    def conserved(self):
        priv = sum(len(r.private_pages) for r in self.t.active.values())
        assert self.t.prefix_cache.owned_pages + priv + self.t.alloc.n_free \
            == self.t.alloc.n_pages - 1


def test_index_and_admission_decisions_match_scripted():
    """One scripted sequence through both packages: dedup of a duplicate
    cold pair, an exact hit, a mid-node split, hit-first admission order,
    reclaim refused on a pinned path then granted, and the page-pressure
    sweep inside admission. The whole state is compared after every
    step."""
    ls = Lockstep(lanes=2, n_pages=20, page=2)
    a = np.arange(8)
    ls.submit(0, a, 3), ls.submit(1, a, 3)
    assert ls.admit() == [0, 1]                   # both cold
    ls.finish(0), ls.finish(1)                    # 1's pages dedup-free
    assert ls.t.prefix_cache.stats["inserted_pages"] == 4
    ls.submit(2, np.concatenate([a[:4], [9, 9]]), 3)   # splits at page 2
    ls.submit(3, a, 3)                            # exact: admitted first
    assert ls.admit() == [3, 2]
    assert ls.reqs[2][1].hit.hit_len == 4 and not ls.reqs[2][1].hit.exact
    assert not ls.reclaim(100)                    # pinned paths
    ls.cancel(3)
    ls.finish(2)
    assert ls.reclaim(3)                          # LRU-first
    ls.conserved()
    # fill the pool until admission must sweep the index
    for rid in range(4, 10):
        ls.submit(rid, np.full(7, rid), 4)
        ls.admit()
        ls.finish(rid)
    ls.submit(10, np.arange(100, 117), 6)         # needs 11 pages
    assert ls.admit() == [10]
    assert ls.t.prefix_cache.stats["evicted_pages"] > 0
    ls.finish(10)
    ls.conserved()


def test_record_map_lru_bound_and_minimum_pool_fallback():
    """The record map evicts its LRU record at the cap, releasing its
    boundary page; at a minimum pool an exact hit that pins its own fork
    source falls back to a cold admission."""
    ls = Lockstep(lanes=2, n_pages=40, page=2, max_records=2)
    for rid in range(4):
        ls.submit(rid, [rid] * 5, 2)
        ls.admit()
        ls.finish(rid)
    assert len(ls.t.prefix_cache.records) == 2
    small = Lockstep(lanes=2, n_pages=4, page=4)
    small.submit(0, np.arange(6), 7)              # 3 pages: the whole pool
    small.admit()
    small.finish(0)
    small.submit(1, np.arange(6), 7)              # the exact hit cannot fit
    assert small.admit() == [1]
    assert small.t.prefix_cache.stats["misses"] == 2
    small.finish(1)
    small.conserved()


def test_corrupted_node_quarantines_the_index_alike():
    """A node mutated out of band fails its checksum at the next lookup:
    both packages quarantine the index (flush, cold admission from then
    on, nothing inserted) and leave the same state."""
    ls = Lockstep(lanes=2, n_pages=20, page=2)
    ls.submit(0, np.arange(8), 3)
    ls.admit()
    ls.finish(0)
    for sched in (ls.j, ls.t):
        (node,) = sched.prefix_cache.root.children.values()
        node.key = node.key.copy()
        node.key[1] += 1
    ls.submit(1, np.arange(8), 3)
    assert ls.admit() == [1]
    assert ls.t.prefix_cache.quarantined and ls.reqs[1][1].hit is None
    assert ls.t.prefix_cache.stats["quarantines"] == 1
    ls.finish(1)
    assert ls.t.prefix_cache.owned_pages == 0
    ls.conserved()


@given(st.lists(st.tuples(st.integers(2, 8), st.integers(1, 6)),
                min_size=1, max_size=12),
       st.integers(0, 2**32 - 1))
@settings(max_examples=25, deadline=None)
def test_refcounts_match_under_random_traffic(sizes, seed):
    """The JAX package's random-traffic refcount test, run on both packages
    in lockstep: every admission, finish and cancel leaves the same state;
    refcounts never go negative and pages are conserved."""
    rnd = random.Random(seed)
    ls = Lockstep(lanes=3, n_pages=24, page=2)
    live = []
    for rid, (S, n) in enumerate(sizes):
        ls.submit(rid, [rnd.randrange(4) for _ in range(S)], n)
        live.append(rid)
        ls.admit()
        for r in list(live):
            if ls.reqs[r][1].lane >= 0 and rnd.random() < 0.4:
                (ls.finish if rnd.random() < 0.5 else ls.cancel)(r)
                live.remove(r)
    for r in live:
        (ls.finish if ls.reqs[r][1].lane >= 0 else ls.cancel)(r)
        ls.admit()
    ls.conserved()
    assert all(r >= 0 for r in ls.t.alloc.refs)


# ---------------------------------------------------------------------------
# sessions: token-identical to the JAX session with prefix_cache=True
# ---------------------------------------------------------------------------
MAX_LEN = 64


@pytest.fixture(scope="module")
def weights():
    cfg_j = jax_smoke("gemma2-2b").scaled(dtype=jnp.float32)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    return params_j, bridge.params_from_numpy(
        jax.tree.map(np.asarray, params_j), "cpu")


def _engines(weights, quant):
    params_j, params_t = weights
    cfg_j = jax_smoke("gemma2-2b").scaled(dtype=jnp.float32,
                                          kv_cache_quant=quant)
    cfg_t = get_smoke("gemma2-2b").scaled(dtype=torch.float32,
                                          kv_cache_quant=quant)
    return (JEngine(cfg_j, params_j, max_len=MAX_LEN, packed=True,
                    prefix_cache=True),
            ServeEngine(cfg_t, params_t, max_len=MAX_LEN, packed=True,
                        prefix_cache=True, device="cpu"))


def _prompts(vocab):
    rng = np.random.default_rng(7)
    p = rng.integers(0, vocab, (11,)).astype(np.int32)
    p2 = p.copy()
    p2[-2:] = (p2[-2:] + 1) % vocab               # shares p's 2 full pages
    q = rng.integers(0, vocab, (8,)).astype(np.int32)   # page-aligned
    return p, p2, q


def _drive(sess, make, prompts):
    """cold p; exact p (CoW fork); cold q; exact q (page-aligned, no fork);
    partial p2 (tail over p's pages); then two concurrent exact hits on p,
    one cancelled mid-decode. Returns every stream and the stats."""
    p, p2, q = prompts
    out = [sess.submit(p, make(6)).result().tolist()]
    forks0 = sess.prefix.stats["cow_forks"]
    out.append(sess.submit(p, make(6)).result().tolist())
    forks = [sess.prefix.stats["cow_forks"] - forks0]
    out.append(sess.submit(q, make(5)).result().tolist())
    out.append(sess.submit(q, make(5)).result().tolist())
    forks.append(sess.prefix.stats["cow_forks"] - forks0 - forks[0])
    out.append(sess.submit(p2, make(6)).result().tolist())
    a, b = sess.submit(p, make(8)), sess.submit(p, make(8))
    sess.step()                                   # admission round (hits)
    sess.step()
    assert a.cancel()
    out.append(b.result().tolist())
    out.append(list(map(int, a.tokens_so_far())))
    return out, forks, dict(sess.prefix.stats)


def _conserved(sess):
    """Every page is exactly one of garbage, free, index-owned or a live
    request's private page (the JAX package's ``_assert_conserved``)."""
    alloc = sess.sched.alloc
    assert alloc.refs[0] == 1
    assert all(alloc.refs[p] == 0 for p in alloc.free_pages)
    priv = sum(len(r.private_pages) for r in sess.sched.active.values())
    assert sess.prefix.owned_pages + priv + alloc.n_free == alloc.n_pages - 1


@pytest.mark.parametrize("quant", [False, True])
def test_session_streams_identical_to_jax_prefix_session(weights, quant):
    """Exact hits with and without a CoW fork, a partial hit, concurrent
    shared prefixes with a cancel: the same tokens and the same prefix
    counters as the JAX session (kv-quant against kv-quant)."""
    jeng, teng = _engines(weights, quant)
    prompts = _prompts(teng.cfg.vocab_size)
    with JA.paged_kernel_override(False):
        with jeng.session(lanes=3, page_size=4, segment=2) as s:
            want = _drive(s, lambda n: JParams(max_tokens=n), prompts)
    with teng.session(lanes=3, page_size=4, segment=2) as s:
        got = _drive(s, lambda n: SamplingParams(max_tokens=n), prompts)
        s.audit()
        _conserved(s)
        assert s.work["prefix"] is s.prefix.stats
    assert got[0] == want[0]
    assert got[1] == want[1] == [1, 0]            # fork only when unaligned
    assert got[2] == want[2]
    stats = got[2]
    assert stats["exact_hits"] == 4 and stats["partial_hits"] == 1
    out = got[0]
    assert out[1] == out[0] and out[3] == out[2]  # exact hit == cold stream
    assert out[5][:6] == out[0]
    assert out[6] == out[5][:len(out[6])] and len(out[6]) < 8


def test_exact_hit_runs_no_prefill(weights):
    """An exact hit reads the stored logits: no prefill, no tail prefill,
    and the shared boundary page is forked, never written."""
    _, teng = _engines(weights, False)
    p, _, _ = _prompts(teng.cfg.vocab_size)
    with teng.session(lanes=2, page_size=4, segment=2) as s:
        cold = s.submit(p, SamplingParams(max_tokens=6)).result()
        calls = []
        real = teng.prefill_commit
        teng.prefill_commit = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            h = s.submit(p, SamplingParams(max_tokens=6))
            s.step()                              # the admission round
            rec_page = h._req.hit.record.page
            before = s._pool["b0"]["k"][:, rec_page].clone()
            hit = h.result()
        finally:
            del teng.prefill_commit
        assert calls == []
        assert h.ttft_ms >= h.admit_ms >= 0.0
        assert s.work["exact_admits"] == 1
        assert sum(s.work["prefills"].values()) == 1
        assert not s.work["tail_prefills"]
        assert torch.equal(s._pool["b0"]["k"][:, rec_page], before)
        _conserved(s)
    np.testing.assert_array_equal(hit, cold)


def test_kv_quant_partial_hit_never_seeds_exact_record(weights):
    """Under kv-quant a partial-hit tail computes over dequantised prefix
    rows, so finishing it donates pages but no exact record: the same
    prompt partial-hits again, with the same tokens, as in the JAX
    package."""
    jeng, teng = _engines(weights, True)
    p, p2, _ = _prompts(teng.cfg.vocab_size)
    outs = []
    for eng, make in ((jeng, lambda n: JParams(max_tokens=n)),
                      (teng, lambda n: SamplingParams(max_tokens=n))):
        with JA.paged_kernel_override(False):
            with eng.session(lanes=2, page_size=4, segment=2) as s:
                s.submit(p, make(6)).result()
                first = s.submit(p2, make(6)).result().tolist()
                again = s.submit(p2, make(6)).result().tolist()
                assert s.prefix.stats["partial_hits"] == 2
                assert s.prefix.stats["exact_hits"] == 0
                outs.append((first, again))
    assert outs[1][0] == outs[1][1] == outs[0][0] == outs[0][1]


def test_page_pressure_reclaim_and_waiting_in_a_session(weights):
    """A small pool: a request whose tail is pinned by a live exact hit
    waits (QUEUED) instead of failing and serves once the hit finishes;
    then a cold prompt that needs the whole pool makes admission sweep the
    index. Streams equal a session without the index."""
    _, teng = _engines(weights, False)
    rng = np.random.default_rng(3)
    pa, pb, pc = (rng.integers(0, teng.cfg.vocab_size, (n,)).astype(np.int32)
                  for n in (8, 4, 12))
    with teng.session(lanes=2, page_size=4, n_pages=5, segment=2) as s:
        s.submit(pa, SamplingParams(max_tokens=9)).result()      # 4 pages
        a = s.submit(pa, SamplingParams(max_tokens=9))           # exact hit
        assert s.step() and a.status is RequestStatus.DECODING
        assert s.sched.alloc.n_free == 0
        b = s.submit(pb, SamplingParams(max_tokens=4))
        assert s.step() and b.status is RequestStatus.QUEUED
        out = [b.result()]
        assert a.status is RequestStatus.DONE
        assert s.prefix.stats["evicted_pages"] == 0
        out.append(s.submit(pc, SamplingParams(max_tokens=4)).result())
        assert s.prefix.stats["evicted_pages"] >= 1              # the sweep
        _conserved(s)
        s.audit()
    with teng.session(lanes=2, page_size=4, prefix_cache=False) as s:
        for prompt, got in zip((pb, pc), out):
            np.testing.assert_array_equal(
                s.submit(prompt, SamplingParams(max_tokens=4)).result(), got)
