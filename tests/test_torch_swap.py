"""The port's host swap tier against the JAX package's (``-m swap``).

The JAX package's ``tests/test_swap_tier.py``, case for case, at smoke width:

  1. byte identity at the copy layer — ``SwapManager.swap_out`` then
     ``swap_in`` onto other page ids returns every byte of every attention
     leaf (the int8 pools' scale pools included) for dense, packed,
     kv-quant, ssm and hybrid pools, and the host slots hold the same bytes
     as the JAX package's after the same copy; the chunked copy equals one
     plain ``.to("cpu")`` of the same pages; the mamba lane state comes
     back bit for bit;
  2. streams — a request preempted mid-decode and resumed through the swap
     tier emits the same greedy tokens as the JAX session under the same
     script, and as its own uninterrupted run; host budget exhaustion falls
     back to recompute, counted apart;
  3. the prefix index demotes under pressure, promotes on a hit, survives
     ``close()`` and is adopted by the next session — promoted-hit streams
     token-identical to the JAX session's;
  4. two-tier admission sheds with ``host-budget``;
  5. ``swap_out`` / ``swap_in`` / ``host_pool`` faults degrade, never fail;
  6. the allocator and slot censuses under randomized churn.

Every session case runs one script through both packages (fp32 weights
bridged leaf by leaf, the JAX session on its gather path, which the JAX
package pins bitwise to its Pallas kernel) and compares the traces: tokens,
counters, statuses, fired faults. Engines are shared by the module, so each
geometry is traced once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import attention as JA
from repro.models import lm_init as jax_lm_init
from repro.serve import FaultInjector as JFaults
from repro.serve import SamplingParams as JParams
from repro.serve import ServeEngine as JEngine
from repro.serve import ShedError as JShed
from repro.serve.paged_cache import PageAllocator as JAlloc
from repro.serve.paged_cache import paged_pool_init as jax_pool_init
from repro.serve.swap import SwapManager as JSwap
from repro.serve.swap import decode_slot as j_decode
from repro.serve.swap import encode_slot as j_encode
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.serve import (FaultInjector, PageAllocator, RequestStatus,
                               SamplingParams, ServeEngine, ShedError,
                               reasons)
from repro_torch.serve.swap import (HostBudgetExceeded, SwapManager,
                                    decode_slot, encode_slot)

pytestmark = pytest.mark.swap

torch.set_num_threads(1)

FAMILIES = [
    pytest.param("gemma2-2b", False, False, id="dense"),
    pytest.param("gemma2-2b", True, False, id="packed"),
    pytest.param("gemma2-2b", False, True, id="kv-quant"),
    pytest.param("falcon-mamba-7b", False, False, id="ssm"),
    pytest.param("jamba-1.5-large-398b", False, False, id="hybrid"),
]

_ENGINES = {}


def engines(arch="gemma2-2b", packed=False, quant=False, max_len=32):
    """(JAX engine, port engine) on one set of fp32 weights, shared by the
    module."""
    key = (arch, packed, quant, max_len)
    if key not in _ENGINES:
        cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32,
                                       kv_cache_quant=quant)
        cfg_t = get_smoke(arch).scaled(dtype=torch.float32,
                                       kv_cache_quant=quant)
        params = jax.tree.map(np.asarray,
                              jax_lm_init(jax.random.PRNGKey(0), cfg_j)[0])
        _ENGINES[key] = (
            JEngine(cfg_j, jax.tree.map(jnp.asarray, params),
                    max_len=max_len, packed=packed),
            ServeEngine(cfg_t, bridge.params_from_numpy(params, "cpu"),
                        max_len=max_len, packed=packed, device="cpu"))
    return _ENGINES[key]


JAX = dict(P=JParams, F=JFaults, Shed=JShed)
TORCH = dict(P=SamplingParams, F=FaultInjector, Shed=ShedError)


def both(script, **kw):
    """Run ``script(engine, pkg, trace)`` through the JAX session (gather
    path) and the port's; the traces must agree. Returns the port's."""
    jeng, teng = engines(**kw)
    traces = []
    with JA.paged_kernel_override(False):
        traces.append([])
        script(jeng, JAX, traces[0])
    traces.append([])
    script(teng, TORCH, traces[1])
    assert traces[1] == traces[0]
    return traces[1]


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _toks(h):
    return [int(t) for t in h.tokens_so_far()]


# ---------------------------------------------------------------------------
# 1. byte identity at the copy layer
# ---------------------------------------------------------------------------
def _pools(arch, quant, n_pages=24, page=4, lanes=2, seed=3):
    """The same random bytes in a JAX pool and a port pool (smoke config
    at its own dtype, bf16 included): zero pages would make the byte
    checks vacuous."""
    cfg_j = jax_smoke(arch).scaled(kv_cache_quant=quant)
    cfg_t = get_smoke(arch).scaled(kv_cache_quant=quant)
    pool = jax_pool_init(cfg_j, lanes, n_pages, page)
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return rng.integers(-100, 100, a.shape).astype(a.dtype)
        return rng.standard_normal(a.shape).astype(a.dtype)

    jpool = jax.tree.map(lambda a: fill(a), pool)
    tpool = bridge.params_from_numpy(jpool, "cpu")
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, jpool), tpool


def _np(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _page_bytes(mgr, pool, pages):
    return {bi: {name: np.stack([_np(leaf[:, p]) for p in pages])
                 for name, leaf in pool[bi].items()} for bi in mgr._attn}


def _same(a, b):
    assert a.keys() == b.keys()
    for bi in a:
        assert a[bi].keys() == b[bi].keys()
        for name in a[bi]:
            np.testing.assert_array_equal(a[bi][name], b[bi][name])


def test_slot_encoding_roundtrip():
    for s in (0, 1, 7, 1023):
        assert encode_slot(s) == j_encode(s) < 0
        assert decode_slot(encode_slot(s)) == j_decode(j_encode(s)) == s


@pytest.mark.parametrize("arch,packed,quant", FAMILIES)
def test_swap_roundtrip_byte_identity(arch, packed, quant):
    """swap_out -> host -> swap_in onto other pages returns every byte, and
    the host slots hold what the JAX package's hold after the same copy."""
    cfg_j, cfg_t, jpool, tpool = _pools(arch, quant)
    src, dst = [3, 5, 9, 11, 2], [17, 18, 19, 20, 21]
    mgr, jmgr = SwapManager(cfg_t, host_pages=16), JSwap(cfg_j, host_pages=16)
    assert mgr._attn == jmgr._attn and mgr._mamba == jmgr._mamba
    before = _page_bytes(mgr, tpool, src)
    slots, jslots = mgr.swap_out(tpool, src), jmgr.swap_out(jpool, src)
    assert slots == jslots and mgr.n_used == len(src)
    if mgr._attn:
        host = {bi: {n: _np(t) for n, t in lv.items()}
                for bi, lv in mgr.read_slots(slots).items()}
        _same(host, before)
        _same(host, {bi: {n: _jnp(a) for n, a in lv.items()}
                     for bi, lv in jmgr.read_slots(jslots).items()})
        for name in ("k_scale", "v_scale") if quant else ():
            assert name in host[mgr._attn[0]]
    tpool = mgr.swap_in(tpool, slots, dst)
    _same(_page_bytes(mgr, tpool, dst), before)
    assert mgr.n_used == 0
    st = mgr.stats_dict()
    jmgr.swap_in(jpool, jslots, dst)
    assert st == jmgr.stats_dict()
    if mgr._attn:
        assert st["swap_out_bytes"] == st["swap_in_bytes"] > 0


def test_chunked_copy_equals_plain_copy():
    """The chunked copy (3 chunks and a tail, slots out of order) leaves on
    the host exactly what one plain ``.to("cpu")`` of the same pages holds,
    and scatters it back unchanged."""
    _, cfg_t, _, pool = _pools("gemma2-2b", True, n_pages=64)
    pages = list(range(2, 2 + 3 * SwapManager.CHUNK + 3))
    mgr = SwapManager(cfg_t, host_pages=len(pages) + 1)
    mgr.alloc_slots(2)                          # slots 0, 1 taken: a gap
    mgr.free_slots([0])                         # ... and one out of order
    slots = mgr.swap_out(pool, pages)
    assert slots[:2] == [2, 3] and 0 in slots
    plain = {bi: {name: leaf[:, pages].to("cpu").transpose(0, 1)
                  for name, leaf in pool[bi].items()} for bi in mgr._attn}
    got = mgr.read_slots(slots)
    for bi in plain:
        for name in plain[bi]:
            assert torch.equal(got[bi][name], plain[bi][name])
    dst = list(range(30, 30 + len(pages)))
    mgr.swap_in(pool, slots, dst)
    for bi in plain:
        for name, leaf in pool[bi].items():
            assert torch.equal(leaf[:, dst].transpose(0, 1), plain[bi][name])


def test_ssm_lane_state_roundtrip():
    """A pure-SSM pool has no attention leaves: the tier is slot accounting
    and the state is the mamba lane tree, written back bit for bit into
    another lane, as the JAX package's is."""
    cfg_j, cfg_t, jpool, tpool = _pools("falcon-mamba-7b", False)
    mgr, jmgr = SwapManager(cfg_t, host_pages=4), JSwap(cfg_j, host_pages=4)
    assert not mgr._attn and mgr._mamba == jmgr._mamba
    state = mgr.lane_state_out(tpool, 0)
    jstate = jmgr.lane_state_out(jpool, 0)
    for bi in mgr._mamba:
        for name, t in state[bi].items():
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(_np(t), _jnp(jstate[bi][name]))
    before = {bi: {n: l[:, 0].clone() for n, l in tpool[bi].items()}
              for bi in mgr._mamba}
    tpool = mgr.lane_state_in(tpool, state, 1)
    for bi in mgr._mamba:
        for name, leaf in tpool[bi].items():
            assert torch.equal(leaf[:, 1], before[bi][name])


def test_host_budget_is_atomic():
    trace = []
    for Mgr, Exc in ((JSwap, Exception), (SwapManager, HostBudgetExceeded)):
        mgr = Mgr(get_smoke("gemma2-2b"), host_pages=3) if Mgr is SwapManager \
            else Mgr(jax_smoke("gemma2-2b"), host_pages=3)
        got = mgr.alloc_slots(2)
        with pytest.raises(Exc) as e:
            mgr.alloc_slots(2)
        assert type(e.value).__name__ == "HostBudgetExceeded"
        mgr.free_slots(got)
        trace.append((got, str(e.value), mgr.n_used, mgr.n_free,
                      mgr.stats_dict(), mgr.audit({})))
    assert trace[0] == trace[1]


# ---------------------------------------------------------------------------
# 2. streams: preempt -> swap -> resume
# ---------------------------------------------------------------------------
def _preempt_script(n_tok=10, lens=(7, 9), budget=16, at=4):
    def script(eng, pkg, t):
        prompts = _prompts(eng.cfg.vocab_size, lens, 5)
        with eng.session(lanes=2, page_size=4, segment=2, audit=True,
                         host_page_budget=budget) as sess:
            hs = [sess.submit(p, pkg["P"](max_tokens=n_tok)) for p in prompts]
            while hs[0].tokens_ready < at:
                sess.step()
            assert sess.preempt(hs[0])
            sess.run_until_idle()
            st = sess.stats()
            t.append(([_toks(h) for h in hs], [h.status.name for h in hs],
                      hs[0].preempt_swap, hs[0].preempt_recompute,
                      hs[0].preemptions, st["sched"],
                      {k: st["swap"][k] for k in ("swap_outs", "swap_ins",
                                                  "host_used")}))
            sess.audit()
        # the uninterrupted streams of the same requests
        with eng.session(lanes=2, page_size=4, segment=2) as sess:
            hs = [sess.submit(p, pkg["P"](max_tokens=n_tok)) for p in prompts]
            sess.run_until_idle()
            t.append([_toks(h) for h in hs])
    return script


@pytest.mark.parametrize("arch,packed,quant", FAMILIES)
def test_preempt_swap_resume_bit_identical(arch, packed, quant):
    trace = both(_preempt_script(), arch=arch, packed=packed, quant=quant)
    (streams, statuses, n_swap, n_re, n_pre, sched, swap), uninterrupted = \
        trace
    assert streams == uninterrupted               # bit-exact resume
    assert statuses == ["DONE", "DONE"]
    assert (n_swap, n_re, n_pre) == (1, 0, 1) and sched["preempt_swap"] == 1
    assert swap["swap_outs"] >= 1 and swap["swap_ins"] >= 1
    assert swap["host_used"] == 0


def test_budget_exhausted_falls_back_to_recompute():
    """host_page_budget=0: the capture cannot take the pages, preemption
    recomputes (counted apart) and the resumed tail is the stream of the
    effective prompt served fresh — the JAX session's too."""
    def script(eng, pkg, t):
        (p,) = _prompts(eng.cfg.vocab_size, (8,), 6)
        with eng.session(lanes=2, page_size=4, segment=2, audit=True,
                         host_page_budget=0) as sess:
            h = sess.submit(p, pkg["P"](max_tokens=10))
            while h.tokens_ready < 4:
                sess.step()
            assert sess.preempt(h)
            sess.run_until_idle()
            t.append((_toks(h), h.preempt_swap, h.preempt_recompute,
                      h.status.name))
            sess.audit()
        eff = np.concatenate([p, np.asarray(_toks(h)[:4], np.int32)])
        with eng.session(lanes=2, page_size=4, segment=2) as sess:
            t.append([int(x) for x in sess.submit(
                eff, pkg["P"](max_tokens=6)).result()])
    (toks, n_swap, n_re, status), fresh = both(script)
    assert (n_swap, n_re, status) == (0, 1, "DONE")
    assert toks[4:] == fresh


def test_double_preempt_same_request_swaps_twice():
    def script(eng, pkg, t):
        (p,) = _prompts(eng.cfg.vocab_size, (6,), 7)
        with eng.session(lanes=1, page_size=4, segment=1, audit=True,
                         host_page_budget=16) as sess:
            h = sess.submit(p, pkg["P"](max_tokens=12))
            for target in (3, 7):
                while h.tokens_ready < target:
                    sess.step()
                assert sess.preempt(h)
            sess.run_until_idle()
            t.append((_toks(h), h.preempt_swap, h.preempt_recompute))
            sess.audit()
        with eng.session(lanes=1, page_size=4, segment=1) as sess:
            t.append([int(x) for x in sess.submit(
                p, pkg["P"](max_tokens=12)).result()])
    (toks, n_swap, n_re), uninterrupted = both(script)
    assert (n_swap, n_re) == (2, 0) and toks == uninterrupted


# ---------------------------------------------------------------------------
# 3. prefix index: demote under pressure, promote on a hit, survive close
# ---------------------------------------------------------------------------
def _longtail(eng, faults=None, budget=32):
    """A pool for ONE active request and under two prefixes of index
    headroom, so a tail of distinct prefixes must demote."""
    n_req = eng.max_len // 4
    kw = {} if faults is None else {"faults": faults}
    return eng.session(lanes=1, page_size=4, segment=2, audit=True,
                       n_pages=1 + n_req + n_req // 2, prefix_cache=True,
                       host_page_budget=budget, **kw)


def _serve(sess, p, P, n=8):
    h = sess.submit(p, P(max_tokens=n))
    sess.run_until_idle()
    assert h.status is type(h.status).DONE
    return _toks(h)


def test_host_resident_prefix_hit_bit_identical():
    def script(eng, pkg, t):
        prompts = _prompts(eng.cfg.vocab_size, (20, 20, 20), 8)
        with _longtail(eng) as sess:
            t.append([_serve(sess, p, pkg["P"]) for p in prompts])
            t.append((dict(sess.prefix.stats),
                      sess.prefix.host_resident_pages))
            t.append([_serve(sess, p, pkg["P"]) for p in prompts])
            t.append(dict(sess.prefix.stats))
            sess.audit()
    cold, (st1, host), hits, st2 = both(script, max_len=28)
    assert hits == cold
    assert st1["demoted_pages"] > 0 and host > 0
    assert st2["promoted_pages"] > 0 and st2["exact_hits"] >= 3


def test_index_survives_close_and_adoption():
    """close() demotes the whole index to host and parks it; the next
    session of the same geometry adopts it and serves host-resident hits
    identical to the first session's streams."""
    def script(eng, pkg, t):
        prompts = _prompts(eng.cfg.vocab_size, (18, 18), 9)
        eng._prefix_store.clear()
        with _longtail(eng) as sess:
            t.append([_serve(sess, p, pkg["P"]) for p in prompts])
        assert eng._prefix_store
        with _longtail(eng) as sess:
            t.append(sess.prefix.host_resident_pages)
            base = sess.prefix.stats["exact_hits"]
            t.append([_serve(sess, p, pkg["P"]) for p in prompts])
            t.append((sess.prefix.stats["exact_hits"] - base,
                      sess.prefix.stats["promoted_pages"]))
            sess.audit()
        eng._prefix_store.clear()
    first, n_host, again, (hits, promoted) = both(script, max_len=28)
    assert again == first and n_host > 0
    assert hits >= 2 and promoted > 0


# ---------------------------------------------------------------------------
# 4. two-tier admission
# ---------------------------------------------------------------------------
def test_host_budget_shed_reason():
    def script(eng, pkg, t):
        prompts = _prompts(eng.cfg.vocab_size, (8,) * 8, 10)
        with eng.session(lanes=1, page_size=4, n_pages=5,
                         host_page_budget=4, audit=True) as sess:
            hs = []
            with pytest.raises(pkg["Shed"]) as ei:
                for p in prompts:
                    hs.append(sess.submit(p, pkg["P"](max_tokens=8)))
            sess.run_until_idle()
            t.append((ei.value.reason, str(ei.value), len(hs),
                      [h.status.name for h in hs], [_toks(h) for h in hs]))
            sess.audit()
    ((reason, msg, n, statuses, _),) = both(script, max_len=16)
    assert reason == reasons.HOST_BUDGET and n == 2
    assert statuses == ["DONE", "DONE"]


# ---------------------------------------------------------------------------
# 5. fault containment: swap faults degrade, never fail a request
# ---------------------------------------------------------------------------
def _fault_script(site):
    def script(eng, pkg, t):
        (p,) = _prompts(eng.cfg.vocab_size, (8,), 12)
        inj = pkg["F"]({site: [0]})
        with eng.session(lanes=2, page_size=4, segment=2, audit=True,
                         host_page_budget=16, faults=inj,
                         prefix_cache=False) as sess:
            h = sess.submit(p, pkg["P"](max_tokens=10))
            while h.tokens_ready < 4:
                sess.step()
            assert sess.preempt(h)
            captured = h.preempt_swap
            sess.run_until_idle()
            t.append((list(inj.fired), captured, h.preempt_swap,
                      h.preempt_recompute, h.status.name, _toks(h),
                      sess.stats()["swap"]["host_used"]))
            sess.audit()
    return script


@pytest.mark.faultinject
@pytest.mark.parametrize("site,captured", [("swap_out", 0), ("host_pool", 0),
                                           ("swap_in", 1)])
def test_swap_fault_degrades_to_recompute(site, captured):
    """The capture (swap_out, host_pool) or the restore (swap_in) faults:
    the preemption is recompute, the request completes, slots are freed."""
    ((fired, cap, n_swap, n_re, status, _, used),) = \
        both(_fault_script(site))
    assert fired == [(site, 0)] and cap == captured
    assert (n_swap, n_re, status, used) == (0, 1, "DONE", 0)


@pytest.mark.faultinject
def test_swap_in_fault_at_promote_degrades_to_cold():
    """A host-resident hit whose promotion copy faults admits COLD (the
    index is demoted back) with the same tokens, and the host copy
    survives for the next hit, which promotes."""
    def script(eng, pkg, t):
        prompts = _prompts(eng.cfg.vocab_size, (20, 20), 13)
        inj = pkg["F"]({})
        with _longtail(eng, faults=inj) as sess:
            t.append([_serve(sess, p, pkg["P"]) for p in prompts])
            assert sess.prefix.host_resident_pages > 0
            inj.arm("swap_in", at=0)
            t.append(_serve(sess, prompts[0], pkg["P"]))
            t.append(list(inj.fired))
            before = sess.prefix.stats["promoted_pages"]
            t.append(_serve(sess, prompts[0], pkg["P"]))
            t.append(sess.prefix.stats["promoted_pages"] > before)
            sess.audit()
    first, faulted, fired, again, promoted = both(script, max_len=28)
    assert ("swap_in", 0) in fired
    assert faulted == again == first[0] and promoted


# ---------------------------------------------------------------------------
# 6. invariants under randomized churn
# ---------------------------------------------------------------------------
def test_allocator_and_slots_under_randomized_churn():
    """Random interleavings of page alloc/incref/decref and slot
    alloc/free: both packages hand out the same pages and slots and their
    censuses stay exact at every step."""
    for seed in range(4):
        outs = []
        for Alloc, Mgr, cfg in ((JAlloc, JSwap, jax_smoke("gemma2-2b")),
                                (PageAllocator, SwapManager,
                                 get_smoke("gemma2-2b"))):
            rng = np.random.default_rng(seed)
            alloc, mgr = Alloc(24), Mgr(cfg, host_pages=12)
            pages, slots, log = [], [], []
            for _ in range(200):
                op = rng.integers(0, 5)
                if op == 0 and alloc.n_free:
                    pages += alloc.alloc(int(rng.integers(
                        1, alloc.n_free + 1)))
                elif op == 1 and pages:
                    p = pages[rng.integers(len(pages))]
                    alloc.incref(p)
                    pages.append(p)
                elif op == 2 and pages:
                    alloc.decref(pages.pop(rng.integers(len(pages))))
                elif op == 3 and mgr.n_free:
                    slots += mgr.alloc_slots(int(rng.integers(
                        1, mgr.n_free + 1)))
                elif op == 4 and slots:
                    k = rng.integers(1, len(slots) + 1)
                    rng.shuffle(slots)
                    take, slots = slots[:k], slots[k:]
                    mgr.free_slots(take)
                holds = {}
                for p in pages:
                    holds[p] = holds.get(p, 0) + 1
                log.append((alloc.audit(holds), mgr.audit({s: 1 for s in
                                                           slots}),
                            alloc.free_pages))
            outs.append(log)
        assert outs[0] == outs[1]


def test_session_churn_with_swap_audits_clean():
    """Random submit / preempt / cancel over a prefix + swap session with
    ``audit=True`` (the two-tier census re-checked after every step): the
    same streams, statuses and counters as the JAX session's."""
    def script(eng, pkg, t):
        rng = np.random.default_rng(4)
        sys_p = rng.integers(0, eng.cfg.vocab_size, (8,)).astype(np.int32)
        with eng.session(lanes=2, page_size=4, segment=1, audit=True,
                         prefix_cache=True, host_page_budget=24) as sess:
            live = []
            for _ in range(8):
                tail = rng.integers(0, eng.cfg.vocab_size, (
                    int(rng.integers(2, 6)),)).astype(np.int32)
                prompt = np.concatenate([sys_p, tail]) \
                    if rng.random() < 0.6 else tail
                live.append(sess.submit(prompt, pkg["P"](
                    max_tokens=int(rng.integers(3, 9)))))
                for _ in range(int(rng.integers(1, 4))):
                    sess.step()
                decoding = [h for h in live
                            if h.status.name == "DECODING"]
                if decoding and rng.random() < 0.5:
                    sess.preempt(decoding[int(rng.integers(len(decoding)))])
                if live and rng.random() < 0.2:
                    live.pop(int(rng.integers(len(live)))).cancel()
            sess.run_until_idle()
            st = sess.stats()
            t.append(([_toks(h) for h in live],
                      [h.status.name for h in live], st["sched"],
                      st["prefix"], {k: v for k, v in st["swap"].items()
                                     if k != "page_bytes"}))
            sess.audit()
    ((_, statuses, sched, _, _),) = both(script, max_len=24)
    assert set(statuses) <= {"DONE", "CANCELLED"}
    assert sched["preempt_swap"] + sched["preempt_recompute"] \
        == sched["preemptions"] > 0
