"""The port's fault containment against the JAX package's (``-m
faultinject``).

The JAX package's ``tests/test_serve_faults.py``, case for case, at gemma2-2b
smoke width in fp32 on one set of bridged weights: each case runs one
script — the same faults armed at the same poll indices — through the JAX
session (its gather path) and the port's, and the two must agree on every
fired fault, status, reason string and greedy token. The scripts hold the
containment contract on each package: every fault ends in a TERMINAL
status or a fallback with no victim, the audit is clean after drain (every
session runs ``audit=True``, so it is also re-checked after each step),
and co-resident streams equal the fault-free streams.

On the card the port contains an injected ``kernel_dispatch`` fault by
re-issuing the same segment on the same routes (a CUDA tensor never takes a
plain version); the JAX package serves it through its gather path, which
it pins bitwise to its kernel. Both keep every stream, which is what the
kernel-dispatch case holds.
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
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.serve import (FaultInjector, SamplingParams, ServeEngine,
                               ShedError)

pytestmark = pytest.mark.faultinject

torch.set_num_threads(1)

JAX = dict(P=JParams, F=JFaults, Shed=JShed)
TORCH = dict(P=SamplingParams, F=FaultInjector, Shed=ShedError)


@pytest.fixture(scope="module")
def engines():
    cfg_j = jax_smoke("gemma2-2b").scaled(dtype=jnp.float32)
    cfg_t = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params = jax.tree.map(np.asarray,
                          jax_lm_init(jax.random.PRNGKey(0), cfg_j)[0])
    return (JEngine(cfg_j, jax.tree.map(jnp.asarray, params), max_len=32),
            ServeEngine(cfg_t, bridge.params_from_numpy(params, "cpu"),
                        max_len=32, device="cpu"))


def both(engines, script):
    """``script(engine, pkg, trace)`` on the JAX session (gather path) and
    the port's; the traces must agree. Returns the port's."""
    jeng, teng = engines
    traces = [[], []]
    with JA.paged_kernel_override(False):
        script(jeng, JAX, traces[0])
    script(teng, TORCH, traces[1])
    assert traces[1] == traces[0]
    return traces[1]


def _prompts(cfg, lens, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
            for L in lens]


def _toks(h):
    return [int(t) for t in h.tokens_so_far()]


def _fresh(eng, pkg, p, n):
    """The fault-free stream of one request, alone in a session."""
    with eng.session(lanes=2, page_size=8, segment=2) as sess:
        return [int(t) for t in sess.submit(p, pkg["P"](max_tokens=n))
                .result()]


def _drained_clean(sess):
    """Zero-leak oracle after drain: every page back or index-owned, the
    census exact."""
    assert sess.idle
    report = sess.audit()
    records = [r for r in sess.prefix.records.values()
               if r.page is not None] if sess.prefix is not None else []
    assert report["alloc"]["n_pages"] - 1 == report["alloc"]["n_free"] \
        + report.get("prefix", {}).get("pages", 0) + len(records)
    return report["alloc"]


# ---------------------------------------------------------------------------
# admission faults
# ---------------------------------------------------------------------------
def test_alloc_fault_fails_only_the_victim(engines):
    def script(eng, pkg, t):
        prompts = _prompts(eng.cfg, [9, 11, 7])
        inj = pkg["F"]({"page_alloc": [1]})
        with eng.session(lanes=2, page_size=8, segment=2, audit=True,
                         faults=inj, prefix_cache=False) as sess:
            hs = [sess.submit(p, pkg["P"](max_tokens=6)) for p in prompts]
            sess.run_until_idle()
            t.append((list(inj.fired), [h.status.name for h in hs],
                      [h.error for h in hs], [_toks(h) for h in hs],
                      _drained_clean(sess)))
        t.append([_fresh(eng, pkg, p, 6) for p in prompts[::2]])
    ((fired, statuses, errors, toks, _), fresh) = both(engines, script)
    assert fired == [("page_alloc", 1)]
    assert statuses == ["DONE", "FAILED", "DONE"]
    assert errors[1] == "injected:page_alloc" and toks[1] == []
    assert toks[::2] == fresh


def test_fork_fault_contained_and_next_hit_serves(engines):
    def script(eng, pkg, t):
        (p,) = _prompts(eng.cfg, [13])   # 13 % 8 != 0: a boundary-page fork
        inj = pkg["F"]({"fork_page": [0]})
        with eng.session(lanes=2, page_size=8, segment=2, audit=True,
                         faults=inj, prefix_cache=True) as sess:
            hs = []
            for _ in range(3):
                hs.append(sess.submit(p, pkg["P"](max_tokens=6)))
                sess.run_until_idle()
            t.append((list(inj.fired), [h.status.name for h in hs],
                      [h.error for h in hs], [_toks(h) for h in hs],
                      dict(sess.prefix.stats), _drained_clean(sess)))
    ((fired, statuses, errors, toks, _, _),) = both(engines, script)
    assert fired == [("fork_page", 0)]
    assert statuses == ["DONE", "FAILED", "DONE"]
    assert errors[1] == "injected:fork_page" and toks[2] == toks[0]


# ---------------------------------------------------------------------------
# decode-segment faults
# ---------------------------------------------------------------------------
def test_kernel_dispatch_fault_keeps_every_stream(engines):
    """Injected dispatch faults on the first two segments: no victim, every
    stream the fault-free one (the port re-issues the segment on its own
    routes; the JAX package serves it through its gather path)."""
    def script(eng, pkg, t):
        prompts = _prompts(eng.cfg, [10, 12])
        inj = pkg["F"]({"kernel_dispatch": [0, 1]})
        with eng.session(lanes=2, page_size=8, segment=2, audit=True,
                         faults=inj, prefix_cache=False) as sess:
            hs = [sess.submit(p, pkg["P"](max_tokens=8)) for p in prompts]
            sess.run_until_idle()
            t.append((list(inj.fired), [h.status.name for h in hs],
                      [_toks(h) for h in hs], _drained_clean(sess)))
        t.append([_fresh(eng, pkg, p, 8) for p in prompts])
    ((fired, statuses, toks, _), fresh) = both(engines, script)
    assert [s for s, _ in fired] == ["kernel_dispatch"] * 2
    assert statuses == ["DONE", "DONE"] and toks == fresh


def test_kernel_dispatch_fault_redispatches_once(engines):
    """The port's containment: the faulted segment is issued once on the
    same routes as any other and counted; no segment runs twice and no
    other path is taken."""
    _, teng = engines
    (p,) = _prompts(teng.cfg, [10])
    inj = FaultInjector({"kernel_dispatch": [0]})
    with teng.session(lanes=2, page_size=8, segment=2, audit=True,
                      faults=inj) as sess:
        h = sess.submit(p, SamplingParams(max_tokens=8))
        sess.run_until_idle()
        assert sess.work["redispatched_segments"] == 1
        assert sess.work["decode_steps"] == 8     # 4 segments, none repeated
        assert h.status.name == "DONE"


def test_pool_loss_contains_all_actives_then_recovers(engines, monkeypatch):
    """A REAL exception inside the segment: every active request FAILS with
    the typed reason, the first tokens kept, the audit clean; the session
    then serves on a fresh pool."""
    def script(eng, pkg, t):
        prompts = _prompts(eng.cfg, [9, 11])
        with eng.session(lanes=2, page_size=8, segment=3, audit=True,
                         prefix_cache=False) as sess:
            hs = [sess.submit(p, pkg["P"](max_tokens=6)) for p in prompts]
            sess.step()                  # admissions only

            def broken(*a, **k):
                raise RuntimeError("device lost")

            if pkg is JAX:
                monkeypatch.setattr(
                    eng, "_build_batch_segment",
                    lambda segment, sampled: broken)
            else:
                monkeypatch.setattr(eng, "decode_step", broken)
            sess.step()
            t.append(([h.status.name for h in hs], [h.error for h in hs],
                      [_toks(h) for h in hs], _drained_clean(sess)))
            monkeypatch.undo()
            again = sess.submit(prompts[0], pkg["P"](max_tokens=6))
            sess.run_until_idle()
            t.append((again.status.name, _toks(again), _drained_clean(sess)))
        t.append(_fresh(eng, pkg, prompts[0], 6))
    ((statuses, errors, toks, _), (status, again, _), fresh) = \
        both(engines, script)
    assert statuses == ["FAILED", "FAILED"]
    assert errors == ["pool-lost:RuntimeError: device lost"] * 2
    assert [len(x) for x in toks] == [1, 1]
    assert status == "DONE" and again == fresh


def test_device_oom_fails_newest_keeps_coresidents_identical(engines):
    def script(eng, pkg, t):
        prompts = _prompts(eng.cfg, [9, 11])
        inj = pkg["F"]({"device_oom": [0]})
        with eng.session(lanes=2, page_size=8, segment=2, audit=True,
                         faults=inj, prefix_cache=False) as sess:
            hs = [sess.submit(p, pkg["P"](max_tokens=6)) for p in prompts]
            sess.run_until_idle()
            t.append((list(inj.fired), [h.status.name for h in hs],
                      [h.error for h in hs], [_toks(h) for h in hs],
                      _drained_clean(sess)))
            again = sess.submit(prompts[1], pkg["P"](max_tokens=6))
            sess.run_until_idle()
            t.append((again.status.name, _toks(again)))
        t.append([_fresh(eng, pkg, p, 6) for p in prompts])
    ((fired, statuses, errors, toks, _), (status, again), fresh) = \
        both(engines, script)
    assert fired == [("device_oom", 0)]
    assert statuses == ["DONE", "FAILED"]
    assert errors[1] == "oom:decode-segment" and len(toks[1]) == 1
    assert toks[0] == fresh[0] and (status, again) == ("DONE", fresh[1])


def test_device_oom_sole_request_terminal_and_clean(engines):
    def script(eng, pkg, t):
        (p,) = _prompts(eng.cfg, [9])
        inj = pkg["F"]({"device_oom": [0]})
        with eng.session(lanes=2, page_size=8, segment=2, audit=True,
                         faults=inj, prefix_cache=False) as sess:
            h = sess.submit(p, pkg["P"](max_tokens=6))
            sess.run_until_idle()
            t.append((h.status.name, h.error, list(inj.fired),
                      _drained_clean(sess)))
    ((status, error, fired, _),) = both(engines, script)
    assert (status, error) == ("FAILED", "oom:decode-segment")
    assert all(site != "shard_loss" for site, _ in fired)


# ---------------------------------------------------------------------------
# prefix-index corruption
# ---------------------------------------------------------------------------
def test_index_corruption_quarantines_and_serves_cold(engines):
    def script(eng, pkg, t):
        (p,) = _prompts(eng.cfg, [12])
        inj = pkg["F"]()
        with eng.session(lanes=2, page_size=8, segment=2, audit=False,
                         faults=inj, prefix_cache=True) as sess:
            hs = [sess.submit(p, pkg["P"](max_tokens=6))]
            sess.run_until_idle()
            assert sess.prefix.owned_pages > 0
            inj.arm("prefix_index", at=inj._count.get("prefix_index", 0))
            for _ in range(2):
                hs.append(sess.submit(p, pkg["P"](max_tokens=6)))
                sess.run_until_idle()
            t.append((sess.prefix.quarantined,
                      sess.prefix.stats["quarantines"],
                      sess.prefix.owned_pages, [h.status.name for h in hs],
                      [_toks(h) for h in hs], _drained_clean(sess)))
    ((quarantined, n_q, owned, statuses, toks, _),) = both(engines, script)
    assert quarantined and n_q == 1 and owned == 0
    assert statuses == ["DONE"] * 3 and toks[1] == toks[2] == toks[0]


def test_reclaim_sweep_contains_index_corruption(engines):
    """Corruption no lookup has walked must not crash the RECLAIM sweep:
    the sweep detects it, quarantines, and admits cold."""
    def script(eng, pkg, t):
        a, b = _prompts(eng.cfg, [12, 12])
        b[0] = (a[0] + 1) % eng.cfg.vocab_size
        inj = pkg["F"]()
        with eng.session(lanes=1, page_size=8, n_pages=4, segment=2,
                         audit=True, faults=inj, prefix_cache=True) as sess:
            first = sess.submit(a, pkg["P"](max_tokens=6))
            sess.run_until_idle()
            assert sess.sched.alloc.n_free < 3
            inj.arm("prefix_index", at=inj._count.get("prefix_index", 0))
            second = sess.submit(b, pkg["P"](max_tokens=6))
            sess.run_until_idle()
            t.append((sorted(set(s for s, _ in inj.fired)),
                      sess.prefix.quarantined,
                      sess.prefix.stats["quarantines"],
                      sess.prefix.owned_pages, first.status.name,
                      second.status.name, _toks(second),
                      _drained_clean(sess)))
        t.append(_fresh(eng, pkg, b, 6))
    ((sites, quarantined, n_q, owned, s1, s2, toks, _), fresh) = \
        both(engines, script)
    assert "prefix_index" in sites and quarantined and n_q == 1
    assert owned == 0 and (s1, s2) == ("DONE", "DONE") and toks == fresh


# ---------------------------------------------------------------------------
# deadlines, queue overflow
# ---------------------------------------------------------------------------
def test_deadline_expires_mid_flight_and_frees_resources(engines):
    def script(eng, pkg, t):
        now = [0.0]
        prompts = _prompts(eng.cfg, [9, 9])
        with eng.session(lanes=2, page_size=8, segment=2, audit=True,
                         prefix_cache=False, clock=lambda: now[0]) as sess:
            doomed = sess.submit(prompts[0], pkg["P"](max_tokens=12,
                                                      deadline_ms=100.0))
            fine = sess.submit(prompts[1], pkg["P"](max_tokens=6))
            sess.step()
            sess.step()
            partial = doomed.tokens_ready
            t.append((doomed.status.name, partial))
            now[0] = 101.0
            sess.run_until_idle()
            t.append((doomed.status.name, doomed.error, _toks(doomed),
                      fine.status.name, _toks(fine), _drained_clean(sess)))
    ((s0, partial), (status, error, toks, s_fine, fine, _)) = \
        both(engines, script)
    assert s0 == "DECODING" and partial >= 1
    assert (status, error) == ("EXPIRED", "deadline")
    assert partial <= len(toks) < 12 and s_fine == "DONE" and len(fine) == 6


def test_unmeetable_deadline_sheds_without_compute(engines):
    def script(eng, pkg, t):
        now = [0.0]
        prompts = _prompts(eng.cfg, [9, 9])
        with eng.session(lanes=1, page_size=8, segment=2, audit=True,
                         prefix_cache=False, clock=lambda: now[0]) as sess:
            blocker = sess.submit(prompts[0], pkg["P"](max_tokens=6))
            late = sess.submit(prompts[1], pkg["P"](max_tokens=6,
                                                    deadline_ms=50.0))
            sess.step()
            now[0] = 60.0
            sess.run_until_idle()
            t.append((late.status.name, late.error, _toks(late),
                      blocker.status.name, dict(sess.sched.stats),
                      _drained_clean(sess)))
    ((status, error, toks, s_block, _, _),) = both(engines, script)
    assert (status, error, toks, s_block) == ("SHED", "deadline", [], "DONE")


def test_queue_overflow_sheds_in_admission_time(engines):
    def script(eng, pkg, t):
        prompts = _prompts(eng.cfg, [9, 9, 9])
        with eng.session(lanes=1, page_size=8, segment=2, audit=True,
                         prefix_cache=False, max_pending=1) as sess:
            ok = sess.submit(prompts[0], pkg["P"](max_tokens=4))
            sess.step()
            queued = sess.submit(prompts[1], pkg["P"](max_tokens=4))
            with pytest.raises(pkg["Shed"]) as ei:
                sess.submit(prompts[2], pkg["P"](max_tokens=4))
            sess.run_until_idle()
            t.append((ei.value.reason, str(ei.value), ok.status.name,
                      queued.status.name, _toks(ok), _toks(queued),
                      _drained_clean(sess)))
    ((reason, _, s_ok, s_q, _, _, _),) = both(engines, script)
    assert (reason, s_ok, s_q) == ("queue-full", "DONE", "DONE")


# ---------------------------------------------------------------------------
# strict REPRO_FAULTS parsing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Inj", [JFaults, FaultInjector],
                         ids=["jax", "torch"])
def test_from_env_rejects_unknown_sites_and_bad_indices(Inj):
    for spec, match in (("page_alloc@1,not_a_site@0", "unknown fault site"),
                        ("page_alloc@1,,kernel_dispatch@0", "empty entry"),
                        ("page_alloc@x", "bad poll index"),
                        ("page_alloc@-3", "negative")):
        with pytest.raises(ValueError, match=match):
            Inj.from_env(spec)
    assert Inj.from_env("") is None and Inj.from_env("   ") is None
    inj = Inj.from_env(" kernel_dispatch , page_alloc@2 ")
    assert [inj.should_fire("kernel_dispatch")] + \
        [inj.should_fire("page_alloc") for _ in range(3)] \
        == [True, False, False, True]


def test_constructor_and_arm_reject_unknown_sites_as_jax_does():
    from repro.serve.faults import SITES as JSITES
    from repro_torch.serve.faults import SITES

    assert SITES == JSITES
    for Inj in (JFaults, FaultInjector):
        with pytest.raises(ValueError, match="unknown fault site"):
            Inj({"not_a_site": [0]})
        with pytest.raises(ValueError, match="unknown fault site"):
            Inj().arm("also_bad", at=1)


# ---------------------------------------------------------------------------
# fault-free hardened traffic
# ---------------------------------------------------------------------------
def test_audit_clean_under_churn(engines):
    def script(eng, pkg, t):
        prompts = _prompts(eng.cfg, [9, 11, 7, 13, 10])
        with eng.session(lanes=2, page_size=8, segment=2, audit=True,
                         prefix_cache=True) as sess:
            hs = [sess.submit(p, pkg["P"](max_tokens=5))
                  for p in prompts[:3]]
            sess.step()
            sess.step()
            victim = next(h for h in hs if h.status.name == "DECODING")
            victim.cancel()
            hs += [sess.submit(p, pkg["P"](max_tokens=5))
                   for p in prompts[3:]]
            sess.run_until_idle()
            t.append((victim.rid, [h.status.name for h in hs],
                      [_toks(h) for h in hs], _drained_clean(sess)))
    ((victim, statuses, _, _),) = both(engines, script)
    assert all(s == "DONE" for i, s in enumerate(statuses) if i != victim)


# ---------------------------------------------------------------------------
# the checkpoint drill: ckpt_corrupt
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("at", [0, 1])
def test_ckpt_corrupt_drill_matches_jax(tmp_path, at):
    """An armed ``ckpt_corrupt`` flips a byte of the ``at``-th leaf read
    before the crc walk: both packages raise their typed corruption error
    on the same checkpoint (one written by the JAX package), fire at the
    same poll, and restore clean on the retry (the file is untouched);
    ``CheckpointManager.restore_latest`` passes ``faults`` through."""
    from repro.checkpoint.manager import CheckpointCorruption as JCorrupt
    from repro.checkpoint.manager import restore_pytree as j_restore
    from repro.checkpoint.manager import save_pytree as j_save
    from repro_torch.checkpoint.manager import (CheckpointCorruption,
                                                CheckpointManager,
                                                restore_pytree)

    rng = np.random.default_rng(3)
    tree = {"w": rng.choice([-1, 1], (8, 16)).astype(np.int8),
            "b": rng.standard_normal((16,)).astype(np.float32),
            "s": {"m": rng.standard_normal((4, 4)).astype(np.float32)}}
    j_save(jax.tree.map(jnp.asarray, tree), tmp_path, step=5, sync=True)
    ttree = {"w": torch.from_numpy(tree["w"]), "b": torch.from_numpy(tree["b"]),
             "s": {"m": torch.from_numpy(tree["s"]["m"])}}
    fired = []
    for restore, tpl, Err, Inj in (
            (j_restore, jax.tree.map(jnp.asarray, tree), JCorrupt, JFaults),
            (restore_pytree, ttree, CheckpointCorruption, FaultInjector)):
        inj = Inj({"ckpt_corrupt": [at]})
        with pytest.raises(Err) as e:
            restore(tpl, tmp_path, faults=inj)
        fired.append((inj.fired, e.value.key))
    assert fired[0] == fired[1]
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(CheckpointCorruption):
        mgr.restore_latest(ttree, faults=FaultInjector({"ckpt_corrupt": [at]}))
    restored, step = mgr.restore_latest(ttree)
    assert step == 5
    for k in ("w", "b"):
        assert torch.equal(restored[k], ttree[k])
    assert torch.equal(restored["s"]["m"], ttree["s"]["m"])
