"""The port's overload control against the JAX package's: host bookkeeping
only, no model compute but the launcher cases.

Each case runs ONE operation script through both packages' ``Scheduler`` /
``PageAllocator`` / ``PrefixCache`` / reason table (the JAX package's
``tests/test_overload.py``, case for case) and checks that both decide the
same: the same admitted rids, victims, statuses, reason strings, free pages
and counters, recorded into a trace the two runs must produce identically.
The script's own assertions hold on each package too. The launcher cases run
``repro_torch.launch.serve`` and ``repro.launch.serve`` with the overload,
swap-tier and chaos flags on a smoke arch and compare every line that does
not carry token values (the two packages draw different random weights).
"""
import sys
import types

import numpy as np
import pytest

import repro.serve as JS
import repro.serve.faults as JF
import repro.serve.scheduler as JSch
import repro_torch.serve as TS
import repro_torch.serve.scheduler as TSch


def _ns(serve, sched):
    return types.SimpleNamespace(
        PageAllocator=serve.PageAllocator, PrefixCache=serve.PrefixCache,
        Request=serve.Request, RequestStatus=serve.RequestStatus,
        SamplingParams=serve.SamplingParams, Scheduler=serve.Scheduler,
        ShedError=serve.ShedError, reasons=serve.reasons,
        TERMINAL=sched.TERMINAL, FaultInjector=serve.FaultInjector)


JAX, TORCH = _ns(JS, JSch), _ns(TS, TSch)
assert JF.FaultInjector is JS.FaultInjector


def both(script):
    """Run ``script(ns, trace)`` on each package; the traces must agree."""
    traces = []
    for ns in (JAX, TORCH):
        trace = []
        script(ns, trace)
        traces.append(trace)
    assert traces[0] == traces[1], traces
    return traces[1]


def _req(ns, rid, S=4, n=4, **kw):
    return ns.Request(rid, np.arange(S, dtype=np.int32),
                      ns.SamplingParams(max_tokens=n, **kw))


def _rids(reqs):
    return [r.rid for r in reqs]


# ---------------------------------------------------------------------------
# PageAllocator refcount edge cases
# ---------------------------------------------------------------------------
def test_double_free_raises_and_never_goes_negative():
    def script(ns, t):
        a = ns.PageAllocator(4)
        (p,) = a.alloc(1)
        assert a.decref(p) is True
        with pytest.raises(ValueError, match="free/garbage"):
            a.decref(p)
        assert a.refs[p] == 0
        t.append((p, list(a.refs), a.free_pages, a.audit()))
    both(script)


def test_garbage_page_is_untouchable():
    def script(ns, t):
        a = ns.PageAllocator(4)
        for op in (a.decref, a.incref):
            with pytest.raises(ValueError, match="garbage"):
                op(0)
        got = a.alloc(3)
        assert 0 not in got and a.n_free == 0 and a.refs[0] == 1
        t.append((got, a.audit()))
    both(script)


def test_over_ask_alloc_fails_atomically():
    def script(ns, t):
        a = ns.PageAllocator(6)
        t.append(a.alloc(2))
        before = a.free_pages
        with pytest.raises(ValueError, match="free"):
            a.alloc(4)
        assert a.free_pages == before
        t.append(a.alloc(3))
    both(script)


def test_audit_catches_external_census_mismatch():
    def script(ns, t):
        a = ns.PageAllocator(4)
        pages = a.alloc(2)
        t.append(a.audit(holds={pages[0]: 1, pages[1]: 1}))
        with pytest.raises(RuntimeError, match="leaked") as e:
            a.audit(holds={pages[0]: 1})
        t.append(str(e.value))
    both(script)


# ---------------------------------------------------------------------------
# typed shedding, the bounded queue, priorities
# ---------------------------------------------------------------------------
def test_page_budget_shed_error_is_debuggable_from_logs():
    def script(ns, t):
        s = ns.Scheduler(lanes=1, n_pages=4, page_size=4)
        big = _req(ns, 7, S=12, n=8)
        with pytest.raises(ns.ShedError, match="pages") as ei:
            s.check_fits(big)
        e = ei.value
        assert isinstance(e, ValueError)
        assert big.status is ns.RequestStatus.SHED
        t.append((e.reason, e.rid, str(e), big.fail_reason, s.stats["shed"]))
    both(script)


def test_bounded_queue_sheds_on_overflow():
    def script(ns, t):
        s = ns.Scheduler(lanes=1, n_pages=8, page_size=4, max_pending=2)
        s.submit(_req(ns, 0))
        s.submit(_req(ns, 1))
        with pytest.raises(ns.ShedError) as ei:
            s.submit(_req(ns, 2))
        t.append((ei.value.reason, str(ei.value), _rids(s.pending),
                  dict(s.stats)))
    both(script)


def test_priority_submit_displaces_newest_lower_priority_pending():
    def script(ns, t):
        s = ns.Scheduler(lanes=1, n_pages=8, page_size=4, max_pending=2)
        lo_old, lo_new = _req(ns, 0), _req(ns, 1)
        s.submit(lo_old)
        s.submit(lo_new)
        s.submit(_req(ns, 2, priority=5))
        assert lo_new.status is ns.RequestStatus.SHED
        t.append((lo_new.fail_reason, _rids(s.pending),
                  _rids(s.drain_shed())))
    both(script)


def test_high_priority_preempts_lower_priority_lane():
    def script(ns, t):
        s = ns.Scheduler(lanes=1, n_pages=8, page_size=4)
        lo = _req(ns, 0)
        s.submit(lo)
        t.append(_rids(s.admit()))
        hi = _req(ns, 1, priority=1)
        s.submit(hi)
        t.append(_rids(s.admit()))
        assert lo.status is ns.RequestStatus.PREEMPTED
        t.append((_rids(s.pending), dict(s.stats), lo.preemptions,
                  lo.preempt_recompute, hi.pages))
        s.finish(hi.lane)
        t.append((_rids(s.admit()), lo.pages, lo.lane))
    both(script)


def test_equal_priority_never_preempts():
    def script(ns, t):
        s = ns.Scheduler(lanes=1, n_pages=8, page_size=4)
        first = _req(ns, 0)
        s.submit(first)
        t.append(_rids(s.admit()))
        s.submit(_req(ns, 1))
        t.append(_rids(s.admit()))
        assert first.status is ns.RequestStatus.PREFILLING
        t.append(dict(s.stats))
    both(script)


# ---------------------------------------------------------------------------
# tenant quotas, fairness under churn, exactly-once accounting
# ---------------------------------------------------------------------------
def test_tenant_quota_sheds_over_footprint():
    def script(ns, t):
        s = ns.Scheduler(lanes=4, n_pages=16, page_size=4,
                         tenant_page_quota=4)
        s.submit(_req(ns, 0, tenant="a"))
        s.submit(_req(ns, 1, tenant="a"))
        with pytest.raises(ns.ShedError) as ei:
            s.submit(_req(ns, 2, tenant="a"))
        s.submit(_req(ns, 3, tenant="b"))
        t.append((ei.value.reason, str(ei.value), dict(s.stats),
                  _rids(s.pending)))
    both(script)


def test_churn_storm_cannot_starve_other_tenant():
    def script(ns, t):
        s = ns.Scheduler(lanes=1, n_pages=16, page_size=4,
                         tenant_lane_quota=1)
        a0 = _req(ns, 0, tenant="a")
        s.submit(a0)
        t.append(_rids(s.admit()))
        b = _req(ns, 1, tenant="b")
        s.submit(b)
        for rid in range(2, 10):
            with pytest.raises(ns.ShedError) as ei:
                s.submit(_req(ns, rid, tenant="a"))
            t.append((ei.value.reason, _rids(s.admit())))
        s.cancel(a0)
        resub = _req(ns, 10, tenant="a")
        s.submit(resub)
        t.append(_rids(s.admit()))
        assert b.status is ns.RequestStatus.PREFILLING
        assert resub.status is ns.RequestStatus.QUEUED
        t.append(dict(s.stats))
    both(script)


def test_cancel_returns_lane_quota_exactly_once():
    def script(ns, t):
        s = ns.Scheduler(lanes=2, n_pages=16, page_size=4,
                         tenant_lane_quota=1)
        a0 = _req(ns, 0, tenant="a")
        s.submit(a0)
        t.append(_rids(s.admit()))
        with pytest.raises(ns.ShedError):
            s.submit(_req(ns, 1, tenant="a"))
        t.append(s.cancel(a0))
        s.submit(_req(ns, 2, tenant="a"))
        t.append(s.cancel(a0))
        with pytest.raises(ns.ShedError):
            s.submit(_req(ns, 3, tenant="a"))
        t.append((s._tenant_load("a"), s.alloc.audit(), s.free_pages))
    both(script)


def test_expiry_returns_page_quota_and_pages_exactly_once():
    def script(ns, t):
        s = ns.Scheduler(lanes=2, n_pages=16, page_size=4,
                         tenant_page_quota=2)
        r = _req(ns, 0, tenant="a", deadline_ms=10.0)
        r.deadline = 100.0
        s.submit(r)
        t.append(_rids(s.admit()))
        with pytest.raises(ns.ShedError) as ei:
            s.submit(_req(ns, 1, tenant="a"))
        free_before = s.alloc.n_free
        [(lane, expired)] = s.expire(now_ms=200.0)
        assert expired is r and s.alloc.n_free == free_before + 2
        assert s.expire(now_ms=300.0) == []
        s.submit(_req(ns, 2, tenant="a"))
        t.append((ei.value.reason, lane, r.status.name, r.fail_reason,
                  s._tenant_load("a"), s.alloc.audit(), dict(s.stats)))
    both(script)


def test_preempted_request_keeps_its_quota_reservation():
    def script(ns, t):
        s = ns.Scheduler(lanes=1, n_pages=32, page_size=4,
                         tenant_page_quota=4)
        a0 = _req(ns, 0, tenant="a")
        s.submit(a0)
        t.append(_rids(s.admit()))
        s.submit(_req(ns, 1, tenant="b", priority=1))
        t.append(_rids(s.admit()))
        assert a0.status is ns.RequestStatus.PREEMPTED
        t.append(s._tenant_load("a"))
        s.submit(_req(ns, 2, tenant="a"))
        with pytest.raises(ns.ShedError):
            s.submit(_req(ns, 3, tenant="a"))
        t.append((s._tenant_load("a"), s.alloc.audit(), dict(s.stats)))
    both(script)


class _FakeSwap:
    """Host-only stand-in for the swap bridge: records every capture and
    discard so the exactly-once contract can be checked without device
    work."""

    def __init__(self, host_pages=8):
        self.host_pages = host_pages
        self.captured = []
        self.discarded = []

    def capture(self, req):
        rec = types.SimpleNamespace(slots=(len(self.captured) + 1,), pos=0,
                                    cur=0, steps=0)
        self.captured.append(rec)
        return rec

    def discard(self, rec):
        self.discarded.append(rec)

    def promote_hit(self, hit, pages):
        raise AssertionError("no prefix cache in this test")


def test_mid_swap_fail_returns_all_quota_exactly_once():
    """A request preempted WITH a swap capture whose re-admission then
    fails (an injected allocator fault): its lane, pages, tenant
    reservation and host slots each return exactly once."""
    def script(ns, t):
        fake = _FakeSwap()
        s = ns.Scheduler(lanes=1, n_pages=8, page_size=4,
                         tenant_page_quota=4,
                         faults=ns.FaultInjector({"page_alloc": [1]}),
                         swap=fake)
        a = _req(ns, 0, tenant="a")
        s.submit(a)
        t.append(_rids(s.admit()))
        free_admitted = s.alloc.n_free
        s.evict(0)
        assert a.swap is fake.captured[0]
        t.append((a.status.name, s._tenant_load("a"), a.preempt_swap))
        t.append(_rids(s.admit()))                   # alloc poll 1 fails
        assert a.status is ns.RequestStatus.FAILED
        assert fake.discarded == [fake.captured[0]] and a.swap is None
        assert s.alloc.n_free == free_admitted + 2
        t.append((a.fail_reason, _rids(s.drain_faulted()),
                  list(s.free_lanes), s._tenant_load("a"), s.alloc.audit(),
                  dict(s.stats), s.alloc.faults.fired))
        b = _req(ns, 1, tenant="a")
        s.submit(b)
        t.append(_rids(s.admit()))
    both(script)


# ---------------------------------------------------------------------------
# deadlines (hand-driven clock)
# ---------------------------------------------------------------------------
def test_unmeetable_deadline_sheds_before_admission():
    def script(ns, t):
        s = ns.Scheduler(lanes=1, n_pages=8, page_size=4)
        r = _req(ns, 0, deadline_ms=10.0)
        r.deadline = 110.0
        s.submit(r)
        t.append(_rids(s.shed_expired(now_ms=100.0, est_ms=5.0)))
        t.append(_rids(s.shed_expired(now_ms=108.0, est_ms=5.0)))
        assert r.status is ns.RequestStatus.SHED
        t.append((r.fail_reason, len(s.pending), dict(s.stats)))
    both(script)


def test_mid_flight_expiry_frees_lane_and_pages():
    def script(ns, t):
        s = ns.Scheduler(lanes=1, n_pages=8, page_size=4)
        r = _req(ns, 0, deadline_ms=50.0)
        r.deadline = 150.0
        s.submit(r)
        t.append(_rids(s.admit()))
        free_before = s.alloc.n_free
        t.append(s.expire(now_ms=140.0))
        [(lane, expired)] = s.expire(now_ms=151.0)
        assert expired is r and r.status in ns.TERMINAL
        assert s.alloc.n_free == free_before + 2
        t.append((lane, r.status.name, list(s.free_lanes),
                  s.drain_freed_lanes(), s.alloc.audit()))
    both(script)


# ---------------------------------------------------------------------------
# the reason table
# ---------------------------------------------------------------------------
def test_reason_table_wire_strings_are_pinned():
    def script(ns, t):
        r = ns.reasons
        t.append([getattr(r, k) for k in (
            "QUEUE_FULL", "TENANT_QUOTA", "PAGE_BUDGET", "DEADLINE",
            "INJECTED", "POOL_LOST", "BAD_LOGITS", "HOST_BUDGET", "OOM",
            "SHARD_LOST", "WATCHDOG")])
        assert r.SHED_REASONS <= r.ALL_REASONS
        assert {r.OOM, r.SHARD_LOST, r.WATCHDOG} \
            <= r.ALL_REASONS - r.SHED_REASONS
        composed = r.format_reason(r.POOL_LOST, "RuntimeError: x:y")
        t.append((sorted(r.SHED_REASONS), sorted(r.ALL_REASONS), composed,
                  r.base_reason(composed), r.base_reason("injected:page_alloc"),
                  r.base_reason("deadline"), r.base_reason(None)))
    trace = both(script)
    assert trace[0] == ["queue-full", "tenant-quota", "page-budget",
                        "deadline", "injected", "pool-lost", "bad-logits",
                        "host-budget", "oom", "shard-lost", "watchdog"]


def test_reason_table_http_mapping():
    def script(ns, t):
        r = ns.reasons
        t.append([r.http_for_reason(x) for x in (
            "queue-full", "tenant-quota", "deadline", "page-budget",
            "host-budget", "some-future-reason")])
        assert set(r.HTTP_STATUS) == r.SHED_REASONS
        t.append(sorted(r.HTTP_STATUS.items()))
    trace = both(script)
    assert trace[0] == [(429, 1), (429, 1), (429, 1), (503, None),
                        (429, 1), (503, None)]


def test_retry_after_scales_with_queue_depth():
    def script(ns, t):
        ra = ns.reasons.retry_after_seconds
        st = {"pending": 7, "active": 4, "lanes": 4}
        deep = {"pending": 10_000, "active": 4, "lanes": 4}
        t.append([ra("queue-full"), ra("page-budget"), ra("queue-full", st),
                  ra("host-budget", st),
                  ra("queue-full", {"pending": 0, "active": 0, "lanes": 4}),
                  ra("tenant-quota", st), ra("deadline", st),
                  ra("page-budget", st), ra("queue-full", deep),
                  ns.reasons.RETRY_AFTER_CAP,
                  ra("queue-full", {"pending": "???", "lanes": 0})])
    trace = both(script)
    assert trace[0][:3] == [1, None, 3]


def test_shed_error_only_speaks_table_reasons():
    """A typo'd reason cannot mint a wire string: both packages refuse it
    (the JAX package with an AssertionError, the port with a ValueError)."""
    def script(ns, t):
        with pytest.raises((AssertionError, ValueError)):
            ns.ShedError("qeue-full", 0, "typo")
        e = ns.ShedError(ns.reasons.QUEUE_FULL, 3, "ok")
        t.append((e.reason, e.rid, str(e)))
    both(script)


# ---------------------------------------------------------------------------
# prefix-aware hit-first admission
# ---------------------------------------------------------------------------
def _seeded_sched(ns, **kw):
    """A scheduler whose radix index holds one finished request's pages
    (prompt = arange(8)); device payloads are opaque objects."""
    cache = ns.PrefixCache(4)
    s = ns.Scheduler(lanes=1, n_pages=32, page_size=4, prefix_cache=cache,
                     **kw)
    seed = _req(ns, 0, S=8, n=2)
    s.submit(seed)
    assert _rids(s.admit()) == [0]
    seed.cache_extras = {"tokens": np.asarray(seed.effective_prompt,
                                              np.int32),
                         "offset": 0, "logits": object(), "end_ssm": {},
                         "snaps": {}}
    s.finish(seed.lane)
    return s, cache


def _hit(ns, rid):
    return ns.Request(rid, np.arange(8, dtype=np.int32),
                      ns.SamplingParams(max_tokens=2))


def test_hit_first_admits_index_hits_before_cold_misses():
    def script(ns, t):
        s, cache = _seeded_sched(ns)
        cold, hit = _req(ns, 1, S=6, n=2), _hit(ns, 2)
        s.submit(cold)
        s.submit(hit)
        t.append((_rids(s.admit()), hit.pages, cold.status.name))
        s.finish(hit.lane)
        t.append((_rids(s.admit()), cold.pages, dict(cache.stats)))
    both(script)


def test_hit_first_off_restores_strict_fcfs():
    def script(ns, t):
        s, _ = _seeded_sched(ns, hit_first=False)
        s.submit(_req(ns, 1, S=6, n=2))
        s.submit(_hit(ns, 2))
        t.append(_rids(s.admit()))
    assert both(script) == [[1]]


def test_priority_dominates_hit_affinity():
    def script(ns, t):
        s, _ = _seeded_sched(ns)
        s.submit(_hit(ns, 1))
        s.submit(_req(ns, 2, S=6, n=2, priority=1))
        t.append(_rids(s.admit()))
    assert both(script) == [[2]]


def test_hit_rank_lookup_is_side_effect_free():
    def script(ns, t):
        s, cache = _seeded_sched(ns)
        blocker = _req(ns, 1, S=6, n=2)
        s.submit(blocker)
        t.append(_rids(s.admit()))
        s.submit(_hit(ns, 2))
        before = cache.stats["lookups"]
        for _ in range(5):
            t.append(_rids(s.admit()))
        assert cache.stats["lookups"] == before
        s.finish(blocker.lane)
        t.append(_rids(s.admit()))
        assert cache.stats["lookups"] == before + 1
        t.append(dict(cache.stats))
    both(script)


# ---------------------------------------------------------------------------
# the serve launchers: overload, swap-tier and chaos flags
# ---------------------------------------------------------------------------
ARGS = ["--arch", "gemma2-2b", "--smoke", "--requests", "8", "--lanes", "2",
        "--gen", "8", "--prompt-len", "16"]


def _run_launchers(flags, capsys, monkeypatch):
    """(JAX launcher's stdout lines, the port's) for the same flags."""
    from repro.launch import serve as jax_launcher
    from repro_torch.launch import serve as launcher

    monkeypatch.setattr(sys, "argv", ["serve"] + ARGS + flags)
    jax_launcher.main()
    want = capsys.readouterr().out.splitlines()
    launcher.main(ARGS + flags + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    return want, got


def _shape(lines):
    """The lines that carry no token values or timings."""
    return [ln for ln in lines if not ln.startswith(("[serve] req",
                                                     "[serve] stream:"))
            or "left abnormally" in ln]


def test_launcher_overload_flags_match_jax(capsys, monkeypatch):
    want, got = _run_launchers(["--stream", "--audit", "--max-pending", "2",
                                "--host-pages", "32"], capsys, monkeypatch)
    assert _shape(got) == _shape(want)
    assert any("(queue-full)" in ln for ln in got)
    assert any(ln.startswith("[serve] audit clean at drain") for ln in got)
    assert any(ln.startswith("[serve] swap tier: ") for ln in got)
    # every request the queue took streamed its tokens in both
    n_streamed = [len({ln.split()[1] for ln in lines
                       if ln.startswith("[serve] req")}) for lines in (want, got)]
    assert n_streamed[0] == n_streamed[1] > 0


def test_launcher_chaos_soak_matches_jax(capsys, monkeypatch):
    want, got = _run_launchers(["--chaos-soak", "2", "--chaos-seed", "0"],
                               capsys, monkeypatch)
    assert got == want
    assert got[-1].startswith("[chaos] 2 schedules drained clean")
