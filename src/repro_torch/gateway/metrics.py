"""Prometheus-text metrics surface for the serving gateway.

A copy of the JAX package's ``gateway/metrics.py``, series for series and
bound for bound: for the same traffic, ``/metrics`` renders the same names,
labels and counts as the JAX gateway. The port's ``stats()`` also carries a
``work`` key (device work counters); no series reads it.

Two kinds of series share one exposition:

  * REQUEST-LEVEL series owned by the gateway — HTTP request/stream
    counters labelled by path/code/outcome/reason, and the TTFT and
    inter-token latency histograms observed by the step driver (the only
    place first-token and segment-arrival times are visible);
  * SERVE-LEVEL series scraped live from ``ServeSession.stats()`` at
    render time — scheduler lifecycle counters, queue/lane occupancy,
    pool-page occupancy, and the prefix-cache counters. These are never
    duplicated into gateway state: the session's own books are the single
    source of truth, and ``render()`` just reads them.

Everything is stdlib: the text format (version 0.0.4 — ``# HELP`` /
``# TYPE`` / ``name{labels} value``) is simple enough that a client
library would be pure weight. Mutation is lock-guarded because the step
thread (histograms, stream outcomes) and the asyncio event-loop thread
(HTTP counters) both write.
"""
from __future__ import annotations

import math
import threading
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

#: default histogram bounds (seconds). TTFT spans prefill latencies (ms on
#: smoke CPU configs, potentially seconds under queueing); inter-token
#: spans per-step decode latencies. Both end with +Inf implicitly.
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0)
ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
               0.25, 0.5, 1.0)


def _fmt(v) -> str:
    """Prometheus value formatting: integers bare, floats shortest-round-
    trip, infinities as +Inf/-Inf."""
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Histogram:
    """Cumulative-bucket histogram (the Prometheus shape): ``observe``
    is O(buckets); ``quantile`` interpolates within the winning bucket —
    good enough for the replay harness's p50/p99 without storing samples."""

    def __init__(self, bounds: Iterable[float]):
        self.bounds: Tuple[float, ...] = tuple(sorted(bounds))
        self.counts = [0] * (len(self.bounds) + 1)      # last = +Inf
        self.sum = 0.0
        self.n = 0

    def observe(self, v: float, n: int = 1) -> None:
        i = len(self.bounds)
        for j, b in enumerate(self.bounds):
            if v <= b:
                i = j
                break
        self.counts[i] += n
        self.sum += v * n
        self.n += n

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile from the cumulative buckets;
        the +Inf bucket clamps to the last finite bound."""
        if self.n == 0:
            return 0.0
        target = q * self.n
        cum = 0
        lo = 0.0
        for j, b in enumerate(self.bounds):
            nxt = cum + self.counts[j]
            if nxt >= target:
                frac = (target - cum) / max(self.counts[j], 1)
                return lo + frac * (b - lo)
            cum, lo = nxt, b
        return self.bounds[-1] if self.bounds else 0.0

    def render(self, name: str, help_: str,
               labels: Optional[dict] = None) -> List[str]:
        out = [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
        cum = 0
        for j, b in enumerate(self.bounds):
            cum += self.counts[j]
            lab = dict(labels or {})
            lab["le"] = _fmt(float(b))
            out.append(f"{name}_bucket{_labels(lab)} {cum}")
        lab = dict(labels or {})
        lab["le"] = "+Inf"
        out.append(f"{name}_bucket{_labels(lab)} {self.n}")
        out.append(f"{name}_sum{_labels(labels)} {_fmt(self.sum)}")
        out.append(f"{name}_count{_labels(labels)} {self.n}")
        return out


def _counter(name: str, help_: str, value, labels=None) -> List[str]:
    return [f"# HELP {name} {help_}", f"# TYPE {name} counter",
            f"{name}{_labels(labels)} {_fmt(value)}"]


def _gauge(name: str, help_: str, value, labels=None) -> List[str]:
    return [f"# HELP {name} {help_}", f"# TYPE {name} gauge",
            f"{name}{_labels(labels)} {_fmt(value)}"]


def _labelled_counter(name: str, help_: str, series: Dict[tuple, int],
                      keys: Tuple[str, ...]) -> List[str]:
    out = [f"# HELP {name} {help_}", f"# TYPE {name} counter"]
    for lv in sorted(series):
        out.append(f"{name}{_labels(dict(zip(keys, lv)))} {series[lv]}")
    return out


class GatewayMetrics:
    """All gateway-owned series + the render that folds the live session
    counters in. One instance per gateway; thread-safe.

    Per-tenant labelling is CARDINALITY-BOUNDED: the first ``max_tenants``
    distinct tenant names get their own label value; every later tenant
    aggregates under ``tenant="other"`` — an adversarial (or buggy)
    client minting fresh tenant names per request cannot grow the
    exposition without bound. The unlabelled aggregate series are
    unchanged; tenants add ``gateway_ttft_by_tenant_seconds`` and
    ``gateway_shed_by_tenant_total``."""

    def __init__(self, max_tenants: int = 8):
        self._lock = threading.Lock()
        self.max_tenants = int(max_tenants)
        self._tenants: set = set()                  # names with own label
        self.http_requests: Counter = Counter()     # (path, code) -> n
        self.shed: Counter = Counter()              # (reason,) -> n
        self.shed_tenant: Counter = Counter()       # (reason, tenant) -> n
        self.streams: Counter = Counter()           # (outcome,) -> n
        self.tokens_streamed = 0
        self.watchdog_trips = 0
        self.requests_with_id = 0
        self.request_id_conflicts = 0
        self.ttft = Histogram(TTFT_BUCKETS)
        self.ttft_tenant: Dict[str, Histogram] = {}
        self.inter_token = Histogram(ITL_BUCKETS)

    def _tenant_label(self, tenant: Optional[str]) -> str:
        """Label value for ``tenant`` under the cardinality bound.
        Callers hold ``self._lock``."""
        t = tenant if tenant else "default"
        if t in self._tenants:
            return t
        if len(self._tenants) < self.max_tenants:
            self._tenants.add(t)
            return t
        return "other"

    # -- recording hooks (step thread + event-loop thread) -------------------
    def observe_http(self, path: str, code: int) -> None:
        with self._lock:
            self.http_requests[(path, str(code))] += 1

    def observe_shed(self, reason: str,
                     tenant: Optional[str] = None) -> None:
        with self._lock:
            self.shed[(reason,)] += 1
            self.shed_tenant[(reason, self._tenant_label(tenant))] += 1

    def observe_stream_end(self, outcome: str) -> None:
        with self._lock:
            self.streams[(outcome,)] += 1

    def observe_watchdog_trip(self) -> None:
        with self._lock:
            self.watchdog_trips += 1

    def observe_request_id(self) -> None:
        with self._lock:
            self.requests_with_id += 1

    def observe_request_id_conflict(self) -> None:
        with self._lock:
            self.request_id_conflicts += 1

    def observe_ttft(self, seconds: float,
                     tenant: Optional[str] = None) -> None:
        with self._lock:
            self._observe_ttft(seconds, tenant)

    def _observe_ttft(self, seconds: float, tenant: Optional[str]) -> None:
        self.ttft.observe(seconds)
        t = self._tenant_label(tenant)
        h = self.ttft_tenant.get(t)
        if h is None:
            h = self.ttft_tenant[t] = Histogram(TTFT_BUCKETS)
        h.observe(seconds)

    def observe_inter_token(self, seconds: float, n: int = 1) -> None:
        with self._lock:
            self.inter_token.observe(seconds, n)
            self.tokens_streamed += n

    def observe_first_token(self, ttft_s: float,
                            tenant: Optional[str] = None) -> None:
        with self._lock:
            self._observe_ttft(ttft_s, tenant)
            self.tokens_streamed += 1

    # -- exposition ----------------------------------------------------------
    def render(self, session_stats: Optional[dict] = None) -> str:
        """The full Prometheus-text page: gateway series + (when a session
        snapshot is given) the serve-level series scraped from it."""
        with self._lock:
            out: List[str] = []
            out += _labelled_counter(
                "gateway_http_requests_total",
                "HTTP requests served, by path and status code",
                dict(self.http_requests), ("path", "code"))
            out += _labelled_counter(
                "gateway_shed_total",
                "Admission rejections surfaced over HTTP, by reason",
                dict(self.shed), ("reason",))
            out += _labelled_counter(
                "gateway_streams_total",
                "SSE token streams finished, by terminal outcome",
                dict(self.streams), ("outcome",))
            out += _counter("gateway_tokens_streamed_total",
                            "Tokens emitted across all SSE streams",
                            self.tokens_streamed)
            out += _counter("gateway_watchdog_trips_total",
                            "Step-driver watchdog trips (degraded mode)",
                            self.watchdog_trips)
            out += _counter("gateway_requests_with_id_total",
                            "Submits carrying a client request_id",
                            self.requests_with_id)
            out += _counter("gateway_request_id_conflicts_total",
                            "Duplicate request_id submits refused with 409",
                            self.request_id_conflicts)
            out += self.ttft.render(
                "gateway_ttft_seconds",
                "Submit-to-first-token latency (emission at admission)")
            out += self.inter_token.render(
                "gateway_inter_token_seconds",
                "Per-token gap between decode-segment arrivals")
            if self.shed_tenant:
                out += _labelled_counter(
                    "gateway_shed_by_tenant_total",
                    "Admission rejections by reason and (bounded) tenant",
                    dict(self.shed_tenant), ("reason", "tenant"))
            if self.ttft_tenant:
                name = "gateway_ttft_by_tenant_seconds"
                out += [f"# HELP {name} Submit-to-first-token latency "
                        "by (bounded) tenant",
                        f"# TYPE {name} histogram"]
                for t in sorted(self.ttft_tenant):
                    out += self.ttft_tenant[t].render(
                        name, "", {"tenant": t})[2:]
        if session_stats is not None:
            out += self._render_session(session_stats)
        return "\n".join(out) + "\n"

    @staticmethod
    def _render_session(st: dict) -> List[str]:
        out: List[str] = []
        sched = st["sched"]
        for key, help_ in (
                ("admitted", "Requests admitted into decode lanes"),
                ("shed", "Requests rejected by admission control"),
                ("expired", "Requests expired past their deadline"),
                ("failed", "Requests terminally failed by fault containment"),
                ("preemptions", "Lane preemptions by higher priority"),
                ("preempt_swap", "Preemptions captured to the host tier"),
                ("preempt_recompute",
                 "Preemptions falling back to recompute-on-resume"),
                ("quota_rejections", "Sheds caused by per-tenant quotas")):
            out += _counter(f"serve_sched_{key}_total", help_,
                            sched.get(key, 0))
        out += _gauge("serve_pending_requests",
                      "Requests queued, not yet admitted", st["pending"])
        out += _gauge("serve_active_requests",
                      "Requests live in decode lanes", st["active"])
        out += _gauge("serve_lanes_total", "Decode lanes in the fixed pool",
                      st["lanes"])
        pool = st["pool"]
        out += _gauge("serve_pool_pages_total",
                      "Physical cache pages (incl. reserved garbage page)",
                      pool["n_pages"])
        out += _gauge("serve_pool_pages_free", "Allocatable pages free now",
                      pool["n_free"])
        out += _gauge("serve_pool_pages_owned",
                      "Pages held by requests or the prefix index",
                      pool["n_owned"])
        pfx = st.get("prefix")
        if pfx is not None:
            for key, help_ in (
                    ("lookups", "Prefix-index lookups at admission"),
                    ("exact_hits", "Exact-record hits (zero prefill)"),
                    ("partial_hits", "Partial hits (tail-only prefill)"),
                    ("misses", "Cold misses (full prefill)"),
                    ("hit_tokens", "Prompt tokens served from cached pages"),
                    ("prompt_tokens", "Prompt tokens across all admissions"),
                    ("inserted_pages", "Pages donated into the index"),
                    ("evicted_pages", "Pages LRU-reclaimed under pressure"),
                    ("cow_forks", "Copy-on-write boundary-page forks"),
                    ("quarantines", "Index corruption quarantines"),
                    ("demoted_pages",
                     "Index pages demoted to the host tier under pressure"),
                    ("promoted_pages",
                     "Host-resident pages promoted back to HBM on a hit")):
                out += _counter(f"serve_prefix_{key}_total", help_,
                                pfx.get(key, 0))
        swp = st.get("swap")
        if swp is not None:
            for key, help_ in (
                    ("swap_outs", "Page-set captures written to host RAM"),
                    ("swap_ins", "Page-set restores read back into HBM"),
                    ("swap_out_bytes", "Bytes migrated HBM->host"),
                    ("swap_in_bytes", "Bytes migrated host->HBM"),
                    ("slot_alloc_failures",
                     "Host slot allocations refused (budget/fault)")):
                out += _counter(f"serve_{key}_total", help_, swp[key])
            out += _gauge("serve_host_pages_total",
                          "Host-tier page slots configured", swp["host_pages"])
            out += _gauge("serve_host_pages_used",
                          "Host-tier page slots holding data",
                          swp["host_used"])
            out += _gauge("serve_host_pages_free",
                          "Host-tier page slots free now", swp["host_free"])
            out += _gauge("serve_swap_page_bytes",
                          "Bytes per page across all cache leaves",
                          swp["page_bytes"])
        mesh = st.get("mesh")
        if mesh is not None:
            out += _gauge("serve_mesh_shards_total",
                          "Tensor-parallel shards in the serve mesh",
                          mesh["shards"])
            out += _counter("serve_mesh_shard_loss_events_total",
                            "Simulated shard-loss drills contained",
                            mesh["shard_loss_events"])
            out += _gauge("serve_mesh_healthy",
                          "1 while no shard has been lost, else 0",
                          1 if mesh["healthy"] else 0)
        return out
