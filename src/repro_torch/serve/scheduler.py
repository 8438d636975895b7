"""Re-entrant continuous-batching request scheduler — pure host bookkeeping.

The port of the JAX package's ``serve/scheduler.py``, decision for decision
(the same lanes, page ids, victims and reason strings). It owns LANES
(slots of the fixed-width decode batch), PAGES (the ref-counted
``PageAllocator``; page 0 is the garbage page) and the pending queue.
``submit`` may be called at any time; per round it can

  * admit  — pop the highest-priority pending class into free lanes while
    its FULL page budget fits (a running request never waits for memory
    mid-decode), head-of-line blocking within a class; with a
    ``PrefixCache`` attached, shared prefix pages cost a refcount and only
    the unshared tail allocates, index hits admit first within a class
    (``hit_first``), and a host-resident hit is promoted back onto device
    pages before the accounting sees it (``_ensure_resident``);
  * finish — release a completed request's lane and pages (with a prefix
    cache its prompt pages are donated to the index);
  * evict  — preempt a running request, requeued at the FRONT of the
    queue with its emitted tokens kept. With a swap tier (``swap=``,
    serve/swap.py) its page bytes and lane state are captured to host and
    re-admission restores them, so the resumed stream is bit-identical
    (``preempt_swap``); otherwise re-admission prefills prompt + emitted
    (``preempt_recompute``), the stream the engine serves for that
    effective prompt fresh;
  * cancel — drop a request wherever it is.

Overload control ends a request in one of three more TERMINAL states:
SHED (a bounded queue ``max_pending`` full with no lower-priority request
to displace, a tenant over its worst-case page or lane quota, a page budget
no pool could meet, both memory tiers committed, or a deadline unmeetable
before admission — a typed ``ShedError``), EXPIRED (past ``deadline_ms``
between segments) and FAILED (an injected or real fault contained into
this request). A higher-priority head preempts strictly lower-priority
lanes; equal priority never preempts.

The device-side mirror (block table, positions, tokens, lane keys) lives
in ``ServeSession``, which drives this object.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from . import reasons
from .faults import InjectedFault
from .paged_cache import PageAllocator, pages_for
from .prefix_cache import IndexCorruption


class RequestStatus(enum.Enum):
    QUEUED = "queued"            # submitted, waiting for a lane + pages
    PREFILLING = "prefilling"    # admitted; prompt being prefilled
    DECODING = "decoding"        # live in a decode lane
    DONE = "done"                # budget exhausted or stop token hit
    CANCELLED = "cancelled"      # dropped by the caller; partial tokens kept
    PREEMPTED = "preempted"      # evicted mid-decode; requeued at the front
    SHED = "shed"                # rejected by admission control (ShedError)
    EXPIRED = "expired"          # deadline passed mid-flight; resources freed
    FAILED = "failed"            # fault contained into this request


#: statuses a request never leaves — handle loops terminate on these.
TERMINAL = frozenset({RequestStatus.DONE, RequestStatus.CANCELLED,
                      RequestStatus.SHED, RequestStatus.EXPIRED,
                      RequestStatus.FAILED})


class ShedError(ValueError):
    """Typed admission rejection. Subclasses ``ValueError`` so existing
    capacity-validation callers (and their ``pytest.raises(ValueError)``
    contracts) keep working; ``reason`` is machine-readable and drawn from
    the ONE serve-wide table (serve/reasons.py — the same strings
    ``Request.fail_reason`` records and the HTTP gateway maps to status
    codes, so reasons cannot drift between layers):

      ``queue-full``    bounded submit queue at ``max_pending`` and no
                        lower-priority pending victim to displace
      ``page-budget``   page budget can never be satisfied by this pool
      ``tenant-quota``  tenant's worst-case pending+active footprint would
                        exceed its page or lane quota
      ``deadline``      deadline already unmeetable at admission
    """

    def __init__(self, reason: str, rid: int, msg: str):
        if reason not in reasons.SHED_REASONS:
            raise ValueError(f"unknown shed reason {reason!r}")
        self.reason = reason
        self.rid = rid
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling state, threaded through the decode lanes.

    temperature <= 0 decodes greedily; > 0 samples from the request's own
    stream — ``PRNGKey(seed)`` when ``seed`` is given, else the session key
    folded with the request id (independent of lane placement either way).
    ``stop_token`` finishes the request early, releasing its lane + pages
    before ``max_tokens``; the stop token itself is the last token emitted.

    Overload-control knobs: ``deadline_ms`` is a RELATIVE budget (wall
    milliseconds from submit) — the session stamps the absolute deadline
    at submit time; unmeetable at admission → SHED, passed mid-flight →
    EXPIRED. ``priority`` ranks admission (higher first; FCFS within a
    class) and lets a request preempt strictly-lower-priority lanes.
    ``tenant`` is the accounting key for per-tenant page/lane quotas.
    """
    max_tokens: int = 16
    temperature: float = 0.0
    seed: Optional[int] = None
    stop_token: Optional[int] = None
    deadline_ms: Optional[float] = None
    priority: int = 0
    tenant: str = "default"


class Request:
    """One request's full lifecycle state; ``params`` is the single source
    of truth for its sampling and overload knobs."""

    def __init__(self, rid: int, prompt: np.ndarray, params: SamplingParams):
        self.rid = rid
        self.prompt = prompt
        self.params = params
        self.emitted: List[int] = []
        self.lane: int = -1
        self.pages: Tuple[int, ...] = ()
        self.status = RequestStatus.QUEUED
        self.stopped = False          # stop_token hit before max_tokens
        # host clock (time.perf_counter) at submit, when the session began
        # this request's latest admission work, and when its first token
        # was emitted; set by the session
        self.submitted_at: Optional[float] = None
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.seq = -1                 # global submit order (FCFS tiebreak)
        self.deadline: Optional[float] = None   # ABSOLUTE wall ms, or None
        self.fail_reason: Optional[str] = None  # why SHED/EXPIRED/FAILED
        # preemption counters, split by resume mechanism: a SWAP resume
        # restores the identical page bytes and stays bit-equal to the
        # uninterrupted stream; a RECOMPUTE resume is only
        # oracle-consistent for its EFFECTIVE prompt (Boolean sign()
        # amplifies prefill-vs-decode ulps into token flips). Consumers
        # doing stream-identity checks (traffic replay's oracle gate)
        # need the split, so the gateway surfaces both in the terminal
        # SSE event and skips only recompute-resumed streams.
        self.preempt_swap = 0
        self.preempt_recompute = 0
        # host-resident state of a swapped-out pending request (a
        # serve/swap.py SwapRecord); consumed at re-admission, discarded
        # on every terminal path (cancel / shed / admission fault).
        self.swap = None
        # prefix-cache state (all vacuous when the cache is disabled):
        # pages = shared_pages + private_pages in logical (block-table)
        # order; hit is the pinned lookup this admission rode; cache_extras
        # holds the device payload (prefill logits, SSM end/boundary
        # states) a finish donates to the index.
        self.shared_pages: Tuple[int, ...] = ()
        self.private_pages: Tuple[int, ...] = ()
        self.hit = None
        self.cache_extras = None

    @property
    def n_tokens(self) -> int:
        return self.params.max_tokens

    @property
    def temperature(self) -> float:
        return self.params.temperature

    @property
    def priority(self) -> int:
        return self.params.priority

    @property
    def tenant(self) -> str:
        return self.params.tenant

    @property
    def preemptions(self) -> int:
        """Total evictions, either resume mechanism."""
        return self.preempt_swap + self.preempt_recompute

    @property
    def done(self) -> bool:
        return self.stopped or len(self.emitted) >= self.params.max_tokens

    @property
    def effective_prompt(self) -> np.ndarray:
        """Prompt + tokens already emitted — what (re-)admission prefills.
        After an eviction this replays the generated prefix so the next
        sampled token continues exactly where the request left off."""
        if not self.emitted:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.emitted, self.prompt.dtype)])

    def __repr__(self):
        return (f"Request(rid={self.rid}, len={len(self.prompt)}, "
                f"emitted={len(self.emitted)}/{self.params.max_tokens}, "
                f"status={self.status.name})")


class Scheduler:
    def __init__(self, lanes: int, n_pages: int, page_size: int,
                 prefix_cache=None, *, max_pending: Optional[int] = None,
                 tenant_page_quota: Optional[int] = None,
                 tenant_lane_quota: Optional[int] = None, faults=None,
                 hit_first: bool = True, swap=None):
        if lanes < 1 or n_pages < 2:
            raise ValueError("need >=1 lane and >=2 pages (page 0 is the "
                             "reserved garbage page)")
        self.lanes = lanes
        self.page_size = page_size
        self.n_pages = n_pages
        self.free_lanes: Deque[int] = deque(range(lanes))
        self.alloc = PageAllocator(n_pages, faults=faults)
        self.prefix_cache = prefix_cache
        self.pending: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        # overload / fault-containment policy (None = unbounded, the
        # pre-hardening behavior every existing caller gets by default)
        self.max_pending = max_pending
        self.tenant_page_quota = tenant_page_quota
        self.tenant_lane_quota = tenant_lane_quota
        # prefix-aware admission ordering (vacuous without a prefix cache):
        # among EQUAL-priority pending requests, admit radix-index hits
        # (exact before partial) ahead of cold misses — hits prefill less
        # (or nothing), so serving them first lowers everyone's queueing
        # delay without changing any stream's tokens (admission order is
        # not an input to any request's own computation; pinned in
        # tests/test_overload.py).
        self.hit_first = hit_first
        # host swap tier (serve/swap.py SwapBridge, or None): preemption
        # captures page bytes instead of recomputing, prefix reclaim
        # demotes instead of evicting, admission faults host-resident
        # hits back in, and submit accounts BOTH memory tiers. The bridge
        # owns all device work — this core stays host-only.
        self.swap = swap
        self._seq = 0
        # drained by the session after every scheduling phase:
        self.freed_lanes: List[int] = []   # lanes _release'd since last drain
        self.faulted: List[Request] = []   # FAILED at admission (contained)
        self.shed_log: List[Request] = []  # SHED after entering the queue
        self.stats = {"admitted": 0, "shed": 0, "expired": 0, "failed": 0,
                      "preemptions": 0, "preempt_swap": 0,
                      "preempt_recompute": 0, "quota_rejections": 0}

    @property
    def free_pages(self):
        """Free-list view (tests/diagnostics); allocation goes through
        ``self.alloc`` so per-page refcounts stay the single source of
        truth."""
        return self.alloc.free_pages

    # -- queue ---------------------------------------------------------------
    def _tenant_load(self, tenant: str) -> Tuple[int, int]:
        """(requests, worst-case pages) of ``tenant``'s pending+active set.
        Quotas bound the worst case — every page a request COULD ever need
        — because admission reserves exactly that; counting live usage
        would let a tenant over-commit through queued requests."""
        reqs = [r for r in self.pending if r.tenant == tenant]
        reqs += [r for r in self.active.values() if r.tenant == tenant]
        return len(reqs), sum(self.pages_needed(r) for r in reqs)

    def _discard_swap(self, req: Request) -> None:
        """Free a swapped-out pending request's host slots — called on
        every path that terminates it before re-admission."""
        if req.swap is not None and self.swap is not None:
            self.swap.discard(req.swap)
            req.swap = None

    def _shed(self, req: Request, reason: str) -> None:
        self._discard_swap(req)
        req.status = RequestStatus.SHED
        req.fail_reason = reason
        self.stats["shed"] += 1

    def submit(self, req: Request) -> None:
        """Enqueue at any time — including while other requests decode.

        Admission control happens HERE, in O(queue) host time with zero
        compute spent: a full bounded queue (``max_pending``) sheds —
        displacing the newest strictly-lower-priority pending request if
        the submitter outranks one, else shedding the submitter with
        ``ShedError('queue-full')`` — and a tenant over its worst-case
        page/lane quota sheds with ``ShedError('tenant-quota')``.
        """
        n_lanes, n_pages = (0, 0)
        if self.tenant_lane_quota is not None \
                or self.tenant_page_quota is not None:
            n_lanes, n_pages = self._tenant_load(req.tenant)
        if self.tenant_lane_quota is not None \
                and n_lanes + 1 > self.tenant_lane_quota:
            self._shed(req, reasons.TENANT_QUOTA)
            self.stats["quota_rejections"] += 1
            raise ShedError(
                reasons.TENANT_QUOTA, req.rid,
                f"request {req.rid}: tenant {req.tenant!r} already has "
                f"{n_lanes} requests in flight (lane quota "
                f"{self.tenant_lane_quota})")
        if self.tenant_page_quota is not None \
                and n_pages + self.pages_needed(req) > self.tenant_page_quota:
            self._shed(req, reasons.TENANT_QUOTA)
            self.stats["quota_rejections"] += 1
            raise ShedError(
                reasons.TENANT_QUOTA, req.rid,
                f"request {req.rid}: tenant {req.tenant!r} worst-case "
                f"footprint {n_pages}+{self.pages_needed(req)} pages "
                f"exceeds quota {self.tenant_page_quota}")
        if self.swap is not None:
            # two-tier admission accounting: the worst-case footprint of
            # everything committed (pending + active + swapped-out) must
            # fit HBM pool + host slot budget combined — beyond that the
            # request could neither run nor park, so shed it now.
            cap = (self.n_pages - 1) + self.swap.host_pages
            committed = sum(self.pages_needed(r) for r in self.pending) \
                + sum(self.pages_needed(r) for r in self.active.values())
            if committed + self.pages_needed(req) > cap:
                self._shed(req, reasons.HOST_BUDGET)
                raise ShedError(
                    reasons.HOST_BUDGET, req.rid,
                    f"request {req.rid}: {committed}+"
                    f"{self.pages_needed(req)} worst-case pages exceeds "
                    f"the two-tier capacity {cap} ({self.n_pages - 1} "
                    f"pool + {self.swap.host_pages} host slots)")
        if self.max_pending is not None \
                and len(self.pending) >= self.max_pending:
            victim = None
            for r in self.pending:      # newest of the lowest class outranked
                if r.priority < req.priority and (
                        victim is None
                        or (r.priority, -r.seq) < (victim.priority,
                                                   -victim.seq)):
                    victim = r
            if victim is None:
                self._shed(req, reasons.QUEUE_FULL)
                raise ShedError(
                    reasons.QUEUE_FULL, req.rid,
                    f"request {req.rid}: submit queue full "
                    f"({len(self.pending)}/{self.max_pending}) and no "
                    f"lower-priority pending request to displace")
            self.pending.remove(victim)
            self._shed(victim, reasons.QUEUE_FULL)
            self.shed_log.append(victim)
        req.seq = self._seq
        self._seq += 1
        req.status = RequestStatus.QUEUED
        self.pending.append(req)

    @property
    def idle(self) -> bool:
        return not self.pending and not self.active

    def pages_needed(self, req: Request) -> int:
        # prompt rows + decode rows is invariant under eviction: emitted
        # tokens move from the token budget into the effective prompt.
        return pages_for(len(req.prompt), req.n_tokens, self.page_size)

    def check_fits(self, req: Request) -> int:
        """Raise unless the request's full page budget can EVER be met.
        The single source of truth for the admission bound — sessions call
        it at submit time (before any compute) and ``admit`` enforces the
        same rule at the queue head. Raises ``ShedError('page-budget')``
        (a ``ValueError``) carrying the rid, the requested pages, the
        pool bound, AND the current free count, so shed causes are
        debuggable straight from logs."""
        need = self.pages_needed(req)
        if need > self.n_pages - 1:
            self._shed(req, reasons.PAGE_BUDGET)
            raise ShedError(
                reasons.PAGE_BUDGET, req.rid,
                f"request {req.rid} needs {need} pages "
                f"({len(req.prompt)}+{req.n_tokens} tokens at "
                f"page_size={self.page_size}) but the pool only has "
                f"{self.n_pages - 1} allocatable "
                f"({self.alloc.n_free} free right now)")
        return need

    # -- admit / finish / evict / cancel -------------------------------------
    def _hit_rank(self, req: Request) -> int:
        """Prefix-index affinity class for admission ordering: 0 = exact
        hit (zero prefill), 1 = partial hit (tail-only prefill), 2 = cold
        miss (full prefill). Pure — ``lookup`` touches no stats or LRU
        state (``commit_hit`` does, at actual admission), so ranking the
        queue is free of side effects."""
        hit = self._lookup(req.effective_prompt)
        if hit is None:
            return 2
        return 0 if hit.exact else 1

    def _next_admissible(self) -> Request:
        """Highest-priority pending request; within the class, prefix-
        index HITS first (exact, then partial, then cold — ``hit_first``,
        on by default and vacuous without a prefix cache), FCFS in queue
        order as the tiebreak (preempted requests — requeued at the front
        — resume before their peers). Hit-first trades strict within-class
        FCFS for lower aggregate TTFT: a hit's admission costs a fraction
        of a cold prefill, so serving it first delays the cold head by
        little while saving the hit a whole queue wait; a cold request is
        still never starved by ARRIVAL order alone — only by a standing
        supply of hits, which priority classes (the fairness mechanism)
        override. All-default-priority cold traffic reduces to
        ``pending[0]``: exactly the old strict head-of-line behavior."""
        best = self.pending[0]
        for r in self.pending:
            if r.priority > best.priority:
                best = r
        if self.prefix_cache is None or not self.hit_first:
            return best
        cls = [r for r in self.pending if r.priority == best.priority]
        if len(cls) == 1:
            return best
        ranked = min(range(len(cls)),
                     key=lambda i: (self._hit_rank(cls[i]), i))
        return cls[ranked]

    def _preempt_for(self, req: Request) -> bool:
        """Evict ONE strictly-lower-priority active request to make room
        for ``req`` — lowest class first, newest within it (the least
        progress to recompute on resume, on average). Returns False when
        nothing active is outranked; the caller stops admitting — equal
        priority NEVER preempts, so default-priority traffic keeps the
        run-to-completion guarantee."""
        lane, victim = -1, None
        for ln, r in self.active.items():
            if r.priority < req.priority and (
                    victim is None
                    or (r.priority, -r.seq) < (victim.priority,
                                               -victim.seq)):
                lane, victim = ln, r
        if victim is None:
            return False
        self.evict(lane)
        return True

    def _lookup(self, tokens):
        """Prefix lookup with corruption CONTAINMENT: a checksum mismatch
        anywhere on the walked path quarantines the whole index (flush +
        bypass to cold admission) and reports a miss — admission proceeds
        with a full prefill, which is always correct."""
        if self.prefix_cache is None:
            return None
        try:
            return self.prefix_cache.lookup(tokens)
        except IndexCorruption:
            self.prefix_cache.quarantine(self.alloc)
            return None

    def _ensure_resident(self, hit):
        """Fault a host-resident hit's pages back onto device BEFORE the
        admission accounting sees it, so block tables only ever hold real
        page ids. Returns the hit (now fully device-resident) or None —
        the cold-admission fallback, taken when the tier is missing, the
        fault-in pages cannot be found, or an injected ``page_alloc`` /
        ``swap_in`` fault fires. Cold admission is always correct and the
        host copy stays intact for the next attempt."""
        n_fault = sum(1 for p in hit.pages if p < 0)
        if hit.exact and hit.record.page is not None \
                and hit.record.page < 0:
            n_fault += 1
        if n_fault == 0:
            return hit
        if self.swap is None:
            return None
        if n_fault > self.alloc.n_free and self.prefix_cache is not None:
            # pin the hit's own path so the reclaim sweep cannot demote
            # or evict the very entry being promoted
            self.prefix_cache.pin(hit.node)
            try:
                self.prefix_cache.reclaim(self.alloc,
                                          n_fault - self.alloc.n_free)
            except IndexCorruption:
                # sweep walked a corrupted node before any lookup did:
                # same containment as _lookup — quarantine + cold path
                self.prefix_cache.unpin(hit.node)
                self.prefix_cache.quarantine(self.alloc)
                return None
            self.prefix_cache.unpin(hit.node)
        if n_fault > self.alloc.n_free:
            return None
        try:
            pages = self.alloc.alloc(n_fault)
        except InjectedFault:
            return None
        try:
            self.swap.promote_hit(hit, pages)
        except InjectedFault:
            # promote_hit demoted the index back in place; the fresh
            # pages were never written, so just return them
            for p in pages:
                self.alloc.decref(p)
            return None
        return hit

    def admit(self) -> List[Request]:
        """Admit the highest-priority pending class FCFS while a lane and
        the UNSHARED page budget are free. Head-of-line blocking WITHIN a
        class is deliberate — skipping ahead would starve large requests
        forever under steady traffic; ACROSS classes a blocked high-
        priority head preempts lower-priority lanes instead of waiting
        behind bulk traffic.

        With a prefix cache, admission first looks up the longest cached
        prefix; only the uncached tail + decode pages count against the
        free list (shared pages cost an incref, not an allocation). Under
        pressure the cache reclaims LRU unpinned entries to make room; if
        even that cannot cover the tail, the head request waits — live
        requests' pins are never reclaimed, so waiting resolves as lanes
        finish, never deadlocks.

        Fault containment: an (injected) allocation failure unwinds the
        hit hold, marks the victim FAILED terminally (``faulted`` drain),
        and admission CONTINUES with the next request — page grants are
        atomic, so there is never partial state to roll back.
        """
        admitted = []
        while self.pending:
            head = self._next_admissible()
            if not self.free_lanes:
                if self._preempt_for(head):
                    continue
                break
            try:
                need = self.check_fits(head)
            except ShedError:
                self.pending.remove(head)
                raise
            # a swap-resume restores its own byte-exact pages — the index
            # walk would at best duplicate them, so skip it entirely
            hit = None if head.swap is not None \
                else self._lookup(head.effective_prompt)
            if hit is not None:
                hit = self._ensure_resident(hit)
            shared = list(hit.pages) if hit is not None else []
            private_need = need - len(shared)

            def _hold(h=hit):
                """Pin the hit path AND take the CoW-source hold before any
                reclaim can run: the record itself is always LRU-evictable,
                so without the hold a sweep could free the boundary page
                this admission is about to fork."""
                self.prefix_cache.pin(h.node)
                if h.exact and h.record.page is not None:
                    self.alloc.incref(h.record.page)

            def _drop(h=hit):
                if h.exact and h.record.page is not None:
                    self.alloc.decref(h.record.page)
                self.prefix_cache.unpin(h.node)

            if private_need > self.alloc.n_free:
                ok = False
                if self.prefix_cache is not None:
                    if hit is not None:
                        _hold()
                    try:
                        ok = self.prefix_cache.reclaim(
                            self.alloc, private_need - self.alloc.n_free)
                        if not ok and hit is not None:
                            # the hit itself may pin the last reclaimable
                            # pages (e.g. its own CoW fork source, at
                            # minimum pool size): fall back to a COLD
                            # admission — dropping the hit makes the whole
                            # unpinned index reclaimable, so an
                            # otherwise-idle pool can never livelock on
                            # its own cache
                            _drop()
                            hit, shared, private_need = None, [], need
                            ok = self.prefix_cache.reclaim(
                                self.alloc, need - self.alloc.n_free)
                    except IndexCorruption:
                        # the reclaim sweep itself walked a corrupted node
                        # (possible when corruption lands after this
                        # round's lookups — no lookup ever verified it):
                        # same containment as _lookup — quarantine, then
                        # admit COLD against whatever the flush freed
                        if hit is not None:
                            _drop()
                        self.prefix_cache.quarantine(self.alloc)
                        hit, shared, private_need = None, [], need
                        ok = need <= self.alloc.n_free
                if not ok:
                    if self._preempt_for(head):
                        continue
                    break
            elif hit is not None:
                _hold()
            try:
                private = self.alloc.alloc(private_need)
            except InjectedFault as e:
                if hit is not None:
                    _drop()
                self._discard_swap(head)
                self.pending.remove(head)
                head.status = RequestStatus.FAILED
                head.fail_reason = reasons.format_reason(reasons.INJECTED, e.site)
                self.faulted.append(head)
                self.stats["failed"] += 1
                continue
            self.pending.remove(head)
            head.lane = self.free_lanes.popleft()
            if self.prefix_cache is not None:
                self.prefix_cache.commit_hit(hit, head.effective_prompt.size)
            for p in shared:
                self.alloc.incref(p)
            head.shared_pages = tuple(shared)
            head.private_pages = tuple(private)
            head.pages = tuple(shared + private)
            head.hit = hit
            head.status = RequestStatus.PREFILLING
            self.active[head.lane] = head
            admitted.append(head)
            self.stats["admitted"] += 1
        return admitted

    def _release(self, lane: int, insert: bool = False) -> Request:
        req = self.active.pop(lane)
        self.free_lanes.append(lane)
        self.freed_lanes.append(lane)   # session drains → resets the mirror
        if self.prefix_cache is not None:
            self.prefix_cache.release(req, self.alloc, insert=insert)
        else:
            for p in req.pages:
                self.alloc.decref(p)
        req.lane, req.pages = -1, ()
        req.shared_pages = req.private_pages = ()
        return req

    def finish(self, lane: int) -> Request:
        """Release a completed request — with a prefix cache, its prompt
        pages are DONATED to the index (dedup frees byte-duplicates)
        instead of freed, so the next identical/shared prompt admits
        against them."""
        req = self._release(lane, insert=True)
        req.status = RequestStatus.DONE
        return req

    def evict(self, lane: int) -> Request:
        # capture BEFORE _release: swap-out needs req.pages and the live
        # lane mirrors; a failed capture (host budget, injected fault)
        # falls back to the recompute-preempt contract unchanged
        req = self.active[lane]
        rec = self.swap.capture(req) if self.swap is not None else None
        req = self._release(lane)
        req.status = RequestStatus.PREEMPTED
        if rec is not None:
            req.swap = rec
            req.preempt_swap += 1
            self.stats["preempt_swap"] += 1
        else:
            req.preempt_recompute += 1
            self.stats["preempt_recompute"] += 1
        self.pending.appendleft(req)     # preempted work resumes first
        self.stats["preemptions"] += 1
        return req

    def swap_resume_failed(self, req: Request) -> None:
        """Reclassify a preemption whose swap-resume hit an injected
        ``swap_in`` fault: the session falls through to the recompute
        prefill path, so the end-to-end counters must say recompute —
        they report the mechanism that actually produced the tokens."""
        req.preempt_swap -= 1
        req.preempt_recompute += 1
        self.stats["preempt_swap"] -= 1
        self.stats["preempt_recompute"] += 1

    def oom_victim(self) -> Optional[int]:
        """Lane of the NEWEST active request (max submit ``seq``) — the
        device-OOM containment victim. Failing the newest frees pages while
        the longest-waited streams keep decoding; it is also the request a
        client is most likely to simply retry. None when nothing is
        active."""
        if not self.active:
            return None
        return max(self.active, key=lambda ln: self.active[ln].seq)

    def fail(self, lane: int, reason: str) -> Request:
        """Contain a fault into the lane's request: release lane + pages
        (the cancel path) and mark it terminally FAILED with the reason.
        Partial tokens stay readable on the handle."""
        req = self._release(lane)
        req.status = RequestStatus.FAILED
        req.fail_reason = reason
        self.stats["failed"] += 1
        return req

    # -- deadlines ------------------------------------------------------------
    def shed_expired(self, now_ms: float, est_ms: float = 0.0
                     ) -> List[Request]:
        """Shed pending requests whose deadline is unmeetable: already in
        the past, or within ``est_ms`` (the session's running estimate of
        admission+prefill latency) of it. Run at the top of every step so
        a doomed request never costs a prefill."""
        out = []
        for r in list(self.pending):
            if r.deadline is not None and now_ms + est_ms > r.deadline:
                self.pending.remove(r)
                self._shed(r, reasons.DEADLINE)
                self.shed_log.append(r)
                out.append(r)
        return out

    def expire(self, now_ms: float) -> List[Tuple[int, Request]]:
        """Expire active requests past their deadline between decode
        segments — lane + pages free immediately, terminal ``EXPIRED``,
        partial tokens kept. Returns (lane, request) pairs so the session
        can reset the freed lane mirrors."""
        out = []
        for lane, r in list(self.active.items()):
            if r.deadline is not None and now_ms > r.deadline:
                self._release(lane)
                r.status = RequestStatus.EXPIRED
                r.fail_reason = reasons.DEADLINE
                self.stats["expired"] += 1
                out.append((lane, r))
        return out

    # -- session drains -------------------------------------------------------
    def drain_freed_lanes(self) -> List[int]:
        """Lanes released since the last drain (finish/evict/expire/fail/
        cancel) — the session resets their device mirrors BEFORE arming
        newly admitted requests, so a reset can never clobber a live
        lane."""
        out, self.freed_lanes = self.freed_lanes, []
        return out

    def drain_faulted(self) -> List[Request]:
        """Requests FAILED terminally at admission since the last drain."""
        out, self.faulted = self.faulted, []
        return out

    def drain_shed(self) -> List[Request]:
        """Requests shed AFTER entering the queue (displaced by priority,
        deadline-unmeetable) since the last drain — their submitters got
        no ShedError, so the session surfaces the status via handles."""
        out, self.shed_log = self.shed_log, []
        return out

    def cancel(self, req: Request) -> bool:
        """Drop ``req`` wherever it is. Active requests release their lane
        and pages immediately (freed capacity is admissible in the next
        ``admit``); pending requests just leave the queue. Returns False if
        the request already left the scheduler (done/cancelled)."""
        if req.lane >= 0 and self.active.get(req.lane) is req:
            self._release(req.lane)
        elif req in self.pending:
            self.pending.remove(req)
            self._discard_swap(req)   # cancelled before resume: free slots
        else:
            return False
        req.status = RequestStatus.CANCELLED
        return True
