"""Continuous-batching request scheduler — pure host bookkeeping.

The core of the JAX package's ``serve/scheduler.py``: LANES (slots of the
fixed-width decode batch), PAGES (the ref-counted ``PageAllocator``; page 0
is the garbage page) and the FCFS pending queue. ``submit`` may be called at
any time; ``admit`` pops the queue head into a free lane while its FULL page
budget fits (a running request never waits for memory mid-decode), with
head-of-line blocking so large requests are never starved; ``finish`` and
``cancel`` release a lane and its pages at once.

With a ``PrefixCache`` attached (serve/prefix_cache.py), admission looks up
the longest cached prefix of each request: shared pages enter the block
table at the cost of a refcount, only the UNSHARED tail allocates, and a
finishing request donates its prompt pages to the index instead of freeing
them (LRU-reclaimed under pressure). Among pending requests, index hits
admit first (exact, then partial, then cold; FCFS as the tiebreak).

Swap, preemption, priorities, tenant quotas, deadlines and fault injection
come in later slices; the port has one priority class.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from . import reasons
from .paged_cache import PageAllocator, pages_for
from .prefix_cache import IndexCorruption


class RequestStatus(enum.Enum):
    QUEUED = "queued"            # submitted, waiting for a lane + pages
    PREFILLING = "prefilling"    # admitted; prompt being prefilled
    DECODING = "decoding"        # live in a decode lane
    DONE = "done"                # budget exhausted or stop token hit
    CANCELLED = "cancelled"      # dropped by the caller; partial tokens kept
    SHED = "shed"                # rejected by admission control (ShedError)


#: statuses a request never leaves — handle loops terminate on these.
TERMINAL = frozenset({RequestStatus.DONE, RequestStatus.CANCELLED,
                      RequestStatus.SHED})


class ShedError(ValueError):
    """Typed admission rejection; ``reason`` is drawn from ``reasons``."""

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
    ``stop_token`` finishes a request early, releasing its lane and pages,
    and is itself the last token."""
    max_tokens: int = 16
    temperature: float = 0.0
    seed: Optional[int] = None
    stop_token: Optional[int] = None


class Request:
    """One request's lifecycle state."""

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
        # this request's admission work, and when its first token was
        # emitted; set by the session
        self.submitted_at: Optional[float] = None
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        # prefix-cache state (vacuous when the cache is off): pages =
        # shared_pages + private_pages in logical (block-table) order; hit
        # is the pinned lookup this admission rode; cache_extras holds what
        # a finish donates to the index (tokens, offset, end logits).
        self.shared_pages: Tuple[int, ...] = ()
        self.private_pages: Tuple[int, ...] = ()
        self.hit = None
        self.cache_extras = None

    @property
    def done(self) -> bool:
        return self.stopped or len(self.emitted) >= self.params.max_tokens

    @property
    def effective_prompt(self) -> np.ndarray:
        """What (re-)admission prefills: the prompt itself until preemption
        (which replays emitted tokens) is ported."""
        return self.prompt

    def __repr__(self):
        return (f"Request(rid={self.rid}, len={len(self.prompt)}, "
                f"emitted={len(self.emitted)}/{self.params.max_tokens}, "
                f"status={self.status.name})")


class Scheduler:
    def __init__(self, lanes: int, n_pages: int, page_size: int,
                 prefix_cache=None):
        if lanes < 1 or n_pages < 2:
            raise ValueError("need >=1 lane and >=2 pages (page 0 is the "
                             "reserved garbage page)")
        self.page_size = page_size
        self.n_pages = n_pages
        self.free_lanes: Deque[int] = deque(range(lanes))
        self.alloc = PageAllocator(n_pages)
        self.prefix_cache = prefix_cache
        self.pending: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}

    @property
    def idle(self) -> bool:
        return not self.pending and not self.active

    def pages_needed(self, req: Request) -> int:
        return pages_for(len(req.prompt), req.params.max_tokens,
                         self.page_size)

    def check_fits(self, req: Request) -> int:
        """Raise ``ShedError('page-budget')`` unless the request's full page
        budget can EVER be met by this pool; returns the budget."""
        need = self.pages_needed(req)
        if need > self.n_pages - 1:
            req.status = RequestStatus.SHED
            raise ShedError(
                reasons.PAGE_BUDGET, req.rid,
                f"request {req.rid} needs {need} pages "
                f"({len(req.prompt)}+{req.params.max_tokens} tokens at "
                f"page_size={self.page_size}) but the pool only has "
                f"{self.n_pages - 1} allocatable "
                f"({self.alloc.n_free} free right now)")
        return need

    def submit(self, req: Request) -> None:
        """Enqueue at any time — including while other requests decode."""
        req.status = RequestStatus.QUEUED
        self.pending.append(req)

    # -- admit / finish / cancel ---------------------------------------------
    def _lookup(self, tokens):
        """Prefix lookup with corruption CONTAINMENT: a checksum mismatch on
        the walked path quarantines the whole index and reports a miss —
        admission proceeds with a full prefill, which is always correct."""
        if self.prefix_cache is None:
            return None
        try:
            return self.prefix_cache.lookup(tokens)
        except IndexCorruption:
            self.prefix_cache.quarantine(self.alloc)
            return None

    def _hit_rank(self, req: Request) -> int:
        """0 = exact hit (zero prefill), 1 = partial hit (tail prefill),
        2 = cold miss. Pure: ``lookup`` moves no stats or LRU ticks."""
        hit = self._lookup(req.effective_prompt)
        if hit is None:
            return 2
        return 0 if hit.exact else 1

    def _next_admissible(self) -> Request:
        """The queue head, or with a prefix cache the first pending request
        of the best hit rank (exact, partial, cold; queue order breaks
        ties): hits prefill less or nothing, so admitting them first lowers
        the queueing delay without changing any stream's tokens (the JAX
        package's ``hit_first``, its default)."""
        if self.prefix_cache is None or len(self.pending) == 1:
            return self.pending[0]
        cls = list(self.pending)
        ranked = min(range(len(cls)),
                     key=lambda i: (self._hit_rank(cls[i]), i))
        return cls[ranked]

    def admit(self) -> List[Request]:
        """Admit pending requests FCFS (hit-first) while a lane and the
        UNSHARED page budget are free; stop at the first one that does not
        fit (head-of-line blocking, so large requests are never starved).

        With a prefix cache only the uncached tail + decode pages count
        against the free list (shared pages cost an incref). Under pressure
        the cache reclaims LRU unpinned entries; if even that cannot cover
        a hit's tail, the hit is dropped for a cold admission (the hit may
        pin the last reclaimable pages itself), and if that cannot fit
        either, the request waits for lanes to finish.
        """
        admitted = []
        while self.pending:
            head = self._next_admissible()
            if not self.free_lanes:
                break
            try:
                need = self.check_fits(head)
            except ShedError:
                self.pending.remove(head)
                raise
            hit = self._lookup(head.effective_prompt)
            shared = list(hit.pages) if hit is not None else []
            private_need = need - len(shared)

            def _hold(h=hit):
                """Pin the hit path AND take the CoW-source hold before any
                reclaim runs: the record is LRU-evictable, so without the
                hold a sweep could free the page this admission forks."""
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
                            _drop()
                            hit, shared, private_need = None, [], need
                            ok = self.prefix_cache.reclaim(
                                self.alloc, need - self.alloc.n_free)
                    except IndexCorruption:
                        # the sweep walked a corrupted node no lookup had
                        # verified: quarantine, then admit cold
                        if hit is not None:
                            _drop()
                        self.prefix_cache.quarantine(self.alloc)
                        hit, shared, private_need = None, [], need
                        ok = need <= self.alloc.n_free
                if not ok:
                    break
            elif hit is not None:
                _hold()
            private = self.alloc.alloc(private_need)
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
        return admitted

    def _release(self, lane: int, insert: bool = False) -> Request:
        req = self.active.pop(lane)
        self.free_lanes.append(lane)
        if self.prefix_cache is not None:
            self.prefix_cache.release(req, self.alloc, insert=insert)
        else:
            for p in req.pages:
                self.alloc.decref(p)
        req.lane, req.pages = -1, ()
        req.shared_pages = req.private_pages = ()
        return req

    def finish(self, lane: int) -> Request:
        """Release a completed request — with a prefix cache its prompt
        pages are DONATED to the index (dedup frees byte-duplicates)."""
        req = self._release(lane, insert=True)
        req.status = RequestStatus.DONE
        return req

    def cancel(self, req: Request) -> bool:
        """Drop ``req`` wherever it is: an active request releases its lane
        and pages at once, a pending one leaves the queue. False if it
        already left the scheduler."""
        if req.lane >= 0 and self.active.get(req.lane) is req:
            self._release(req.lane)
        elif req in self.pending:
            self.pending.remove(req)
        else:
            return False
        req.status = RequestStatus.CANCELLED
        return True
