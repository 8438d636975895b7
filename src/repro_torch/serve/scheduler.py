"""Continuous-batching request scheduler — pure host bookkeeping.

The core of the JAX package's ``serve/scheduler.py``: LANES (slots of the
fixed-width decode batch), PAGES (the ref-counted ``PageAllocator``; page 0
is the garbage page) and the FCFS pending queue. ``submit`` may be called at
any time; ``admit`` pops the queue head into a free lane while its FULL page
budget fits (a running request never waits for memory mid-decode), with
head-of-line blocking so large requests are never starved; ``finish`` and
``cancel`` release a lane and its pages at once. Prefix caching, swap,
priorities, tenant quotas and deadlines come in later slices.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from . import reasons
from .paged_cache import PageAllocator, pages_for


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
    """Per-request sampling state. ``temperature`` > 0 (sampled decoding) is
    refused at submit in this slice; ``stop_token`` finishes a request
    early, releasing its lane and pages, and is itself the last token."""
    max_tokens: int = 16
    temperature: float = 0.0
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

    @property
    def done(self) -> bool:
        return self.stopped or len(self.emitted) >= self.params.max_tokens

    def __repr__(self):
        return (f"Request(rid={self.rid}, len={len(self.prompt)}, "
                f"emitted={len(self.emitted)}/{self.params.max_tokens}, "
                f"status={self.status.name})")


class Scheduler:
    def __init__(self, lanes: int, n_pages: int, page_size: int):
        if lanes < 1 or n_pages < 2:
            raise ValueError("need >=1 lane and >=2 pages (page 0 is the "
                             "reserved garbage page)")
        self.page_size = page_size
        self.n_pages = n_pages
        self.free_lanes: Deque[int] = deque(range(lanes))
        self.alloc = PageAllocator(n_pages)
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

    def admit(self) -> List[Request]:
        """Admit the queue head FCFS while a lane and its full page budget
        are free; stop at the first head that does not fit."""
        admitted = []
        while self.pending and self.free_lanes:
            head = self.pending[0]
            try:
                need = self.check_fits(head)
            except ShedError:
                self.pending.popleft()
                raise
            if need > self.alloc.n_free:
                break
            self.pending.popleft()
            head.lane = self.free_lanes.popleft()
            head.pages = tuple(self.alloc.alloc(need))
            head.status = RequestStatus.PREFILLING
            self.active[head.lane] = head
            admitted.append(head)
        return admitted

    def _release(self, lane: int) -> Request:
        req = self.active.pop(lane)
        self.free_lanes.append(lane)
        for p in req.pages:
            self.alloc.decref(p)
        req.lane, req.pages = -1, ()
        return req

    def finish(self, lane: int) -> Request:
        req = self._release(lane)
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
