"""Streaming serve API: request handles over a re-entrant scheduler core.

    session = engine.session(lanes=4, page_size=16, segment=2)
    h = session.submit(prompt, SamplingParams(max_tokens=64))
    for tok in h.tokens():         # yields as decode segments complete
        ...
    h2 = session.submit(other)     # mid-flight: admitted as lanes free up
    h.cancel()                     # frees the lane + pages immediately
    session.run_until_idle()

As in the JAX package's ``serve/session.py``, ``step()`` drives one round of
three phases: admission (pop pending requests into free lanes, prefill each
through its length bucket, commit its pages, EMIT the prefill-sampled first
token — a round that admitted returns before decoding, so TTFT is the
prefill latency), one decode segment of ``segment`` steps over the fixed
lane pool, and the drain of finished lanes. Prompts are right-padded to the
smallest power-of-two bucket >= their length (or to an explicit
``buckets=``), with the true length masking the commit.

The segment is a Python loop over preallocated pools updated in place — the
counterpart of the JAX package's donated ``lax.scan``. A kernel error
propagates to the caller; there is no containment path in this slice.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from .paged_cache import pages_for
from .sampling import sample_tokens
from .scheduler import (TERMINAL, Request, RequestStatus, SamplingParams,
                        Scheduler)


def _default_bucket(S: int, floor: int = 8) -> int:
    b = floor
    while b < S:
        b <<= 1
    return b


class RequestHandle:
    """Caller-facing view of one submitted request."""

    def __init__(self, session: "ServeSession", req: Request):
        self._session = session
        self._req = req

    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def status(self) -> RequestStatus:
        return self._req.status

    @property
    def tokens_ready(self) -> int:
        """Tokens already emitted and readable without further stepping."""
        return len(self._req.emitted)

    def tokens_so_far(self) -> list:
        """Snapshot of the tokens emitted so far, without driving the
        session."""
        return list(self._req.emitted)

    def tokens(self) -> Iterator[int]:
        """Yield this request's tokens as decode segments complete, driving
        ``session.step()`` (which advances EVERY live request) until the
        request reaches a terminal status."""
        i = 0
        while True:
            while i < len(self._req.emitted):
                yield self._req.emitted[i]
                i += 1
            if self._req.status in TERMINAL:
                return
            if not self._session.step():
                raise RuntimeError(f"session idle but request {self._req.rid} "
                                   f"is {self._req.status.name}")

    def result(self) -> np.ndarray:
        """Drive the session until this request is terminal; returns its
        tokens as a (n,) int32 array (partial if cancelled)."""
        for _ in self.tokens():
            pass
        return np.asarray(self._req.emitted, np.int32)

    def cancel(self) -> bool:
        """Drop the request now. An active request releases its lane and
        pages immediately; emitted tokens stay readable. False if it was
        already terminal."""
        req = self._req
        if req.status in TERMINAL:
            return False
        lane = req.lane
        ok = self._session.sched.cancel(req)
        if ok and lane >= 0:
            self._session._reset_lane(lane)
        return ok


class ServeSession:
    """One live serving context: a scheduler, a paged pool on the engine's
    device, and host mirrors of the lane state (block table, positions,
    current tokens) uploaded once per segment.

    ``stats`` counts the device work a run did: ``decode_steps`` (one per
    step of a segment) and ``prefills`` ({bucket length: count})."""

    def __init__(self, engine, *, lanes: int = 4, page_size: int = 16,
                 n_pages: Optional[int] = None, segment: int = 1,
                 buckets: Optional[Sequence[int]] = None):
        if segment < 1 or page_size < 1 or lanes < 1:
            raise ValueError("segment, page_size and lanes must be >= 1")
        self.engine = engine
        self.cfg = engine.cfg
        self.lanes = lanes
        self.page_size = page_size
        self.segment = segment
        self._table_cols = -(-engine.max_len // page_size)
        if n_pages is None:    # full residency for every lane + garbage page
            n_pages = lanes * self._table_cols + 1
        self.n_pages = n_pages
        self.sched = Scheduler(lanes, n_pages, page_size)
        self.buckets = tuple(sorted(int(b) for b in buckets)) \
            if buckets else None
        self._pool = None
        self._closed = False
        self._next_rid = 0
        self._last_toks = None
        self.stats = {"decode_steps": 0, "prefills": Counter()}
        self._bt = np.zeros((lanes, self._table_cols), np.int32)
        self._pos = np.zeros((lanes,), np.int32)
        self._cur = np.zeros((lanes, 1), np.int32)

    # -- lifecycle -----------------------------------------------------------
    def submit(self, prompt, params: Optional[SamplingParams] = None
               ) -> RequestHandle:
        """Enqueue a request at any time. An empty prompt, a zero budget, a
        prompt+budget past ``max_len``, a page budget the pool can never
        satisfy, or sampled decoding raise here, before any compute."""
        if self._closed:
            raise RuntimeError("session is closed")
        p = np.asarray(prompt, np.int32).reshape(-1)
        params = SamplingParams() if params is None else params
        rid = self._next_rid
        if params.max_tokens < 1 or p.size < 1:
            raise ValueError(f"request {rid}: empty prompt or zero token budget")
        if params.temperature > 0.0:
            raise NotImplementedError(f"request {rid}: sampled decoding "
                                      "(temperature > 0) is not ported yet")
        if p.size + params.max_tokens > self.engine.max_len:
            raise ValueError(
                f"request {rid}: {p.size}+{params.max_tokens} tokens exceeds "
                f"max_len={self.engine.max_len} (would need "
                f"{pages_for(p.size, params.max_tokens, self.page_size)} "
                f"pages; {self.sched.alloc.n_free} free now)")
        req = Request(rid=rid, prompt=p, params=params)
        self.sched.check_fits(req)
        self._bucket_len(p.size)            # custom buckets must cover it
        self._next_rid += 1
        self.sched.submit(req)
        return RequestHandle(self, req)

    def step(self) -> bool:
        """One scheduling round: admit + prefill + emit first tokens and
        return, or else decode one segment and drain finished lanes.
        Returns False (doing nothing) once the session is idle."""
        if self._closed:
            raise RuntimeError("session is closed")
        if self.sched.idle:
            return False
        if not self._admit_and_prefill() and self._decode_segment():
            self._drain_finished()
        return True

    def run_until_idle(self) -> None:
        while self.step():
            pass

    @property
    def idle(self) -> bool:
        return self.sched.idle

    def close(self) -> None:
        """Cancel anything outstanding and release the pool."""
        if self._closed:
            return
        for req in list(self.sched.active.values()) + list(self.sched.pending):
            self.sched.cancel(req)
        self._pool = None
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- phases composed by step() -------------------------------------------
    def _bucket_len(self, S: int) -> int:
        if self.buckets is None:
            return _default_bucket(S)
        for b in self.buckets:
            if b >= S:
                return b
        raise ValueError(f"no prefill bucket >= prompt length {S} "
                         f"(buckets={self.buckets})")

    def _reset_lane(self, lane: int) -> None:
        """Point a released lane at the garbage page: its in-flight segment
        writes land on page 0 and its position masks every read."""
        self._bt[lane] = 0
        self._pos[lane] = self._cur[lane] = 0

    def _admit_and_prefill(self):
        """Admit pending requests into free lanes, prefill each, arm its
        lane mirrors and emit its first token."""
        admitted = self.sched.admit()
        if admitted and self._pool is None:
            self._pool = self.engine.init_pool(self.n_pages, self.page_size)
        for req in admitted:
            S = int(req.prompt.shape[0])
            bucket = self._bucket_len(S)
            npp_t = -(-S // self.page_size)
            page_ids = np.zeros((-(-bucket // self.page_size),), np.int32)
            page_ids[:npp_t] = req.pages[:npp_t]
            padded = np.zeros((bucket,), np.int32)
            padded[:S] = req.prompt
            logits = self.engine.prefill_commit(self._pool, padded, S, page_ids,
                                                self.page_size)
            self.stats["prefills"][bucket] += 1
            tok0 = int(sample_tokens(self.cfg, logits[:, -1])[0, 0])
            lane = req.lane
            self._bt[lane] = 0
            self._bt[lane, :len(req.pages)] = req.pages
            self._pos[lane] = S
            self._cur[lane, 0] = tok0
            req.status = RequestStatus.DECODING
            if req.params.stop_token is not None \
                    and tok0 == req.params.stop_token:
                req.stopped = True
            req.emitted.append(tok0)
            if req.done:                 # budget 1 / instant stop token
                self.sched.finish(lane)
                self._reset_lane(lane)
        return admitted

    def _decode_segment(self) -> bool:
        """``segment`` decode steps over the full lane pool; lanes whose
        request finished or was cancelled compute into the garbage page.
        Returns False when no lane is live."""
        if not self.sched.active:
            if self.sched.pending:   # unreachable given check_fits at submit
                raise RuntimeError("scheduler deadlock: pending requests "
                                   "but nothing admissible")
            return False
        dev = self.engine.device
        cache = {"blocks": self._pool,
                 "block_table": torch.from_numpy(self._bt).to(dev),
                 "pos": torch.from_numpy(self._pos).to(dev)}
        tok = torch.from_numpy(self._cur).to(dev)
        toks = []
        for _ in range(self.segment):
            logits, cache = self.engine.decode_step(cache, tok)
            tok = sample_tokens(self.cfg, logits[:, -1])
            toks.append(tok[:, 0])
        self.stats["decode_steps"] += self.segment
        self._last_toks = torch.stack(toks).cpu().numpy()
        self._cur = tok.cpu().numpy()
        self._pos += self.segment
        return True

    def _drain_finished(self):
        """Harvest the segment's tokens into each live request, apply the
        stop token, and release completed lanes."""
        for lane, req in list(self.sched.active.items()):
            take = min(self.segment,
                       req.params.max_tokens - len(req.emitted))
            new = [int(t) for t in self._last_toks[:take, lane]]
            stop = req.params.stop_token
            if stop is not None and stop in new:
                new = new[:new.index(stop) + 1]
                req.stopped = True
            req.emitted.extend(new)
            if req.done:
                self.sched.finish(lane)
                self._reset_lane(lane)
