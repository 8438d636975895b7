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

With ``prefix_cache=True`` admission goes through the radix prefix index
(serve/prefix_cache.py): an exact repeat of a finished prompt admits with
ZERO prefill (the first token from the stored end logits, a copy-on-write
fork of a partly filled boundary page, the stored mamba end state written
into its lane), a prompt sharing cached full pages prefills only its
uncached tail over the prefix pages read in place, its mamba recurrences
resumed from the boundary state stored with the hit's last page, and a
finishing request donates its prompt pages, end state and page-boundary
states to the index.

Sampling state rides per lane, as in the JAX package: a request with
temperature > 0 draws from its own stream, ``PRNGKey(seed)`` when its
``SamplingParams`` carry a seed, else the session key folded with its
request id, at its own step (the first token at step 0 from the prefill
logits, decode step i at i), so its tokens do not depend on its lane or
its co-tenants. The keys, steps and temperatures live in host mirrors and
reach the device as each segment's inputs.

The segment is a Python loop over preallocated pools updated in place — the
counterpart of the JAX package's donated ``lax.scan``. A kernel error
propagates to the caller; there is no containment path in this slice.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.mamba import mamba_cache_lane_write

from .paged_cache import fork_page, pages_for
from .prefix_cache import PrefixCache
from .sampling import PRNGKey, fold_in, sample_tokens
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
    def ttft_ms(self) -> Optional[float]:
        """Submit to first-token emission on the host clock (the first
        token's sampling waits for the device), None before it."""
        r = self._req
        if r.first_token_at is None:
            return None
        return (r.first_token_at - r.submitted_at) * 1e3

    @property
    def admit_ms(self) -> Optional[float]:
        """The admission's own work, from the start of its prefill (or
        exact-record read) to the first token's emission: TTFT without the
        queueing. None before the first token."""
        r = self._req
        if r.first_token_at is None:
            return None
        return (r.first_token_at - r.admitted_at) * 1e3

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
    current tokens, and each lane's sampling key, step and temperature)
    uploaded once per segment. ``key`` is the session's raw (2,) uint32 key
    (``PRNGKey(0)`` by default), the stream of sampled requests without a
    seed.

    ``stats`` counts the device work a run did: ``decode_steps`` (one per
    step of a segment), ``prefills`` (cold prefills, {bucket length:
    count}), ``tail_prefills`` (partial-hit tail prefills, {bucket length:
    count}), ``exact_admits`` (zero-prefill exact hits) and ``prefix``
    (the prefix index's counters, the JAX package's keys; None without the
    index)."""

    def __init__(self, engine, *, lanes: int = 4, page_size: int = 16,
                 n_pages: Optional[int] = None, segment: int = 1,
                 key=None, buckets: Optional[Sequence[int]] = None,
                 prefix_cache: Optional[bool] = None):
        if segment < 1 or page_size < 1 or lanes < 1:
            raise ValueError("segment, page_size and lanes must be >= 1")
        self.engine = engine
        self.cfg = engine.cfg
        self.lanes = lanes
        self.page_size = page_size
        self.segment = segment
        self.key = PRNGKey(0) if key is None \
            else np.asarray(key, np.uint32).reshape(2)
        self._table_cols = -(-engine.max_len // page_size)
        if n_pages is None:    # full residency for every lane + garbage page
            n_pages = lanes * self._table_cols + 1
        self.n_pages = n_pages
        if prefix_cache is None:
            prefix_cache = engine.prefix_cache
        self.prefix = PrefixCache(page_size) if prefix_cache else None
        self._ssm_ids = engine._role_ids(True)
        self.sched = Scheduler(lanes, n_pages, page_size,
                               prefix_cache=self.prefix)
        self.buckets = tuple(sorted(int(b) for b in buckets)) \
            if buckets else None
        self._pool = None
        self._closed = False
        self._next_rid = 0
        self._last_toks = None
        self.stats = {"decode_steps": 0, "prefills": Counter(),
                      "tail_prefills": Counter(), "exact_admits": 0,
                      "prefix": None if self.prefix is None
                      else self.prefix.stats}
        self._bt = np.zeros((lanes, self._table_cols), np.int32)
        self._pos = np.zeros((lanes,), np.int32)
        self._cur = np.zeros((lanes, 1), np.int32)
        self._steps = np.zeros((lanes,), np.int32)
        self._temps = np.zeros((lanes,), np.float32)
        self._keys = np.zeros((lanes, 2), np.uint32)

    # -- lifecycle -----------------------------------------------------------
    def submit(self, prompt, params: Optional[SamplingParams] = None
               ) -> RequestHandle:
        """Enqueue a request at any time. An empty prompt, a zero budget, a
        prompt+budget past ``max_len`` or a page budget the pool can never
        satisfy raise here, before any compute."""
        if self._closed:
            raise RuntimeError("session is closed")
        p = np.asarray(prompt, np.int32).reshape(-1)
        params = SamplingParams() if params is None else params
        rid = self._next_rid
        if params.max_tokens < 1 or p.size < 1:
            raise ValueError(f"request {rid}: empty prompt or zero token budget")
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
        req.submitted_at = time.perf_counter()
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

    def audit(self) -> dict:
        """Zero-leak oracle: rebuild the page-refcount and node-pin census
        from the holders' own books (active requests' pages and CoW-source
        holds, the prefix index's owned pages and records) and cross-check
        the allocator and the index against it. Raises on any leak, double
        count or orphan."""
        holds: Counter = Counter()
        pins: Counter = Counter()           # id(node) -> live-request pins
        for req in self.sched.active.values():
            for p in req.pages:
                holds[p] += 1
            if req.hit is not None:
                for node in self.prefix._chain(req.hit.node):
                    pins[id(node)] += 1     # pins are transitive to root
                if req.hit.exact and req.hit.record.page is not None:
                    holds[req.hit.record.page] += 1     # CoW-source hold
        out = {}
        if self.prefix is not None:
            for p in self.prefix._owned_page_iter():
                holds[p] += 1               # index ownership refs
            out["prefix"] = self.prefix.audit(self.sched.alloc,
                                              external_pins=dict(pins))
        out["alloc"] = self.sched.alloc.audit(holds=dict(holds))
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- phases composed by step() -------------------------------------------
    def _bucket_len(self, S: int, strict: bool = True) -> int:
        if self.buckets is not None:
            for b in self.buckets:
                if b >= S:
                    return b
            if strict:
                raise ValueError(f"no prefill bucket >= prompt length {S} "
                                 f"(buckets={self.buckets})")
        return _default_bucket(S)

    def _reset_lane(self, lane: int) -> None:
        """Point a released lane at the garbage page: its in-flight segment
        writes land on page 0 and its position masks every read."""
        self._bt[lane] = 0
        self._pos[lane] = self._cur[lane] = self._steps[lane] = 0
        self._temps[lane] = 0.0
        self._keys[lane] = 0

    def _lane_key(self, req) -> np.ndarray:
        """The request's raw (2,) uint32 key: ``PRNGKey(seed)``, else the
        session key folded with its request id."""
        if req.params.seed is not None:
            return PRNGKey(req.params.seed)
        return fold_in(self.key, req.rid).numpy().astype(np.uint32)

    def _prefix_page_bucket(self, n: int) -> int:
        """Pow-2 bucket of the prefix page count of a tail prefill (the JAX
        package's bound on tail-prefill compiles; here it fixes the
        ``page_ids`` length the kernel is given)."""
        return _default_bucket(n, floor=1)

    def _admit_exact(self, req, S: int):
        """Exact-record admission: ZERO prefill. Shared full pages enter
        the block table as they are; a partly filled boundary page is
        copy-on-write forked onto the request's first private page (its
        decode rows land there); the stored mamba end state is written into
        the request's lane. The first token comes from the record's stored
        end logits, the very tensor the cold run sampled from, so with
        decode re-reading identical page bytes and state the stream is
        bit-identical to the cold run."""
        rec = req.hit.record
        if rec.page is not None:
            # fork dst = logical page S // page_size, which the scheduler's
            # page order puts first among the request's private pages
            fork_page(self.cfg, self._pool, rec.page, req.private_pages[0])
            self.prefix.stats["cow_forks"] += 1
        for bi in self._ssm_ids:
            mamba_cache_lane_write(self._pool[bi], rec.end_ssm[bi], req.lane)
        req.cache_extras = None         # the index already holds this prompt
        self.stats["exact_admits"] += 1
        return rec.logits

    def _admit_prefill(self, req, eff, S: int):
        """Cold / partial-hit admission: prefill ONLY the uncached tail
        through its length bucket (the true length masks the commit),
        scatter its rows into the request's tail pages and, with the
        prefix index on, keep what a finish donates to it (end logits,
        mamba end state, page-boundary states). A partial hit prefills at
        position offset o over the o cached rows read in place from the
        request's shared pages, each mamba recurrence resumed from the
        hit's boundary state."""
        o = req.hit.hit_len if req.hit is not None else 0
        T = S - o
        o_pages = o // self.page_size
        bucket = self._bucket_len(T, strict=False)
        npp_t = -(-T // self.page_size)
        page_ids = np.zeros((-(-bucket // self.page_size),), np.int32)
        page_ids[:npp_t] = req.pages[o_pages:o_pages + npp_t]
        padded = np.zeros((bucket,), np.int32)
        padded[:T] = eff[o:]
        prefix_ids = None
        if o_pages:
            prefix_ids = np.zeros((self._prefix_page_bucket(o_pages),),
                                  np.int32)
            prefix_ids[:o_pages] = req.pages[:o_pages]
        logits, end_ssm, snaps = self.engine.prefill_commit(
            self._pool, padded, T, page_ids, self.page_size, offset=o,
            prefix_ids=prefix_ids, lane=req.lane,
            ssm_init=req.hit.ssm if o and self._ssm_ids else None,
            snapshots=self.prefix is not None)
        self.stats["tail_prefills" if o else "prefills"][bucket] += 1
        if self.prefix is not None:
            req.cache_extras = {
                "tokens": np.array(eff, np.int32), "offset": o,
                "logits": logits, "end_ssm": end_ssm, "snaps": snaps,
                # an exact record promises bit-identity with a COLD run; a
                # kv-quant tail computes over DEQUANTISED prefix rows, so it
                # donates its tail pages but never an exact record
                "record_ok": not (self.cfg.kv_cache_quant and o > 0)}
        return logits

    def _admit_and_prefill(self):
        """Admit pending requests into free lanes, produce each one's
        end-of-prompt logits (full prefill, tail prefill, or an exact-hit
        record read), arm its lane mirrors and emit its first token."""
        admitted = self.sched.admit()
        if admitted and self._pool is None:
            self._pool = self.engine.init_pool(self.n_pages, self.page_size,
                                               self.lanes)
        for req in admitted:
            req.admitted_at = time.perf_counter()
            eff = req.effective_prompt
            S = int(eff.shape[0])
            if req.hit is not None and req.hit.exact:
                logits = self._admit_exact(req, S)
            else:
                logits = self._admit_prefill(req, eff, S)
            lane_key = self._lane_key(req)
            e = len(req.emitted)
            temp = req.params.temperature
            tok0 = int(sample_tokens(self.cfg, logits[:, -1], temp,
                                     lane_key if temp > 0 else None, e)[0, 0])
            req.first_token_at = time.perf_counter()
            lane = req.lane
            self._bt[lane] = 0
            self._bt[lane, :len(req.pages)] = req.pages
            self._pos[lane] = S
            self._cur[lane, 0] = tok0
            self._steps[lane] = e
            self._temps[lane] = temp
            self._keys[lane] = lane_key
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
        A segment with a sampled lane draws every lane's token from its own
        key at its own step (greedy lanes take the argmax); an all-greedy
        segment does no random work. Returns False when no lane is live."""
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
        sampled = any(r.params.temperature > 0
                      for r in self.sched.active.values())
        temps = keys = steps = None
        if sampled:
            temps = torch.from_numpy(self._temps).to(dev)
            keys = torch.from_numpy(self._keys.astype(np.int64)).to(dev)
            steps = torch.from_numpy(self._steps).to(dev)
        toks = []
        for i in range(self.segment):
            logits, cache = self.engine.decode_step(cache, tok)
            if sampled:
                tok = sample_tokens(self.cfg, logits[:, -1], temps, keys,
                                    steps + (i + 1))
            else:
                tok = sample_tokens(self.cfg, logits[:, -1])
            toks.append(tok[:, 0])
        self.stats["decode_steps"] += self.segment
        self._last_toks = torch.stack(toks).cpu().numpy()
        self._cur = tok.cpu().numpy()
        self._pos += self.segment
        self._steps += self.segment
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
