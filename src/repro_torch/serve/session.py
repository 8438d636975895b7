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
counterpart of the JAX package's donated ``lax.scan``.

Overload and faults, as in the JAX package: the session is the
CONTAINMENT boundary. Deadlines are swept at the top of every ``step()``
(unmeetable pending → SHED before any compute; past-deadline active →
EXPIRED, lane and pages freed). Injected faults (serve/faults.py) are
polled on the host BEFORE the pool is touched, so admission faults fail
only their victim, an injected ``device_oom`` fails the newest active
request, and detected prefix-index corruption quarantines the index. An
injected ``kernel_dispatch`` fault is polled before the segment's first
launch and contained by re-issuing the same segment once, on the same
routes: nothing had been launched and the pool had not moved, and a CUDA
tensor never takes a plain version. A REAL exception inside a segment may
leave the pool half-written, so ``_contain_pool_loss`` fails every active
request, flushes the index and starts the next admission on a fresh pool.
``audit=True`` cross-checks every allocator refcount, index pin and host
slot against the holders' own books after each step. ``host_page_budget``
attaches the host swap tier (serve/swap.py): swap preemption with a
bit-exact resume, prefix demotion, and the index parked on the engine at
``close()`` for the next session of the same geometry.

On a serve mesh's engine the session runs on rank 0 and is the one
scheduler of the whole mesh: tensor parallelism shards heads, not lanes, so
every lane sits on shard group 0 (``placement()``) and each admission,
shed and deadline is decided once. An injected ``shard_loss`` (polled first
at a segment) fails every active request with ``shard-lost:shardN`` and
leaves ``stats()["mesh"]`` unhealthy for good; the host swap tier is
refused there, as in the JAX package.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.mamba import mamba_cache_lane_write
from repro_torch.spans import span

from . import reasons
from .faults import FaultInjector, InjectedFault, corrupt_prefix_index
from .paged_cache import fork_page, pages_for
from .prefix_cache import IndexCorruption, PrefixCache
from .sampling import PRNGKey, fold_in, logits_all_finite, sample_tokens
from .scheduler import (TERMINAL, Request, RequestStatus, SamplingParams,
                        Scheduler)
from .swap import SwapBridge, SwapManager


def _default_bucket(S: int, floor: int = 8) -> int:
    b = floor
    while b < S:
        b <<= 1
    return b


def _on(tree, device):
    """``tree``'s tensors on ``device`` (a host-resident index entry's
    logits and states, after a session adopted it)."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


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

    @property
    def error(self) -> Optional[str]:
        """Why the request left abnormally (``SHED`` / ``EXPIRED`` /
        ``FAILED``): the machine-readable reason (``queue-full``,
        ``deadline``, ``injected:page_alloc``, ...); None otherwise."""
        return self._req.fail_reason

    @property
    def preemptions(self) -> int:
        """Times this request was evicted (swap + recompute)."""
        return self._req.preemptions

    @property
    def preempt_swap(self) -> int:
        """Evictions resumed from the host swap tier: the restored bytes
        are identical, so the stream stays bit-identical to an
        uninterrupted run."""
        return self._req.preempt_swap

    @property
    def preempt_recompute(self) -> int:
        """Evictions resumed by recomputing prompt + emitted: the stream
        is the engine's for that effective prompt, not necessarily the
        uninterrupted one's."""
        return self._req.preempt_recompute

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
        tokens as a (n,) int32 array (partial if cancelled, shed, expired
        or failed — ``status`` / ``error`` say which)."""
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
        if ok:
            self._session._handles.pop(req.rid, None)
        return ok


class ServeSession:
    """One live serving context: a scheduler, a paged pool on the engine's
    device, and host mirrors of the lane state (block table, positions,
    current tokens, and each lane's sampling key, step and temperature)
    uploaded once per segment. ``key`` is the session's raw (2,) uint32 key
    (``PRNGKey(0)`` by default), the stream of sampled requests without a
    seed.

    ``work`` counts the device work a run did: ``decode_steps`` (one per
    step of a segment), ``prefills`` (cold and recompute prefills, {bucket
    length: count}), ``tail_prefills`` (partial-hit tail prefills, {bucket
    length: count}), ``exact_admits`` (zero-prefill exact hits),
    ``redispatched_segments`` (segments re-issued after an injected
    ``kernel_dispatch`` fault) and ``prefix`` (the prefix
    index's counters; None without the index). ``stats()`` is the JAX
    package's snapshot."""

    def __init__(self, engine, *, lanes: int = 4, page_size: int = 16,
                 n_pages: Optional[int] = None, segment: int = 1,
                 key=None, buckets: Optional[Sequence[int]] = None,
                 prefix_cache: Optional[bool] = None,
                 max_pending: Optional[int] = None,
                 tenant_page_quota: Optional[int] = None,
                 tenant_lane_quota: Optional[int] = None,
                 faults: Optional[FaultInjector] = None,
                 audit: bool = False, clock=None,
                 hit_first: bool = True,
                 host_page_budget: Optional[int] = None):
        """Overload and robustness knobs, all off by default: ``max_pending``
        bounds the submit queue (overflow sheds with ``ShedError``),
        ``tenant_*_quota`` bound each tenant's worst-case footprint,
        ``faults`` arms the injection registry (else ``REPRO_FAULTS`` from
        the environment), ``audit=True`` runs the allocator, index and
        slot audit after every step, ``clock`` (-> wall milliseconds,
        default ``time.monotonic``) is the deadline clock, ``hit_first``
        admits index hits first within a priority class, and
        ``host_page_budget`` attaches that many host page slots as the
        swap tier (admission then accounts both tiers: ``host-budget``
        sheds)."""
        if segment < 1 or page_size < 1 or lanes < 1:
            raise ValueError("segment, page_size and lanes must be >= 1")
        if host_page_budget is not None and engine.mesh is not None:
            raise NotImplementedError(
                "host_page_budget under a serve mesh is not supported yet: "
                "sharded attention leaves need per-shard host slots "
                "(ROADMAP follow-up)")
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
        self.faults = faults if faults is not None \
            else FaultInjector.from_env()
        self.audit_mode = audit
        self._clock = clock if clock is not None \
            else (lambda: time.monotonic() * 1000.0)
        self._est_admit_ms = 0.0    # EMA of admission + prefill wall time
        self.swap_mgr = None
        self._swap = None
        self._store_key = None
        if host_page_budget is not None:
            if host_page_budget < 0:
                raise ValueError("host_page_budget must be >= 0")
            # a same-geometry index parked by an earlier session's close()
            # is ADOPTED with its host slots; the bridge rebinds it here
            self._store_key = ("pfx", page_size, int(host_page_budget))
            parked = engine._prefix_store.pop(self._store_key, None) \
                if self.prefix is not None else None
            if parked is not None:
                self.prefix, self.swap_mgr = parked
                self.swap_mgr.faults = self.faults
            else:
                self.swap_mgr = SwapManager(engine.cfg, int(host_page_budget),
                                            faults=self.faults)
            self._swap = SwapBridge(self, self.swap_mgr)
            if self.prefix is not None:
                self.prefix.swap = self._swap
        self.sched = Scheduler(lanes, n_pages, page_size,
                               prefix_cache=self.prefix,
                               max_pending=max_pending,
                               tenant_page_quota=tenant_page_quota,
                               tenant_lane_quota=tenant_lane_quota,
                               faults=self.faults, hit_first=hit_first,
                               swap=self._swap)
        self.buckets = tuple(sorted(int(b) for b in buckets)) \
            if buckets else None
        self._pool = None
        self._closed = False
        # shard-loss drill history (mesh sessions): the shards lost so far
        self._lost_shards: list = []
        self._next_rid = 0
        self._handles = {}
        self._last_toks = None
        self.work = {"decode_steps": 0, "prefills": Counter(),
                     "tail_prefills": Counter(), "exact_admits": 0,
                     "redispatched_segments": 0,
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
        satisfy raise here, before any compute; a full queue, a tenant
        over quota or both tiers committed shed (``ShedError``)."""
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
        if params.deadline_ms is not None:  # relative budget -> absolute ms
            req.deadline = self._clock() + params.deadline_ms
        self._next_rid += 1
        req.submitted_at = time.perf_counter()
        self.sched.submit(req)              # may shed (queue/quota bounds)
        handle = RequestHandle(self, req)
        self._handles[rid] = handle
        return handle

    def step(self) -> bool:
        """One scheduling round: sweep deadlines, then admit + prefill +
        emit first tokens and return, or else decode one segment and drain
        finished lanes. Returns False (doing nothing) once idle."""
        if self._closed:
            raise RuntimeError("session is closed")
        if self.sched.idle:
            return False
        self._sweep_deadlines()
        if self.faults is not None and self.prefix is not None \
                and self.faults.should_fire("prefix_index"):
            # the corruption stand-in: detection and quarantine happen at
            # the next lookup (or audit)
            corrupt_prefix_index(self.prefix)
        if not self.sched.idle:
            with span("serve.admit"):
                admitted = self._admit_and_prefill()
            if not admitted and self._decode_segment():
                with span("serve.drain"):
                    self._drain_finished()
        if self.audit_mode:
            try:
                self.audit()
            except IndexCorruption:
                # the audit is a detector like the lookup walk: quarantine
                # (cold admission) and re-audit, which must come back clean
                self.prefix.quarantine(self.sched.alloc)
                self.audit()
        return True

    def run_until_idle(self) -> None:
        while self.step():
            pass

    def preempt(self, handle: RequestHandle) -> bool:
        """Evict a live request: its lane and pages free at once and it
        requeues at the FRONT of the queue (PREEMPTED). With the swap tier
        its page bytes and lane state park on host and re-admission
        restores them (a bit-identical stream); otherwise re-admission
        prefills prompt + emitted."""
        req = handle._req
        if req.lane < 0 or self.sched.active.get(req.lane) is not req:
            return False
        lane = req.lane
        self.sched.evict(lane)
        self._reset_lane(lane)
        return True

    def _sweep_deadlines(self) -> None:
        """Shed pending requests whose deadline cannot be met (now plus the
        estimated admission latency past it) and expire active ones past
        theirs (lane and pages freed, partial tokens kept)."""
        now = self._clock()
        self.sched.shed_expired(now, self._est_admit_ms)
        for lane, req in self.sched.expire(now):
            self._reset_lane(lane)
            self._handles.pop(req.rid, None)
        for req in self.sched.drain_shed():
            self._handles.pop(req.rid, None)

    @property
    def idle(self) -> bool:
        return self.sched.idle

    def close(self) -> None:
        """Cancel anything outstanding and release the pool. With the swap
        tier and the prefix index, the index is first demoted WHOLE to host
        and parked on the engine for the next session of this geometry."""
        if self._closed:
            return
        for h in list(self._handles.values()):
            h.cancel()
        if self._swap is not None and self.prefix is not None \
                and not self.prefix.quarantined:
            self.prefix.demote_all(self.sched.alloc)
            self.engine._prefix_store[self._store_key] = (self.prefix,
                                                          self.swap_mgr)
        self._drop_pool()
        self._closed = True

    def audit(self) -> dict:
        """Zero-leak oracle: rebuild the page-refcount, node-pin and host
        slot census from the holders' own books (active requests' pages
        and CoW-source holds, the prefix index's owned pages, records and
        host slots, swapped-out pending requests' slots) and cross-check
        the allocator, the index and the swap tier against it. Raises on
        any leak, double count or orphan."""
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
        out["sched"] = dict(self.sched.stats)
        if self.swap_mgr is not None:
            slots: Counter = Counter()  # slot -> holders, from their books
            for req in self.sched.pending:
                if req.swap is not None:
                    for sl in req.swap.slots:
                        slots[sl] += 1
            if self.prefix is not None:
                for sl in self.prefix._host_slot_iter():
                    slots[sl] += 1
            out["swap"] = self.swap_mgr.audit(dict(slots))
        return out

    def stats(self) -> dict:
        """One host-side snapshot of every serving counter, with the JAX
        package's keys (scheduler lifecycle counters, queue and lane
        occupancy, pool pages, the prefix and swap counters, the mesh's
        health)."""
        alloc = self.sched.alloc
        return {
            "sched": dict(self.sched.stats),
            "pending": len(self.sched.pending),
            "active": len(self.sched.active),
            "lanes": self.lanes,
            "pool": {"n_pages": alloc.n_pages, "n_free": alloc.n_free,
                     "n_owned": alloc.n_pages - 1 - alloc.n_free},
            "prefix": dict(self.prefix.stats)
            if self.prefix is not None else None,
            "swap": self.swap_mgr.stats_dict()
            if self.swap_mgr is not None else None,
            "mesh": self._mesh_stats(),
        }

    def _mesh_stats(self) -> Optional[dict]:
        """Mesh health (None on one device). ``healthy`` turns False after
        a contained shard loss and stays so: a real deployment rebuilds the
        mesh before it trusts the instance again, though this drill goes on
        serving on the intact ranks."""
        if self.engine.mesh is None:
            return None
        return {"shards": self.engine.tp,
                "shard_loss_events": len(self._lost_shards),
                "lost": list(self._lost_shards),
                "healthy": not self._lost_shards}

    def placement(self) -> dict:
        """{lane: shard group}: tensor parallelism places every lane on the
        ONE group spanning the whole mesh (each rank holds the lane's
        head-local pages), so every decision of the scheduler is made once,
        mesh-wide; group 0 until data-parallel replicas add others."""
        return {lane: 0 for lane in range(self.lanes)}

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
        # a preempted request whose prompt + emitted outgrew an explicit
        # bucket set takes the power-of-two bucket instead of failing
        return _default_bucket(S)

    def _ensure_pool(self):
        if self._pool is None:
            self._pool = self.engine.init_pool(self.n_pages, self.page_size,
                                               self.lanes)

    def _drop_pool(self):
        if self._pool is not None:
            self.engine.release_pool(self._pool)
        self._pool = None

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
        end logits, the very values the cold run sampled from, so with
        decode re-reading identical page bytes and state the stream is
        bit-identical to the cold run."""
        rec = req.hit.record
        if rec.page is not None:
            if self.faults is not None \
                    and self.faults.should_fire("fork_page"):
                # polled before the pool is touched: only this request fails
                raise InjectedFault("fork_page", f"rid={req.rid}")
            # fork dst = logical page S // page_size, which the scheduler's
            # page order puts first among the request's private pages
            fork_page(self.cfg, self._pool, rec.page, req.private_pages[0])
            self.prefix.stats["cow_forks"] += 1
        for bi in self._ssm_ids:
            mamba_cache_lane_write(self._pool[bi], rec.end_ssm[bi], req.lane)
        req.cache_extras = None         # the index already holds this prompt
        self.work["exact_admits"] += 1
        return _on(rec.logits, self.engine.device)

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
            ssm_init=_on(req.hit.ssm, self.engine.device)
            if o and self._ssm_ids else None,
            snapshots=self.prefix is not None)
        self.work["tail_prefills" if o else "prefills"][bucket] += 1
        if self.prefix is not None:
            req.cache_extras = {
                "tokens": np.array(eff, np.int32), "offset": o,
                "logits": logits, "end_ssm": end_ssm, "snaps": snaps,
                # an exact record promises bit-identity with a COLD run; a
                # kv-quant tail computes over DEQUANTISED prefix rows, so it
                # donates its tail pages but never an exact record
                "record_ok": not (self.cfg.kv_cache_quant and o > 0)}
        return logits

    def _resume_swapped(self, req: Request) -> bool:
        """Swap-resume a re-admitted preempted request: scatter its host
        slots into the fresh pages, restore the lane mirrors captured at
        eviction and decode on — bit-identical to the uninterrupted
        stream. False = an injected ``swap_in`` fault fired: the record is
        discarded, the preemption reclassified as recompute, and the caller
        falls through to the recompute prefill."""
        rec, req.swap = req.swap, None
        if self.faults is not None and self.faults.should_fire("swap_in"):
            self._swap.discard(rec)
            self.sched.swap_resume_failed(req)
            return False
        self._swap.restore(req, rec)
        lane = req.lane
        self._bt[lane] = 0
        self._bt[lane, :len(req.pages)] = req.pages
        self._pos[lane] = rec.pos
        self._cur[lane, 0] = rec.cur
        self._steps[lane] = rec.steps
        self._temps[lane] = req.params.temperature
        self._keys[lane] = self._lane_key(req)
        req.status = RequestStatus.DECODING
        return True

    def _fail_admitted(self, req, reason: str) -> None:
        self.sched.fail(req.lane, reason)
        for lane in self.sched.drain_freed_lanes():
            self._reset_lane(lane)
        self._handles.pop(req.rid, None)

    def _admit_and_prefill(self):
        """Admit pending requests into free lanes, produce each one's
        end-of-prompt logits (full prefill, tail prefill, or an exact-hit
        record read) or restore a swapped one, arm its lane mirrors and
        emit its first token."""
        t0 = self._clock()
        self._ensure_pool()
        admitted = self.sched.admit()
        # lanes freed by admission-time preemption or faults reset BEFORE
        # new lanes are armed, so a reset never clobbers a fresh admission
        for lane in self.sched.drain_freed_lanes():
            self._reset_lane(lane)
        for req in self.sched.drain_faulted() + self.sched.drain_shed():
            self._handles.pop(req.rid, None)
        for req in admitted:
            req.admitted_at = time.perf_counter()
            if req.swap is not None and self._resume_swapped(req):
                continue             # bytes and lane state back; no token
            eff = req.effective_prompt
            S = int(eff.shape[0])
            try:
                if req.hit is not None and req.hit.exact:
                    logits = self._admit_exact(req, S)
                else:
                    with span("serve.prefill"):
                        logits = self._admit_prefill(req, eff, S)
            except InjectedFault as e:
                # polled before the pool was touched: only the victim fails
                self._fail_admitted(req, reasons.format_reason(
                    reasons.INJECTED, e.site))
                continue
            if self.audit_mode and not logits_all_finite(logits[:, -1]):
                self._fail_admitted(req, reasons.format_reason(
                    reasons.BAD_LOGITS, "non-finite prefill logits"))
                continue
            lane_key = self._lane_key(req)
            e = len(req.emitted)
            temp = req.params.temperature
            with span("serve.first_token"):
                tok0 = int(sample_tokens(self.cfg, logits[:, -1], temp,
                                         lane_key if temp > 0 else None,
                                         e)[0, 0])
            if req.first_token_at is None:
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
                self._handles.pop(req.rid, None)
        if admitted:
            dt = self._clock() - t0      # feeds the deadline-shed estimate
            self._est_admit_ms = dt if self._est_admit_ms == 0.0 \
                else 0.5 * (self._est_admit_ms + dt)
        return admitted

    def _dispatch_segment(self, sampled: bool) -> None:
        """``segment`` decode steps over the full lane pool, the pool
        updated in place, the lane mirrors advanced."""
        self._last_toks, self._cur = self.engine.decode_segment(
            self._pool, self._bt, self._pos, self._cur, self._temps,
            self._keys, self._steps, self.segment, sampled)
        self.work["decode_steps"] += self.segment
        self._pos += self.segment
        self._steps += self.segment

    def _contain_pool_loss(self, exc: Exception) -> None:
        """A segment raised part-way: the pool may hold half-written rows,
        so every active request's cache state is lost. Fail them all
        (partial tokens kept), flush the prefix index (its pages were in
        the lost bytes), and let the next admission start on a fresh pool.
        Pending requests are untouched; the session keeps serving."""
        for lane in list(self.sched.active):
            req = self.sched.fail(lane, reasons.format_reason(
                reasons.POOL_LOST, f"{type(exc).__name__}: {exc}"))
            self._handles.pop(req.rid, None)
        for lane in self.sched.drain_freed_lanes():
            self._reset_lane(lane)
        if self.prefix is not None:
            self.prefix.flush(self.sched.alloc)
        self._drop_pool()

    def _contain_shard_loss(self) -> None:
        """A mesh device dropped mid-segment. Every head is sharded across
        the mesh, so EVERY active lane's next segment needs the lost shard:
        fail them all with the typed ``shard-lost`` reason rather than
        stream bytes computed on a partial mesh. Pending requests are
        untouched and the session keeps admitting (the drill's mesh still
        serves), but ``stats()["mesh"]`` stays degraded."""
        shard = len(self._lost_shards) % max(self.engine.tp, 1)
        reason = reasons.format_reason(reasons.SHARD_LOST, f"shard{shard}")
        for lane in list(self.sched.active):
            req = self.sched.fail(lane, reason)
            self._handles.pop(req.rid, None)
        for lane in self.sched.drain_freed_lanes():
            self._reset_lane(lane)
        self._lost_shards.append(shard)

    def _contain_oom(self) -> None:
        """A simulated out-of-memory at the segment dispatch, polled on the
        host before anything is launched: the NEWEST active request fails
        (its freed pages model the headroom a retry needs) and the others
        decode on bit-identically."""
        lane = self.sched.oom_victim()
        if lane is None:
            return
        req = self.sched.fail(lane, reasons.format_reason(
            reasons.OOM, "decode-segment"))
        self._handles.pop(req.rid, None)
        for freed in self.sched.drain_freed_lanes():
            self._reset_lane(freed)

    def _decode_segment(self) -> bool:
        """``segment`` decode steps over the full lane pool; lanes whose
        request finished or was cancelled compute into the garbage page.
        A segment with a sampled lane draws every lane's token from its own
        key at its own step (greedy lanes take the argmax); an all-greedy
        segment does no random work. Returns False when no lane is live.

        Faults: ``shard_loss`` (under a mesh), ``device_oom`` and
        ``kernel_dispatch`` are polled on the host before the segment's
        first launch. An injected dispatch fault
        is contained by re-issuing the same segment, once, on the same
        routes (no victim, no stream changes); a REAL exception inside the
        segment goes to ``_contain_pool_loss``."""
        if not self.sched.active:
            if self.sched.pending:   # unreachable given check_fits at submit
                raise RuntimeError("scheduler deadlock: pending requests "
                                   "but nothing admissible")
            return False
        if self.faults is not None and self.engine.mesh is not None \
                and self.faults.should_fire("shard_loss"):
            self._contain_shard_loss()
            return False
        if self.faults is not None and self.faults.should_fire("device_oom"):
            self._contain_oom()
            if not self.sched.active:
                return False
        sampled = any(r.params.temperature > 0
                      for r in self.sched.active.values())
        if self.faults is not None \
                and self.faults.should_fire("kernel_dispatch"):
            self.work["redispatched_segments"] += 1
        try:
            with span("serve.segment"):
                self._dispatch_segment(sampled)
        except Exception as e:       # noqa: BLE001 — contained, not hidden
            self._contain_pool_loss(e)
            return False
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
                self._handles.pop(req.rid, None)
