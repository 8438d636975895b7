"""Host-RAM page-swap tier: the memory below the device's paged pool.

The port of the JAX package's ``serve/swap.py``. A pinned host buffer pool
mirrors every attention page leaf of the device pool (k/v rows and, under
kv_cache_quant, the int8 pools' scale pools), so that

  * PREEMPTION swaps a victim's page BYTES out instead of discarding them:
    resume restores the identical bytes and the resumed greedy stream is
    BIT-identical to the uninterrupted one. Recompute-resume cannot
    promise that: prefill-computed and decode-computed rows differ by
    reduction order and ``sign()`` turns the ulps into token flips, so a
    byte-preserving swap is the only bit-exact resume under Boolean
    numerics; recompute stays as the fallback when the host budget is
    spent;
  * the PREFIX INDEX demotes cold pages to host under LRU pressure instead
    of evicting them; a host-resident hit is promoted back at admission (a
    few page copies, no prefill) and serves the stored bytes;
  * the index SURVIVES a session's close: ``close()`` demotes the whole
    index to host and parks it on the engine; the next session of the same
    geometry adopts it against a fresh allocator.

RESIDENCY ENCODING: a host-resident page is referenced in place by the
existing page-id lists as the negative id ``-(slot + 1)``; the allocator
never sees one (promotion rewrites them before a block table is built).

COPY PATH: one path. On the card, pages move in chunks of ``chunk`` pages
on two side streams ordered by events: a gather stream packs a chunk's
pages of every leaf into a contiguous device staging buffer, and a copy
stream moves it between that buffer and the pinned host rows (one copy a
run of consecutive slots), so the next chunk's gather overlaps the current
chunk's copy. ``swap_out`` returns once its bytes are on the host;
``swap_in`` orders the caller's stream after its scatters. On CPU tensors
the same code runs with plain copies.

SSM state is lane-indexed, never paged: preemption captures the mamba
(h, conv) lane state in the ``SwapRecord`` beside the page bytes and writes
it back at resume. For a pure-SSM model the page bytes are empty and the
record IS the state.

FAULT SITES (serve/faults.py): ``swap_out`` / ``swap_in`` are polled by
the bridge before anything moves, ``host_pool`` inside slot allocation.
Containment is by FALLBACK, never a victim: a failed swap-out preempts by
recompute, a failed swap-in at resume falls back to the recompute prefill,
a failed promotion to cold admission.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import block_roles

from .faults import InjectedFault


class HostBudgetExceeded(RuntimeError):
    """The host slot pool cannot cover the requested pages. Callers fall
    back to the always-correct paths (recompute resume, plain eviction,
    cold admission) — never an error the request sees."""


def encode_slot(slot: int) -> int:
    """Host slot -> negative in-place page id."""
    return -(slot + 1)


def decode_slot(page_id: int) -> int:
    """Negative in-place page id -> host slot."""
    assert page_id < 0, page_id
    return -page_id - 1


@dataclasses.dataclass
class SwapRecord:
    """Everything a preempted request needs to resume bit-exactly: its
    page bytes (as host slots, logical order), the lane mirrors at the
    segment boundary, and the mamba lane state (a host tree, or None for
    attention-only models)."""
    slots: List[int]
    pos: int                        # _pos[lane] at capture
    steps: int                      # _steps[lane] at capture
    cur: int                        # _cur[lane, 0] — last emitted token
    ssm: Any                        # host {bi: {"h", "conv"}} | None


def _runs(slots: List[int]):
    """(first index, first slot, length) of each run of consecutive slots."""
    out, i = [], 0
    while i < len(slots):
        j = i + 1
        while j < len(slots) and slots[j] == slots[j - 1] + 1:
            j += 1
        out.append((i, slots[i], j - i))
        i = j
    return out


def to_host(tree):
    """A tree of tensors copied to host memory (host leaves pass through)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to("cpu")
    return tree


class SwapManager:
    """The host tier itself: slot bookkeeping and device<->host copies.

    Host storage is shaped lazily, at the first swap-out, from the pool's
    leaves: one buffer a leaf, ``(budget,) + (G, page, ...)``, pinned when
    the pool is on the card. A pure-SSM model shapes to nothing and the
    tier is slot accounting; its swappable state rides the record.
    """

    #: pages a copy chunk (``chunk``, set per manager).
    CHUNK = 8

    def __init__(self, cfg, host_pages: int, faults=None):
        if host_pages < 0:
            raise ValueError("host_pages must be >= 0")
        self.cfg = cfg
        self.host_pages = int(host_pages)
        self.faults = faults
        self.chunk = self.CHUNK
        roles = block_roles(cfg)
        self._attn = [f"b{i}" for i, r in enumerate(roles)
                      if r["mixer"] != "mamba"]
        self._mamba = [f"b{i}" for i, r in enumerate(roles)
                       if r["mixer"] == "mamba"]
        self._free: deque = deque(range(self.host_pages))
        self._used: set = set()
        self._host: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._streams = None                # (gather, copy) on the card
        self.page_bytes = 0                 # known after first shaping
        self.host_bytes = 0                 # the host buffers' size
        self.stats = {"swap_outs": 0, "swap_ins": 0,
                      "swap_out_bytes": 0, "swap_in_bytes": 0,
                      "slot_alloc_failures": 0}

    # -- slot bookkeeping ----------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._used)

    def alloc_slots(self, n: int) -> List[int]:
        """Take ``n`` host slots. Atomic like ``PageAllocator.alloc``: the
        ``host_pool`` site and the budget check both fire BEFORE the free
        list moves."""
        if self.faults is not None and n > 0 \
                and self.faults.should_fire("host_pool"):
            raise InjectedFault("host_pool", f"alloc_slots({n})")
        if n > len(self._free):
            self.stats["slot_alloc_failures"] += 1
            raise HostBudgetExceeded(
                f"need {n} host slots, {len(self._free)} free "
                f"of {self.host_pages}")
        slots = [self._free.popleft() for _ in range(n)]
        self._used.update(slots)
        return slots

    def free_slots(self, slots) -> None:
        for s in slots:
            if s in self._used:
                self._used.discard(s)
                self._free.append(s)

    def audit(self, claimed: Optional[Dict[int, int]] = None) -> dict:
        """Slot invariants; ``claimed`` is a {slot: holders} census from the
        holders' own books (swapped-out pending requests and the prefix
        index's host-resident entries). Raises on a slot leaked,
        double-claimed, or both free and used."""
        if self._used & set(self._free):
            raise RuntimeError("swap audit: slot both used and free")
        if len(self._used) + len(self._free) != self.host_pages:
            raise RuntimeError(
                f"swap audit: used {len(self._used)} + free "
                f"{len(self._free)} != budget {self.host_pages}")
        if claimed is not None:
            for s, n in claimed.items():
                if n != 1:
                    raise RuntimeError(
                        f"swap audit: slot {s} claimed by {n} holders")
            if set(claimed) != self._used:
                leak = self._used - set(claimed)
                ghost = set(claimed) - self._used
                raise RuntimeError(
                    f"swap audit: leaked slots {sorted(leak)}, "
                    f"unbacked claims {sorted(ghost)}")
        return {"host_pages": self.host_pages, "used": len(self._used),
                "free": len(self._free)}

    def stats_dict(self) -> dict:
        out = dict(self.stats)
        out.update({"host_pages": self.host_pages,
                    "host_used": len(self._used),
                    "host_free": len(self._free),
                    "page_bytes": self.page_bytes})
        return out

    # -- host buffers and streams --------------------------------------------
    def _ensure_host(self, pool) -> None:
        """Shape the host buffers from the pool: device leaf ``(G, n_pages,
        page, ...)`` -> host buffer ``(budget, G, page, ...)``."""
        if self._host is not None:
            return
        self._host = {}
        nbytes = 0
        for bi in self._attn:
            self._host[bi] = {}
            for name, leaf in pool[bi].items():
                shp = (self.host_pages, leaf.shape[0]) + tuple(leaf.shape[2:])
                self._host[bi][name] = torch.zeros(
                    shp, dtype=leaf.dtype, pin_memory=leaf.is_cuda)
                nbytes += int(np.prod(shp[1:])) * leaf.element_size()
        self.page_bytes = nbytes
        self.host_bytes = nbytes * self.host_pages

    def _stream_ctx(self, dev: torch.device):
        """The (gather, copy) side streams on the card; None on the CPU."""
        if dev.type != "cuda":
            return None
        if self._streams is None:
            self._streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
        return self._streams

    def _chunks(self, n: int):
        return [(i, min(i + self.chunk, n)) for i in range(0, n, self.chunk)]

    # -- device -> host ------------------------------------------------------
    def swap_out(self, pool, page_ids: List[int]) -> List[int]:
        """Copy ``page_ids``' bytes (every attention leaf) into fresh host
        slots; returns the slots in the same logical order. The pool is
        only read. Returns once the bytes are on the host."""
        slots = self.alloc_slots(len(page_ids))
        if not page_ids or not self._attn:
            self.stats["swap_outs"] += 1
            return slots
        self._ensure_host(pool)
        dev = pool[self._attn[0]][next(iter(pool[self._attn[0]]))].device
        streams = self._stream_ctx(dev)
        if streams is not None:
            g, c = streams
            g.wait_stream(torch.cuda.current_stream(dev))
        ids = torch.as_tensor(page_ids, dtype=torch.long)
        for a, b in self._chunks(len(page_ids)):
            with (torch.cuda.stream(g) if streams else contextlib.nullcontext()):
                idx = ids[a:b].to(dev)
                staged = {bi: {name: leaf.index_select(1, idx).transpose(0, 1)
                               .contiguous()
                               for name, leaf in pool[bi].items()}
                          for bi in self._attn}
                if streams:
                    ev = torch.cuda.Event()
                    ev.record(g)
            with (torch.cuda.stream(c) if streams else contextlib.nullcontext()):
                if streams:
                    c.wait_event(ev)
                for bi, leaves in staged.items():
                    for name, t in leaves.items():
                        if streams:
                            t.record_stream(c)
                        host = self._host[bi][name]
                        for k, s, r in _runs(slots[a:b]):
                            host[s:s + r].copy_(t[k:k + r], non_blocking=True)
        if streams:
            c.synchronize()
        self.stats["swap_outs"] += 1
        self.stats["swap_out_bytes"] += self.page_bytes * len(page_ids)
        return slots

    # -- host -> device ------------------------------------------------------
    def swap_in(self, pool, slots: List[int], page_ids: List[int],
                free: bool = True):
        """Scatter host ``slots``' bytes into device ``page_ids`` (same
        logical order), in place; returns the pool. The caller's stream is
        ordered after the scatters. ``free=True`` releases the slots once
        the copies are issued (a later swap-out into them is ordered after
        on the copy stream)."""
        assert len(slots) == len(page_ids), (slots, page_ids)
        if not page_ids or not self._attn or self._host is None:
            if free:
                self.free_slots(slots)
            self.stats["swap_ins"] += 1
            return pool
        dev = pool[self._attn[0]][next(iter(pool[self._attn[0]]))].device
        streams = self._stream_ctx(dev)
        if streams is not None:
            g, c = streams
            cur = torch.cuda.current_stream(dev)
            g.wait_stream(cur)              # the pool's pending work first
        ids = torch.as_tensor(page_ids, dtype=torch.long)
        for a, b in self._chunks(len(page_ids)):
            with (torch.cuda.stream(c) if streams else contextlib.nullcontext()):
                staged = {}
                for bi in self._attn:
                    staged[bi] = {}
                    for name, host in self._host[bi].items():
                        t = torch.empty((b - a,) + tuple(host.shape[1:]),
                                        dtype=host.dtype, device=dev)
                        for k, s, r in _runs(slots[a:b]):
                            t[k:k + r].copy_(host[s:s + r], non_blocking=True)
                        staged[bi][name] = t
                idx = ids[a:b].to(dev)
                if streams:
                    ev = torch.cuda.Event()
                    ev.record(c)
            with (torch.cuda.stream(g) if streams else contextlib.nullcontext()):
                if streams:
                    g.wait_event(ev)
                    idx.record_stream(g)
                for bi, leaves in staged.items():
                    for name, t in leaves.items():
                        if streams:
                            t.record_stream(g)
                        pool[bi][name].index_copy_(1, idx, t.transpose(0, 1))
        if streams:
            cur.wait_stream(g)
        if free:
            self.free_slots(slots)
        self.stats["swap_ins"] += 1
        self.stats["swap_in_bytes"] += self.page_bytes * len(page_ids)
        return pool

    def read_slots(self, slots: List[int]):
        """Host bytes of ``slots`` (tests / diagnostics): {bi: {leaf:
        (n, G, page, ...)}}, copies."""
        if self._host is None:
            return {}
        if self._streams is not None:
            self._streams[1].synchronize()
        idx = torch.as_tensor(slots, dtype=torch.long)
        return {bi: {name: buf.index_select(0, idx)
                     for name, buf in leaves.items()}
                for bi, leaves in self._host.items()}

    # -- mamba lane state ----------------------------------------------------
    def lane_state_out(self, pool, lane: int):
        """Snapshot the mamba lane state to host; None for attention-only
        models."""
        if not self._mamba:
            return None
        return {bi: {name: leaf[:, lane].to("cpu", copy=True)
                     for name, leaf in pool[bi].items()}
                for bi in self._mamba}

    def lane_state_in(self, pool, state, lane: int):
        """Write a captured lane state back into ``lane``, in place;
        returns the pool."""
        if state is None or not self._mamba:
            return pool
        for bi in self._mamba:
            for name, leaf in pool[bi].items():
                leaf[:, lane] = state[bi][name].to(leaf.device)
        return pool


class SwapBridge:
    """The session-side executor the scheduler and the prefix index drive
    the tier through: it polls the fault sites (always BEFORE anything
    moves) and turns failures into the fallbacks, so its callers only see
    "worked" or "take the fallback path"."""

    def __init__(self, session, mgr: SwapManager):
        self._session = session
        self.mgr = mgr

    @property
    def host_pages(self) -> int:
        return self.mgr.host_pages

    # -- preemption ----------------------------------------------------------
    def capture(self, req) -> Optional[SwapRecord]:
        """Swap a victim's pages and lane state out to host at eviction.
        None → recompute fallback (budget spent, or an injected
        ``swap_out`` / ``host_pool`` fault; no victim either way)."""
        s = self._session
        if s.faults is not None and s.faults.should_fire("swap_out"):
            return None
        s._ensure_pool()
        try:
            slots = self.mgr.swap_out(s._pool, list(req.pages))
        except (HostBudgetExceeded, InjectedFault):
            return None
        lane = req.lane
        return SwapRecord(
            slots=slots,
            pos=int(s._pos[lane]), steps=int(s._steps[lane]),
            cur=int(s._cur[lane, 0]),
            ssm=self.mgr.lane_state_out(s._pool, lane))

    def restore(self, req, rec: SwapRecord) -> None:
        """Scatter a captured request's bytes into its fresh pages and
        lane. The caller polled ``swap_in`` first."""
        s = self._session
        assert len(rec.slots) == len(req.pages), (rec.slots, req.pages)
        self.mgr.swap_in(s._pool, rec.slots, list(req.pages))
        self.mgr.lane_state_in(s._pool, rec.ssm, req.lane)

    def discard(self, rec: SwapRecord) -> None:
        self.mgr.free_slots(rec.slots)

    def free_slots(self, slots) -> None:
        self.mgr.free_slots(slots)

    # -- prefix index --------------------------------------------------------
    def demote(self, page_ids: List[int]) -> Optional[List[int]]:
        """Copy index-owned device pages to host slots (reclaim / close).
        None → plain-eviction fallback. Does not decref."""
        s = self._session
        if s.faults is not None and s.faults.should_fire("swap_out"):
            return None
        s._ensure_pool()
        try:
            return self.mgr.swap_out(s._pool, list(page_ids))
        except (HostBudgetExceeded, InjectedFault):
            return None

    def promote_hit(self, hit, pages: List[int]) -> None:
        """Fault a host-resident hit back in: rewrite the index path onto
        ``pages`` and scatter the slot bytes into them. On an injected
        ``swap_in`` fault the index is demoted BACK and the fault re-raised
        — the scheduler admits cold with the host copy intact."""
        s = self._session
        prefix = s.prefix
        plan = prefix.promote(hit, pages)   # [(slot, page)], path rewritten
        if s.faults is not None and s.faults.should_fire("swap_in"):
            prefix.demote_back(hit, plan)
            raise InjectedFault("swap_in", f"promote({len(plan)} pages)")
        s._ensure_pool()
        self.mgr.swap_in(s._pool, [sl for sl, _ in plan],
                         [p for _, p in plan])
        prefix.stats["promoted_pages"] += len(plan)

    def to_host(self, tree):
        """Record payloads crossing a session hand-back, on the host."""
        return to_host(tree)

    def stats_dict(self) -> dict:
        return self.mgr.stats_dict()
