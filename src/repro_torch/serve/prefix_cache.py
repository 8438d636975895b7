"""Radix-indexed prefix cache: ref-counted, copy-on-write page sharing.

The port of the JAX package's ``serve/prefix_cache.py``, host Python that
makes the same decisions: the same hit lengths, pages, splits, dedup
frees, LRU evictions and reclaim order.

  * a RADIX TREE over token-ID prefixes — each node owns a run of FULL
    pages (key length = pages * page_size). Divergence inside a node SPLITS
    it at the page boundary; the node keeps its identity as the tail so
    live pins (parent-chain walks) stay consistent;
  * EXACT RECORDS keyed by the full prompt: the partially-filled boundary
    page (if any), the mamba end state and the end-of-prompt logits. An
    identical prompt re-admits with ZERO prefill — the first token from the
    stored logits, the lane's SSM state restored, decode reading the very
    same page bytes — so a cache-hit stream is bit-identical to the cold
    run;
  * PAGE-BOUNDARY SSM SNAPSHOTS: each node keeps, per page, the mamba state
    after that page's last token, so a partial hit resumes the recurrence
    at the hit boundary (``Hit.ssm``);
  * PER-PAGE REFERENCE COUNTS (``paged_cache.PageAllocator``): the index
    owns one ref on every cached page; each live request using a shared
    page holds one more;
  * COPY-ON-WRITE: a request admitted off an exact record writes its decode
    rows into a private byte-identical fork of the record's boundary page
    (``paged_cache.fork_page``);
  * LRU RECLAIM: under page pressure the scheduler asks ``reclaim`` to free
    least-recently-used unpinned leaves / records; pinned paths (live
    requests, records) are never reclaimed.

Partial hits resume at a page boundary: the session prefills only the
uncached tail (``lm_prefill(offset=, prefix_pages=, prefix_ids=)``), whose
queries attend over the prefix rows AS STORED (dequantised under
kv_cache_quant), so a partial hit follows serve-over-cache semantics
rather than being bit-equal to a cold full prefill.

With a host swap tier attached (``self.swap``, serve/swap.py's
``SwapBridge``), LRU reclaim DEMOTES cold pages to pinned host buffers
instead of freeing them: the entry stays in the index with each
host-resident page encoded IN PLACE as ``-(slot + 1)`` (lengths and
checksums survive; the allocator never sees a negative id). A hit on a
host-resident path is promoted back onto fresh device pages (``promote``)
before admission sees it, byte-identical to the stored bytes, so exact hits
stay bit-identical. ``demote_all`` parks the WHOLE index (pages, boundary
records, SSM snapshots and end states, end logits) on host so it survives
the session's close; the next session of the same geometry adopts it.
Without a swap tier every path frees where it would demote.

Host bookkeeping only: the device work (copies, forks, prefills) is the
session's and the bridge's; this index moves page ids and opaque tensors.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class IndexCorruption(RuntimeError):
    """A node's content no longer matches its sealed checksum: the index
    would map token prefixes onto pages holding some OTHER prompt's K/V
    bytes. The scheduler catches this at lookup and QUARANTINES the index
    (cold admission from then on) — under Boolean numerics a wrong cache
    byte is amplified into confidently wrong tokens, so wrong-byte serving
    is never an acceptable failure mode."""


class _Node:
    """One radix-tree node: a run of full pages extending the parent.

    ``seal()`` checksums the (key, pages) content at every legitimate
    mutation (creation, split); ``ok()`` re-derives and compares, so any
    out-of-band mutation — a bookkeeping bug, the ``prefix_index`` fault
    injection — is detectable before the node's pages are served.
    """

    __slots__ = ("parent", "children", "key", "pages", "snaps", "ref",
                 "tick", "csum")

    def __init__(self, parent, key: np.ndarray, pages: List[int],
                 snaps: List[Any], tick: int, ref: int = 0):
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.key = key                  # int32 tokens, len == pages * P
        self.pages = pages              # physical page ids, logical order
        self.snaps = snaps              # per-page boundary SSM state (|None)
        self.ref = ref                  # pass-through pins (requests+records)
        self.tick = tick
        self.seal()

    def _content_csum(self) -> int:
        return zlib.crc32(
            np.ascontiguousarray(self.key, np.int32).tobytes(),
            zlib.crc32(np.asarray(self.pages, np.int64).tobytes()))

    def seal(self) -> None:
        self.csum = self._content_csum()

    def ok(self) -> bool:
        return self.csum == self._content_csum()


@dataclasses.dataclass
class _Record:
    """Exact full-prompt entry: boundary page + end state + end logits."""
    node: _Node                         # deepest full-page node of the path
    page: Optional[int]                 # partially-filled boundary page
    logits: Any                         # (1, 1, Vp) device tensor
    end_ssm: Any                        # {bi: {"h", "conv"}} device tree
    n_tokens: int
    tick: int


@dataclasses.dataclass
class Hit:
    """Lookup result the scheduler/session admit a request against."""
    exact: bool
    hit_len: int                        # tokens covered by shared pages
    node: _Node                         # deepest node on the path
    pages: List[int]                    # shared pages, logical order
    ssm: Any                            # boundary state at hit_len (partial)
    record: Optional[_Record]           # exact hits only


class PrefixCache:
    def __init__(self, page_size: int, max_records: int = 256):
        self.page_size = page_size
        # records hold off-page device arrays (full-vocab logits + SSM end
        # state) that PAGE-pressure reclaim never sees, so the record map
        # is count-bounded with its own LRU — distinct-prompt traffic must
        # not grow device memory without bound
        self.max_records = max_records
        self.root = _Node(None, np.zeros((0,), np.int32), [], [], 0)
        self.records: Dict[bytes, _Record] = {}
        self._tick = 0
        self.quarantined = False
        # host tier (serve/swap.py SwapBridge) — attached by the session;
        # None keeps every path below on the free-instead-of-demote
        # behavior, bit-for-bit the pre-swap semantics
        self.swap = None
        self.stats = {"lookups": 0, "exact_hits": 0, "partial_hits": 0,
                      "misses": 0, "hit_tokens": 0, "prompt_tokens": 0,
                      "inserted_pages": 0, "evicted_pages": 0,
                      "cow_forks": 0, "quarantines": 0,
                      "demoted_pages": 0, "promoted_pages": 0}

    # -- path helpers --------------------------------------------------------
    def _chain(self, node: _Node) -> List[_Node]:
        out = []
        while node is not self.root:
            out.append(node)
            node = node.parent
        return out[::-1]                # root-first

    def path_pages(self, node: _Node) -> List[int]:
        return [p for n in self._chain(node) for p in n.pages]

    def pin(self, node: _Node) -> None:
        for n in self._chain(node):
            n.ref += 1

    def unpin(self, node: _Node) -> None:
        for n in self._chain(node):
            n.ref -= 1
            assert n.ref >= 0, "prefix-cache pin count went negative"

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        for n in self._chain(node):
            n.tick = self._tick

    # -- split / walk --------------------------------------------------------
    def _split(self, node: _Node, j: int) -> _Node:
        """Split ``node`` after its first ``j`` pages; returns the new HEAD.
        ``node`` keeps its identity as the tail so every live parent-chain
        walk (request pins, record anchors) passes through the head —
        ``head.ref`` therefore starts at ``node.ref``."""
        P = self.page_size
        head = _Node(node.parent, node.key[:j * P], node.pages[:j],
                     node.snaps[:j], node.tick, ref=node.ref)
        node.parent.children[node.key[:P].tobytes()] = head
        head.children[node.key[j * P:(j + 1) * P].tobytes()] = node
        node.key = node.key[j * P:]
        node.pages = node.pages[j:]
        node.snaps = node.snaps[j:]
        node.parent = head
        node.seal()                     # legitimate mutation: re-checksum
        return head

    def _walk(self, tokens: np.ndarray, max_pages: int
              ) -> Tuple[_Node, List[int], int]:
        """Longest page-aligned match of ``tokens`` (up to ``max_pages``
        pages), splitting any partially-matched node so the returned node
        run ends exactly at the match boundary."""
        P = self.page_size
        node, pages, m = self.root, [], 0
        while m < max_pages:
            child = node.children.get(
                tokens[m * P:(m + 1) * P].tobytes())
            if child is None:
                break
            if not child.ok():
                raise IndexCorruption(
                    f"node at depth {m} pages failed its checksum")
            usable = min(len(child.pages), max_pages - m)
            j = 1                       # first page matched (the child key)
            while j < usable and np.array_equal(
                    child.key[j * P:(j + 1) * P],
                    tokens[(m + j) * P:(m + j + 1) * P]):
                j += 1
            if j < len(child.pages):
                child = self._split(child, j)
            node = child
            pages.extend(child.pages)
            m += j
        return node, pages, m

    # -- lookup --------------------------------------------------------------
    def lookup(self, tokens: np.ndarray) -> Optional[Hit]:
        """Longest cached prefix of ``tokens``. Exact records win (zero
        prefill); otherwise the longest page-aligned prefix STRICTLY
        shorter than the prompt, so the tail prefill always has >= 1 token
        to produce the next-token logits from. Pure w.r.t. stats and LRU
        ticks — those move on ``commit_hit`` when the request actually
        admits, so a blocked queue head retrying every scheduling round
        inflates nothing.

        Every node on the returned path is checksum-verified as it is
        walked; a mismatch raises ``IndexCorruption`` — the scheduler's
        cue to ``quarantine`` the index rather than serve wrong bytes. A
        quarantined index answers every lookup with None (cold admission).
        """
        if self.quarantined:
            return None
        tokens = np.ascontiguousarray(tokens, np.int32)
        rec = self.records.get(tokens.tobytes())
        if rec is not None:
            for n in self._chain(rec.node):
                if not n.ok():
                    raise IndexCorruption(
                        "record path node failed its checksum")
            return Hit(exact=True, hit_len=int(tokens.size), node=rec.node,
                       pages=self.path_pages(rec.node), ssm=None, record=rec)
        node, pages, m = self._walk(tokens, (tokens.size - 1)
                                    // self.page_size)
        if m == 0:
            return None
        return Hit(exact=False, hit_len=m * self.page_size, node=node,
                   pages=pages, ssm=node.snaps[-1] if node.snaps else None,
                   record=None)

    def commit_hit(self, hit: Optional[Hit], n_tokens: int) -> None:
        """Fold an ADMITTED request's lookup into stats + LRU ticks."""
        self.stats["lookups"] += 1
        self.stats["prompt_tokens"] += int(n_tokens)
        if hit is None:
            self.stats["misses"] += 1
            return
        self._touch(hit.node)
        if hit.exact:
            hit.record.tick = self._tick
            self.stats["exact_hits"] += 1
        else:
            self.stats["partial_hits"] += 1
        self.stats["hit_tokens"] += hit.hit_len

    # -- insert / release ----------------------------------------------------
    def release(self, req, alloc, insert: bool) -> None:
        """Drop a request's hold on the index. ``insert=True`` (the finish
        path) first donates the request's prefilled prompt pages to the
        index (dedup frees byte-duplicate private pages); cancel/evict pass
        ``insert=False``. Either way the request's per-page user refs and
        its path pin are released — pages it alone owned free here."""
        consumed = set()
        if insert and req.cache_extras is not None:
            consumed = self._insert(req, alloc)
        for p in req.shared_pages:
            alloc.decref(p)
        for p in req.private_pages:
            if p not in consumed:
                alloc.decref(p)
        if req.hit is not None:
            if req.hit.exact and req.hit.record.page is not None:
                alloc.decref(req.hit.record.page)   # CoW-source hold
            self.unpin(req.hit.node)
        req.hit = None
        req.cache_extras = None

    def _insert(self, req, alloc) -> set:
        """Donate a finished request's prompt pages. Returns the private
        pages whose ownership TRANSFERRED to the index (their refcount-1
        now means "owned by the cache"); duplicates of already-cached
        pages are left to ``release`` to free."""
        if self.quarantined:        # bypass mode: nothing enters the index,
            return set()            # release() frees every request page
        ex = req.cache_extras
        tokens = np.ascontiguousarray(ex["tokens"], np.int32)
        P = self.page_size
        S = int(tokens.size)
        n_full = S // P
        node, _, m = self._walk(tokens, n_full)
        consumed = set()
        self._tick += 1
        if m < n_full:
            # logical page j's physical id is req.pages[j]; snapshots are
            # tail-relative to the request's prefill offset o: page j's
            # boundary (j+1)*P maps to snap index (j+1) - o/P - 1.
            o = ex["offset"]
            new_pages = [req.pages[j] for j in range(m, n_full)]
            snaps = [self._slice_snap(ex["snaps"], (j + 1) - o // P - 1)
                     for j in range(m, n_full)]
            child = _Node(node, tokens[m * P:n_full * P], new_pages, snaps,
                          self._tick)
            node.children[tokens[m * P:(m + 1) * P].tobytes()] = child
            consumed.update(new_pages)
            self.stats["inserted_pages"] += len(new_pages)
            node = child
        kb = tokens.tobytes()
        if kb not in self.records and ex.get("record_ok", True):
            if len(self.records) >= self.max_records:
                self._evict_lru_record(alloc)
            bpage = req.pages[n_full] if S % P else None
            if bpage is not None:
                consumed.add(bpage)
                self.stats["inserted_pages"] += 1
            self.records[kb] = _Record(
                node=node, page=bpage, logits=ex["logits"],
                end_ssm=ex["end_ssm"], n_tokens=S, tick=self._tick)
            self.pin(node)              # the record pins its path
        self._touch(node)
        return consumed

    def _evict_record(self, kb: bytes, alloc) -> bool:
        """Drop one record: unpin its path, release its boundary page —
        a host-resident boundary (negative id) frees its SLOT instead.
        Returns True iff a DEVICE page actually freed."""
        rec = self.records.pop(kb)
        self.unpin(rec.node)
        if rec.page is not None:
            if rec.page < 0:
                if self.swap is not None:
                    self.swap.free_slots([-rec.page - 1])
                return False
            if alloc.decref(rec.page):
                self.stats["evicted_pages"] += 1
                return True
        return False

    def _evict_lru_record(self, alloc) -> None:
        kb = min(self.records, key=lambda k: self.records[k].tick)
        self._evict_record(kb, alloc)

    @staticmethod
    def _slice_snap(snaps, idx: int):
        """Boundary ``idx`` of a prefill's snapshots {bi: {"h", "conv"}}
        (leaves (n_groups, 1, n_boundaries, ...)) -> copies (n_groups, 1,
        ...), so the other boundaries' memory frees; None without
        snapshots (no mamba block)."""
        if not snaps:
            return None
        return {bi: {name: t[:, :, idx].clone() for name, t in leaves.items()}
                for bi, leaves in snaps.items()}

    # -- reclaim -------------------------------------------------------------
    def _reclaimable(self, alloc) -> int:
        """DEVICE pages a full sweep COULD free right now: record boundary
        pages with no extra holders, plus every node whose pass-through
        ref is entirely record pins (pins are transitive, so a node with
        zero non-record refs heads a fully drainable subtree once its
        records go). Host-resident ids (negative) occupy no device page
        and count for nothing."""
        rec_pins: Dict[int, int] = {}
        n = 0
        for rec in self.records.values():
            for node in self._chain(rec.node):
                rec_pins[id(node)] = rec_pins.get(id(node), 0) + 1
            if rec.page is not None and rec.page >= 0 \
                    and alloc.refs[rec.page] == 1:
                n += 1
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self.root \
                    and node.ref == rec_pins.get(id(node), 0):
                n += sum(1 for p in node.pages if p >= 0)
        return n

    def _demote_record(self, rec: _Record, alloc) -> bool:
        """Move one record's boundary page to host IN PLACE: the record
        stays in the index as a host-resident exact hit. True on success;
        False (host budget / injected fault / extra holders) means the
        caller falls back to plain eviction."""
        if self.swap is None or rec.page is None or rec.page < 0 \
                or alloc.refs[rec.page] != 1:
            return False
        slots = self.swap.demote([rec.page])
        if slots is None:
            return False
        page, rec.page = rec.page, -(slots[0] + 1)
        alloc.decref(page)
        self.stats["demoted_pages"] += 1
        return True

    def _demote_node(self, node: _Node, alloc) -> int:
        """Move a node's device pages to host IN PLACE (the node survives,
        its ids rewritten to encoded slots, resealed). Returns the number
        of device pages freed; 0 means fall back to plain eviction."""
        pos = [p for p in node.pages if p >= 0]
        if self.swap is None or not pos \
                or any(alloc.refs[p] != 1 for p in pos):
            return 0
        if not node.ok():
            # demote reseals the node — silently re-checksumming corrupted
            # content would LAUNDER the corruption into a valid seal
            raise IndexCorruption("demote victim failed its checksum")
        slots = self.swap.demote(pos)
        if slots is None:
            return 0
        it = iter(slots)
        node.pages = [(-(next(it) + 1) if p >= 0 else p)
                      for p in node.pages]
        node.seal()                     # legitimate mutation: re-checksum
        for p in pos:
            alloc.decref(p)
        self.stats["demoted_pages"] += len(pos)
        return len(pos)

    def _evict_node(self, node: _Node, alloc) -> int:
        """Plain leaf eviction; host-resident entries free their slots.
        Returns the number of device pages freed. The victim is
        integrity-checked FIRST: corruption nobody has looked up yet
        (``corrupt_prefix_index`` flips key bytes in place) would
        otherwise make the keyed pop below remove the wrong sibling — or
        KeyError out of the containment path itself. A mismatch raises
        ``IndexCorruption``, the reclaim caller's cue to quarantine."""
        kb = node.key[:self.page_size].tobytes()
        if not node.ok() or node.parent.children.get(kb) is not node:
            raise IndexCorruption(
                "reclaim victim failed its integrity check")
        node.parent.children.pop(kb)
        freed = 0
        for p in node.pages:
            if p < 0:
                if self.swap is not None:
                    self.swap.free_slots([-p - 1])
            elif alloc.decref(p):
                freed += 1
                self.stats["evicted_pages"] += 1
        return freed

    def _reclaim_candidates(self, alloc) -> List[Tuple[int, int, Any]]:
        """LRU-ordered entries whose demotion/eviction frees DEVICE
        pages. Records: a device boundary page. Nodes: >= 1 device page
        AND either unpinned leaves (evictable, the no-swap-tier shape) or
        — with a swap tier — nodes whose every pin is a RECORD pin:
        pins forbid EVICTION (the record's path must survive), not
        demote-in-place, and no live request is reading the pages.
        Host-only entries are never candidates: touching them frees no
        device page, it only destroys the host tier's hit potential."""
        rec_pins: Dict[int, int] = {}
        for rec in self.records.values():
            for node in self._chain(rec.node):
                rec_pins[id(node)] = rec_pins.get(id(node), 0) + 1
        cands: List[Tuple[int, int, Any]] = []
        for kb, rec in self.records.items():
            if rec.page is not None and rec.page >= 0:
                cands.append((rec.tick, 0, (kb, rec)))
            elif self.swap is None and rec.page is None:
                # no swap tier: a boundary-less record frees nothing
                # itself but eviction unpins its path, surfacing the
                # chain's nodes as evictable leaves on later rounds
                cands.append((rec.tick, 0, (kb, rec)))
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is self.root or not any(p >= 0 for p in n.pages):
                continue
            if n.ref == 0 and not n.children:
                cands.append((n.tick, 1, n))
            elif self.swap is not None \
                    and n.ref == rec_pins.get(id(n), 0):
                cands.append((n.tick, 1, n))
        cands.sort(key=lambda c: (c[0], c[1]))
        return cands

    def reclaim(self, alloc, need: int) -> bool:
        """Free >= ``need`` DEVICE pages, LRU-first. With a swap tier,
        demotion is tried before eviction: the entry stays serveable from
        host RAM, its ids rewritten in place, and a later hit faults the
        bytes back in. Plain eviction is the fallback when the host
        budget is exhausted, a ``swap_out`` fault fires, or there is no
        swap tier at all. A pinned node whose demote fails cannot be
        evicted directly — its LRU pinning record is evicted instead,
        unpinning the path so the node surfaces as an evictable leaf on a
        later round (the pre-swap reclaim order, reached only under host
        pressure). Infeasible targets fail FAST — before any eviction —
        so a transiently unadmittable request never flushes the index for
        nothing; the caller's request waits, and it is never deadlocked
        by cache-held pages since everything unpinned stays reachable."""
        if need > self._reclaimable(alloc):
            return False
        freed = 0
        while freed < need:
            cands = self._reclaim_candidates(alloc)
            if not cands:
                return False
            _, kind, victim = cands[0]
            if kind == 0:
                kb, rec = victim
                if self._demote_record(rec, alloc):
                    freed += 1
                elif self._evict_record(kb, alloc):
                    freed += 1
            else:
                n_demoted = self._demote_node(victim, alloc)
                if n_demoted:
                    freed += n_demoted
                elif victim.ref == 0 and not victim.children:
                    freed += self._evict_node(victim, alloc)
                elif self.records:
                    self._evict_lru_record(alloc)   # unpin, retry next round
                else:
                    return False
        return True

    # -- host-tier promotion / parking ---------------------------------------
    def promote(self, hit: Hit, new_pages: List[int]
                ) -> List[Tuple[int, int]]:
        """Rewrite a hit's host-resident ids with freshly allocated device
        pages, root-first along the path (+ the exact record's boundary
        page last). Returns the copy plan ``[(slot, page), ...]`` — the
        bridge runs the actual ``swap_in`` against it; pure bookkeeping
        here so a faulted copy can be undone with ``demote_back``. The
        new pages' refcount-1 becomes the index ownership ref."""
        plan: List[Tuple[int, int]] = []
        it = iter(new_pages)
        for n in self._chain(hit.node):
            changed = False
            for i, p in enumerate(n.pages):
                if p < 0:
                    q = next(it)
                    plan.append((-p - 1, q))
                    n.pages[i] = q
                    changed = True
            if changed:
                n.seal()                # legitimate mutation: re-checksum
        rec = hit.record
        if rec is not None and rec.page is not None and rec.page < 0:
            q = next(it)
            plan.append((-rec.page - 1, q))
            rec.page = q
        hit.pages = self.path_pages(hit.node)
        return plan

    def demote_back(self, hit: Hit, plan: List[Tuple[int, int]]) -> None:
        """Undo ``promote`` bookkeeping after a faulted copy: the device
        pages were never written, so the host slots stay authoritative —
        restore the encoded ids in place. The caller returns the pages."""
        back = {page: -(slot + 1) for slot, page in plan}
        for n in self._chain(hit.node):
            changed = False
            for i, p in enumerate(n.pages):
                if p in back:
                    n.pages[i] = back[p]
                    changed = True
            if changed:
                n.seal()
        rec = hit.record
        if rec is not None and rec.page is not None and rec.page in back:
            rec.page = back[rec.page]
        hit.pages = self.path_pages(hit.node)

    def _drop_subtree(self, node: _Node, alloc, dropped: set) -> None:
        """Hard-evict a whole subtree mid-``demote_all`` (its pages could
        not be parked): records anchored inside go first (their unpins
        walk through live ancestors), then every page/slot releases and
        the subtree detaches. ``dropped`` collects the node ids so the
        caller's traversal skips them."""
        sub = set()
        stack = [node]
        while stack:
            n = stack.pop()
            sub.add(id(n))
            stack.extend(n.children.values())
        for kb in [kb for kb, rec in self.records.items()
                   if id(rec.node) in sub]:
            self._evict_record(kb, alloc)
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            for p in n.pages:
                if p < 0:
                    if self.swap is not None:
                        self.swap.free_slots([-p - 1])
                elif alloc.decref(p):
                    self.stats["evicted_pages"] += 1
        node.parent.children.pop(node.key[:self.page_size].tobytes(), None)
        dropped.update(sub)

    def demote_all(self, alloc) -> None:
        """Park the ENTIRE index on host ahead of ``CachePool`` hand-back:
        every device page demotes to a slot, record logits / SSM end
        states / node boundary snapshots move to host arrays. Entries that
        cannot park (host budget exhausted, injected ``swap_out`` fault,
        unexpected extra page holders) are evicted instead — the parked
        index is always internally consistent, just possibly smaller. The
        caller hands the (now page-free) index to ``ServeEngine`` for the
        next same-geometry session to adopt."""
        if self.swap is None or self.quarantined:
            return
        for kb in list(self.records):
            rec = self.records[kb]
            if rec.page is not None and rec.page >= 0 \
                    and not self._demote_record(rec, alloc):
                self._evict_record(kb, alloc)
                continue
            rec.logits = self.swap.to_host(rec.logits)
            rec.end_ssm = self.swap.to_host(rec.end_ssm)
        dropped: set = set()
        nodes, stack = [], [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root:
                nodes.append(n)
        for n in nodes:
            if id(n) in dropped:
                continue
            if any(p >= 0 for p in n.pages) \
                    and not self._demote_node(n, alloc):
                self._drop_subtree(n, alloc, dropped)
                continue
            n.snaps = [self.swap.to_host(s) for s in n.snaps]

    # -- integrity: verify / quarantine / audit ------------------------------
    def _owned_page_iter(self):
        """Device pages the index owns a ref on — host-resident (negative)
        ids are NOT pages and never reach the allocator."""
        for rec in self.records.values():
            if rec.page is not None and rec.page >= 0:
                yield rec.page
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root:
                yield from (p for p in n.pages if p >= 0)

    def _host_slot_iter(self):
        """Host slots the index owns (record boundaries + node runs)."""
        for rec in self.records.values():
            if rec.page is not None and rec.page < 0:
                yield -rec.page - 1
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root:
                yield from (-p - 1 for p in n.pages if p < 0)

    def verify(self) -> None:
        """Full-tree integrity walk; raises ``IndexCorruption`` on the
        first bad node (checksum mismatch, broken parent/child links, a
        child dict key that no longer matches its node's tokens, orphaned
        records). O(index size) host work — run by ``audit()`` and by
        hardened sessions each step; the per-lookup path checks catch the
        serving-wrong-bytes case even when this never runs."""
        if self.quarantined:
            return
        P = self.page_size
        seen = {id(self.root)}
        stack = [self.root]
        while stack:
            n = stack.pop()
            for kb, c in n.children.items():
                if c.parent is not n:
                    raise IndexCorruption("child/parent link mismatch")
                if not c.ok():
                    raise IndexCorruption("node failed its checksum")
                if kb != np.ascontiguousarray(c.key[:P],
                                              np.int32).tobytes():
                    raise IndexCorruption(
                        "child dict key != node key bytes")
                if len(c.key) != len(c.pages) * P:
                    raise IndexCorruption("key length != pages * page_size")
                seen.add(id(c))
                stack.append(c)
        for rec in self.records.values():
            if id(rec.node) not in seen:
                raise IndexCorruption("orphaned record: node not in tree")

    def flush(self, alloc) -> int:
        """Drop the whole index, releasing every owned page (record
        boundary pages + node runs). Live requests keep their own per-page
        refs and path pins — the root object survives (children cleared in
        place) so their parent-chain unpins still terminate. Decrefs are
        individually guarded: a corrupted page id must not crash the
        containment path that exists to survive corruption (anything it
        cannot release shows up in the allocator audit as a leak, counted
        here). Returns the number of pages actually freed."""
        freed = 0
        if self.swap is not None:
            slots = list(self._host_slot_iter())
            if slots:
                self.swap.free_slots(slots)
        for p in list(self._owned_page_iter()):
            try:
                if alloc.decref(p):
                    freed += 1
                    self.stats["evicted_pages"] += 1
            except (ValueError, IndexError, TypeError):
                pass
        self.root.children = {}
        self.records = {}
        return freed

    def quarantine(self, alloc) -> int:
        """Contain detected corruption: flush the index and disable it —
        every later lookup misses (cold admission) and nothing new is
        inserted. Cold admission is always CORRECT (hits are a pure
        optimization), so quarantine trades hit rate for never serving a
        byte the index cannot vouch for."""
        freed = self.flush(alloc)
        self.quarantined = True
        self.stats["quarantines"] += 1
        return freed

    def audit(self, alloc, external_pins: Optional[Dict[int, int]] = None
              ) -> dict:
        """Bookkeeping invariants beyond ``verify``'s content checks:
        every indexed page is live in the allocator (never free/garbage),
        record paths are pinned, node pin counts reconcile as
        record pins + live-request pins (``external_pins``: {id(node):
        count} census the session computes from active requests; without
        it only the record-pin lower bound is checked), and the record map
        respects its LRU bound. Raises ``RuntimeError`` on violation."""
        self.verify()
        def _host_ok(p: int) -> bool:
            return self.swap is not None \
                and 0 <= (-p - 1) < self.swap.host_pages

        rec_pins: Dict[int, int] = {}
        for rec in self.records.values():
            for n in self._chain(rec.node):
                rec_pins[id(n)] = rec_pins.get(id(n), 0) + 1
            if rec.page is not None and rec.page < 0:
                if not _host_ok(rec.page):
                    raise RuntimeError(
                        f"audit: record host slot {-rec.page - 1} out of "
                        "bounds / no swap tier")
            elif rec.page is not None and not (
                    0 < rec.page < alloc.n_pages
                    and alloc.refs[rec.page] >= 1):
                raise RuntimeError(
                    f"audit: record boundary page {rec.page} is not owned")
        n_nodes = n_pages = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is self.root:
                continue
            n_nodes += 1
            n_pages += len(n.pages)
            for p in n.pages:
                if p < 0:
                    if not _host_ok(p):
                        raise RuntimeError(
                            f"audit: indexed host slot {-p - 1} out of "
                            "bounds / no swap tier")
                elif not (0 < p < alloc.n_pages and alloc.refs[p] >= 1):
                    raise RuntimeError(
                        f"audit: indexed page {p} is free/garbage")
            want = rec_pins.get(id(n), 0)
            if external_pins is not None:
                want += external_pins.get(id(n), 0)
                if n.ref != want:
                    raise RuntimeError(
                        f"audit: node pin count {n.ref} != {want} "
                        "(records + live requests)")
            elif n.ref < want:
                raise RuntimeError(
                    f"audit: node pin count {n.ref} < {want} record pins")
        if len(self.records) > self.max_records:
            raise RuntimeError(
                f"audit: {len(self.records)} records > LRU bound "
                f"{self.max_records}")
        return {"nodes": n_nodes, "pages": n_pages,
                "records": len(self.records),
                "quarantined": self.quarantined}

    # -- introspection -------------------------------------------------------
    @property
    def owned_pages(self) -> int:
        """DEVICE pages owned (host-resident entries count under
        ``host_resident_pages``)."""
        return sum(1 for _ in self._owned_page_iter())

    @property
    def host_resident_pages(self) -> int:
        return sum(1 for _ in self._host_slot_iter())

    @property
    def hit_rate(self) -> float:
        h = self.stats["exact_hits"] + self.stats["partial_hits"]
        return h / max(self.stats["lookups"], 1)
