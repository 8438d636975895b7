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

The host swap tier's demotion and promotion (``_demote_*``, ``promote``, ``demote_back``, ``demote_all``)
with the tiered-memory slice. Without a swap tier the JAX package frees
where it would demote, which is what this index does.
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
    (cold admission from then on)."""


class _Node:
    """One radix-tree node: a run of full pages extending the parent.

    ``seal()`` checksums the (key, pages) content at every legitimate
    mutation (creation, split); ``ok()`` re-derives and compares, so any
    out-of-band mutation is detectable before the node's pages are served.
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
        # records hold off-page device tensors (full-vocab logits) that
        # PAGE-pressure reclaim never sees, so the record map is
        # count-bounded with its own LRU
        self.max_records = max_records
        self.root = _Node(None, np.zeros((0,), np.int32), [], [], 0)
        self.records: Dict[bytes, _Record] = {}
        self._tick = 0
        self.quarantined = False
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
        ``node`` keeps its identity as the tail, so ``head.ref`` starts at
        ``node.ref``."""
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
        pages), splitting a partially-matched node so the returned node run
        ends exactly at the match boundary."""
        P = self.page_size
        node, pages, m = self.root, [], 0
        while m < max_pages:
            child = node.children.get(tokens[m * P:(m + 1) * P].tobytes())
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
        shorter than the prompt, so the tail prefill always has >= 1 token.
        Pure w.r.t. stats and LRU ticks (``commit_hit`` moves those when
        the request admits). Every node on the path is checksum-verified; a
        mismatch raises ``IndexCorruption``. A quarantined index misses."""
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
        index (dedup frees byte-duplicate private pages); cancel passes
        ``insert=False``. Either way the request's per-page refs and its
        path pin are released."""
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
        pages whose ownership TRANSFERRED to the index; duplicates of
        already-cached pages are left to ``release`` to free."""
        if self.quarantined:        # bypass mode: nothing enters the index
            return set()
        ex = req.cache_extras
        tokens = np.ascontiguousarray(ex["tokens"], np.int32)
        P = self.page_size
        S = int(tokens.size)
        n_full = S // P
        node, _, m = self._walk(tokens, n_full)
        consumed = set()
        self._tick += 1
        if m < n_full:
            # logical page j's physical id is req.pages[j]; the snapshots
            # are relative to the request's prefill offset o: page j's
            # boundary (j+1)*P is snapshot (j+1) - o/P - 1
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
            self.records[kb] = _Record(node=node, page=bpage,
                                       logits=ex["logits"],
                                       end_ssm=ex["end_ssm"], n_tokens=S,
                                       tick=self._tick)
            self.pin(node)              # the record pins its path
        self._touch(node)
        return consumed

    def _evict_record(self, kb: bytes, alloc) -> bool:
        """Drop one record: unpin its path, release its boundary page.
        Returns True iff a page actually freed."""
        rec = self.records.pop(kb)
        self.unpin(rec.node)
        if rec.page is not None and alloc.decref(rec.page):
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
        """Pages a full sweep COULD free right now: record boundary pages
        with no extra holders, plus every node whose pass-through ref is
        entirely record pins (pins are transitive, so such a node heads a
        fully drainable subtree once its records go)."""
        rec_pins: Dict[int, int] = {}
        n = 0
        for rec in self.records.values():
            for node in self._chain(rec.node):
                rec_pins[id(node)] = rec_pins.get(id(node), 0) + 1
            if rec.page is not None and alloc.refs[rec.page] == 1:
                n += 1
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self.root \
                    and node.ref == rec_pins.get(id(node), 0):
                n += len(node.pages)
        return n

    def _evict_node(self, node: _Node, alloc) -> int:
        """Plain leaf eviction; returns the number of pages freed. The
        victim is integrity-checked first: a corrupted key would make the
        keyed pop remove the wrong sibling."""
        kb = node.key[:self.page_size].tobytes()
        if not node.ok() or node.parent.children.get(kb) is not node:
            raise IndexCorruption("reclaim victim failed its integrity check")
        node.parent.children.pop(kb)
        freed = 0
        for p in node.pages:
            if alloc.decref(p):
                freed += 1
                self.stats["evicted_pages"] += 1
        return freed

    def _reclaim_candidates(self) -> List[Tuple[int, int, Any]]:
        """LRU-ordered entries whose eviction frees pages or unpins a path:
        every record (a boundary-less one frees nothing itself but unpins
        its path, surfacing the chain's nodes as evictable leaves on later
        rounds) and every unpinned leaf."""
        cands: List[Tuple[int, int, Any]] = [
            (rec.tick, 0, (kb, rec)) for kb, rec in self.records.items()]
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and n.pages and n.ref == 0 \
                    and not n.children:
                cands.append((n.tick, 1, n))
        cands.sort(key=lambda c: (c[0], c[1]))
        return cands

    def reclaim(self, alloc, need: int) -> bool:
        """Free >= ``need`` pages, LRU-first. A pinned path cannot be
        evicted directly; evicting its LRU record unpins it so its nodes
        surface as evictable leaves on a later round. Infeasible targets
        fail FAST, before any eviction, so an unadmittable request never
        flushes the index for nothing."""
        if need > self._reclaimable(alloc):
            return False
        freed = 0
        while freed < need:
            cands = self._reclaim_candidates()
            if not cands:
                return False
            _, kind, victim = cands[0]
            if kind == 0:
                if self._evict_record(victim[0], alloc):
                    freed += 1
            else:
                freed += self._evict_node(victim, alloc)
        return True

    # -- integrity: verify / quarantine / audit ------------------------------
    def _owned_page_iter(self):
        """Pages the index owns a ref on."""
        for rec in self.records.values():
            if rec.page is not None:
                yield rec.page
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root:
                yield from n.pages

    def verify(self) -> None:
        """Full-tree integrity walk; raises ``IndexCorruption`` on the
        first bad node (checksum mismatch, broken parent/child links, a
        child key that no longer matches its node's tokens, orphaned
        records)."""
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
                if kb != np.ascontiguousarray(c.key[:P], np.int32).tobytes():
                    raise IndexCorruption("child dict key != node key bytes")
                if len(c.key) != len(c.pages) * P:
                    raise IndexCorruption("key length != pages * page_size")
                seen.add(id(c))
                stack.append(c)
        for rec in self.records.values():
            if id(rec.node) not in seen:
                raise IndexCorruption("orphaned record: node not in tree")

    def flush(self, alloc) -> int:
        """Drop the whole index, releasing every owned page. Live requests
        keep their own page refs and path pins (the root survives with its
        children cleared, so their unpins still terminate). Decrefs are
        guarded one by one: a corrupted page id must not crash the
        containment path. Returns the number of pages freed."""
        freed = 0
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
        every later lookup misses and nothing new is inserted."""
        freed = self.flush(alloc)
        self.quarantined = True
        self.stats["quarantines"] += 1
        return freed

    def audit(self, alloc, external_pins: Optional[Dict[int, int]] = None
              ) -> dict:
        """Bookkeeping invariants beyond ``verify``: every indexed page is
        live in the allocator, record paths are pinned, node pin counts
        reconcile as record pins + live-request pins (``external_pins``:
        {id(node): count} from the session's active requests), and the
        record map respects its bound. Raises ``RuntimeError``."""
        self.verify()
        rec_pins: Dict[int, int] = {}
        for rec in self.records.values():
            for n in self._chain(rec.node):
                rec_pins[id(n)] = rec_pins.get(id(n), 0) + 1
            if rec.page is not None and not (
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
                if not (0 < p < alloc.n_pages and alloc.refs[p] >= 1):
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
        return sum(1 for _ in self._owned_page_iter())

    @property
    def hit_rate(self) -> float:
        h = self.stats["exact_hits"] + self.stats["partial_hits"]
        return h / max(self.stats["lookups"], 1)
