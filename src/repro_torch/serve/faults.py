"""Deterministic fault injection for the serve stack.

The port of the JAX package's ``serve/faults.py``, site for site: a
``FaultInjector`` registry armed per SITE with the poll indices at which to
fire. Serving at traffic scale means serving THROUGH faults, and B⊕LD makes
silent degradation uniquely dangerous (``sign()`` turns a numeric error into
a confidently wrong token), so the containment contract is binary: every
fault resolves to a TERMINAL status (``FAILED``/``SHED``/``EXPIRED``) on the
victim request or to a fallback with no victim at all, every page is
released (``session.audit()`` clean after drain), and every co-resident
request's greedy stream stays bit-identical to a fault-free run.

  ===============  ========================================================
  site             fires inside
  ===============  ========================================================
  page_alloc       ``PageAllocator.alloc`` — admission page grant, before
                   the free list moves
  fork_page        exact-hit copy-on-write fork (``ServeSession``)
  kernel_dispatch  the decode-segment dispatch (``ServeSession``), polled
                   on the host BEFORE the segment's first launch. On the
                   card a CUDA tensor never goes through a plain version,
                   and the CUDA-core routes are not bit-identical to the
                   tensor-core ones, so the fault is contained by
                   re-issuing the SAME segment once on the same routes:
                   nothing had been launched and the pool had not moved,
                   so there is no victim and no stream changes
  prefix_index     corrupts one radix node in place before the step; the
                   next lookup's checksum walk detects it and QUARANTINES
                   the index (cold admission — never wrong bytes)
  swap_out         device→host page copy (``serve/swap.py``: preemption
                   capture, prefix demotion) — contained by falling back
                   to recompute preemption / plain eviction
  swap_in          host→device copy (swap-resume restore, prefix
                   promotion) — contained by falling back to the
                   recompute prefill / cold admission; the host copy
                   survives
  host_pool        host slot allocation (``SwapManager.alloc_slots``),
                   atomic like ``page_alloc``; callers fall back as for
                   ``swap_out``
  device_oom       a SIMULATED out-of-memory at the decode-segment
                   dispatch, polled on the host before the segment: ONE
                   victim (the newest active request) fails, co-resident
                   lanes decode on bit-identically. It is not mapped to a
                   real ``torch.cuda.OutOfMemoryError``
  shard_loss       a mesh device dropping mid-segment (``ServeSession``
                   on a serve mesh's engine, polled first at the segment):
                   every active request FAILS with ``shard-lost:shardN``
                   and ``stats()["mesh"]`` stays unhealthy; never polled
                   on one device
  ckpt_corrupt     checkpoint-load byte corruption (``checkpoint/``): one
                   byte of a leaf's stream flipped before the crc32 walk,
                   which raises ``CheckpointCorruption``
  ===============  ========================================================

Injection is counted per site: ``arm(site, at=2)`` fires on the third
``should_fire`` poll of that site, so tests pin faults to exact admission
rounds or decode segments. Armed in the constructor
(``engine.session(faults=FaultInjector(...))``) or from the environment
(``REPRO_FAULTS="page_alloc@0,kernel_dispatch@3"`` →
``FaultInjector.from_env()``, read by every session when the variable is
set — the launcher's chaos mode).

Pure host bookkeeping.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

SITES = ("page_alloc", "fork_page", "kernel_dispatch", "prefix_index",
         "swap_out", "swap_in", "host_pool", "device_oom", "shard_loss",
         "ckpt_corrupt")


class InjectedFault(RuntimeError):
    """Raised at an armed site. The serve stack catches it at the
    containment boundary and converts it into a terminal request status;
    it escaping to the caller is a containment bug."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        self.detail = detail
        super().__init__(f"injected fault at {site}"
                         + (f" ({detail})" if detail else ""))


class FaultInjector:
    """Per-site, call-indexed fault trigger registry.

    >>> inj = FaultInjector({"page_alloc": [1]})   # second alloc fails
    >>> inj.arm("kernel_dispatch", at=0, times=2)  # first two segments
    """

    def __init__(self, plan: Optional[Dict[str, List[int]]] = None):
        self._at: Dict[str, set] = {}
        self._count: Dict[str, int] = {}
        self.fired: List[Tuple[str, int]] = []      # (site, call index) log
        for site, idxs in (plan or {}).items():
            for i in idxs:
                self.arm(site, at=i)

    def arm(self, site: str, *, at: int = 0, times: int = 1) -> "FaultInjector":
        """Fire at poll indices ``at .. at+times-1`` of ``site``."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (have {SITES})")
        self._at.setdefault(site, set()).update(range(at, at + times))
        return self

    def should_fire(self, site: str) -> bool:
        """Count one poll of ``site``; True iff this index is armed."""
        i = self._count.get(site, 0)
        self._count[site] = i + 1
        if i in self._at.get(site, ()):
            self.fired.append((site, i))
            return True
        return False

    @classmethod
    def from_env(cls, env: Optional[str] = None) -> Optional["FaultInjector"]:
        """Parse ``REPRO_FAULTS="site@idx,site@idx"`` (``@idx`` optional,
        default 0). Returns None when unset/empty — the common case costs
        one getenv per session, nothing per step.

        Parsing is STRICT: an unknown site name, an empty entry, or a
        malformed poll index raises ``ValueError`` naming the offending
        entry. A chaos plan with a typo'd site would otherwise compile to
        a plan that silently never fires — the drill would "pass" without
        ever drilling anything."""
        spec = os.environ.get("REPRO_FAULTS", "") if env is None else env
        spec = spec.strip()
        if not spec:
            return None
        inj = cls()
        for part in spec.split(","):
            part = part.strip()
            if not part:
                raise ValueError(
                    f"REPRO_FAULTS: empty entry in {spec!r} "
                    "(format: 'site@idx,site@idx')")
            site, _, idx = part.partition("@")
            site = site.strip()
            if site not in SITES:
                raise ValueError(
                    f"REPRO_FAULTS: unknown fault site {site!r} in entry "
                    f"{part!r} — refusing a plan that would silently never "
                    f"fire (have {SITES})")
            try:
                at = int(idx) if idx else 0
            except ValueError:
                raise ValueError(
                    f"REPRO_FAULTS: bad poll index {idx!r} in entry "
                    f"{part!r} (format: 'site@idx', idx a non-negative "
                    "integer)") from None
            if at < 0:
                raise ValueError(
                    f"REPRO_FAULTS: negative poll index in entry {part!r}")
            inj.arm(site, at=at)
        return inj


def corrupt_prefix_index(prefix) -> bool:
    """Flip tokens in the first radix node's key IN PLACE — the host-memory
    corruption / bookkeeping-bug stand-in. The node's sealed checksum no
    longer matches, so the next lookup that walks it (or ``audit()``)
    detects the mismatch and quarantines the index instead of admitting a
    request against pages holding some OTHER prompt's K/V bytes. Returns
    False when there is nothing to corrupt (empty/quarantined index)."""
    stack = list(prefix.root.children.values())
    while stack:
        node = stack.pop(0)
        if node.key.size:
            key = node.key.copy()
            key[0] ^= 0x5        # content no longer matches the checksum
            node.key = key
            return True
        stack.extend(node.children.values())
    return False
