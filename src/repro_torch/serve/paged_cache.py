"""Block-table paged KV caches carved from one preallocated pool.

ONE pool of fixed-size pages is allocated per session; a request owns just
the pages its prompt + token budget needs, and a per-lane block table maps
logical cache rows to physical pages. Layout, as in the JAX package's
``serve/paged_cache.py``: attention roles hold ``k``/``v`` pools
(n_groups, n_pages, page, KVp, hd); physical page 0 is RESERVED as the
garbage page — idle and overrun lanes point at it, so their writes never
touch pages owned by live requests.
"""
from __future__ import annotations

from collections import deque

import torch

from repro_torch.models import ModelConfig, block_roles
from repro_torch.models import attention as A


def pages_for(prompt_len: int, n_tokens: int, page_size: int) -> int:
    """Pages a request must own: ceil((prompt + n - 1) / page).

    The first token is sampled from prefill logits and emitted AT ADMISSION,
    so decode steps produce tokens t1..t_{n-1} and write cache rows prompt
    .. prompt+n-2 — prompt+n-1 rows in all.
    """
    return -(-(prompt_len + n_tokens - 1) // page_size)


def paged_pool_init(cfg: ModelConfig, n_pages: int, page_size: int, device):
    """One zeroed pool tree for all lanes: {"b{i}": {"k", "v"}}. A page pool
    IS an attention cache with batch = n_pages rows of length page_size."""
    blocks = {}
    for i, role in enumerate(block_roles(cfg)):
        if role["mixer"] == "mamba":
            raise NotImplementedError("lane-indexed SSM state comes with the "
                                      "mamba slice")
        blocks[f"b{i}"] = A.attention_cache_init(cfg, n_pages, page_size,
                                                 device, lead=(cfg.n_groups,))
    return blocks


def commit_prefill(cfg: ModelConfig, pool, prefill_blocks,
                   page_ids: torch.Tensor, page_size: int, length=None):
    """Scatter a batch-1 prefilled contiguous cache into the pool, in place.

    prefill_blocks: ``lm_prefill``'s cache["blocks"] at batch 1 (leaves
    (n_groups, 1, S, ...)); page_ids: (npp,) physical pages receiving the
    request's logical pages 0.. (the JAX package's ``lane`` argument, the
    slot of a mamba block's state, comes with the mamba slice).
    ``length``: the true prompt length when the prefill was right-padded to
    a bucket. Rows at and past it are zeroed before the scatter — the pool
    bytes equal an unpadded commit — and ``page_ids`` entries past the
    request's real pages may point at the garbage page 0, which absorbs
    only zero rows.
    """
    npp = page_ids.shape[0]
    idx = page_ids.to(device=next(iter(pool.values()))["k"].device,
                      dtype=torch.long)
    for i, _ in enumerate(block_roles(cfg)):
        for name, full in pool[f"b{i}"].items():
            new = prefill_blocks[f"b{i}"][name]
            G, S = new.shape[0], new.shape[2]
            rows = torch.zeros((G, npp * page_size) + tuple(new.shape[3:]),
                               dtype=full.dtype, device=full.device)
            n = S if length is None else min(S, int(length))
            rows[:, :n] = new[:, 0, :n]
            full[:, idx] = rows.reshape((G, npp, page_size) + tuple(new.shape[3:]))
    return pool


class PageAllocator:
    """Host-side reference-counted physical-page allocator.

    Page 0 is the reserved garbage page (permanently pinned). Every other
    page is FREE or carries a refcount; a page returns to the END of the
    FIFO free list exactly when its count reaches zero — the same order as
    the JAX package's allocator, so both hand out the same page ids. Shared
    pages (``incref``) come with the prefix cache.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the garbage page)")
        self.n_pages = n_pages
        self.refs = [0] * n_pages
        self.refs[0] = 1                       # garbage page: never freed
        self._free = deque(range(1, n_pages))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def free_pages(self):
        """Snapshot view of the free list (tests/diagnostics)."""
        return tuple(self._free)

    def alloc(self, n: int):
        """Take ``n`` fresh pages at refcount 1 (FIFO order). Atomic: an
        over-ask raises before the free list moves."""
        if n > len(self._free):
            raise ValueError(f"alloc({n}) with only {len(self._free)} free")
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
        return pages

    def decref(self, page: int) -> bool:
        """Drop one reference; True iff the page actually freed."""
        if page <= 0 or self.refs[page] <= 0:
            raise ValueError(f"decref on free/garbage page {page}")
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._free.append(page)
            return True
        return False

    def audit(self, holds=None) -> dict:
        """Invariant check; raises ``RuntimeError`` on the first violation:
        page 0 pinned at exactly 1 and never free, no negative counts, a
        page is on the free list exactly when its count is 0, and (given
        ``holds``, a {page: expected_refs} census from the holders' own
        books) every count matches its holders."""
        if self.refs[0] != 1:
            raise RuntimeError(
                f"audit: garbage page 0 refcount {self.refs[0]} != 1")
        free = set(self._free)
        if len(free) != len(self._free):
            raise RuntimeError("audit: duplicate entries on the free list")
        if 0 in free:
            raise RuntimeError("audit: garbage page 0 on the free list")
        for p in range(1, self.n_pages):
            if self.refs[p] < 0:
                raise RuntimeError(f"audit: page {p} refcount "
                                   f"{self.refs[p]} < 0")
            if (self.refs[p] == 0) != (p in free):
                raise RuntimeError(
                    f"audit: page {p} refcount {self.refs[p]} vs free-list "
                    f"membership {p in free} disagree")
            if holds is not None and self.refs[p] != holds.get(p, 0):
                raise RuntimeError(
                    f"audit: page {p} refcount {self.refs[p]} != "
                    f"{holds.get(p, 0)} holders claimed")
        return {"n_pages": self.n_pages, "n_free": len(free),
                "n_owned": self.n_pages - 1 - len(free)}
