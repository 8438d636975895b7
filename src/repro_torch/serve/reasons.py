"""The one table of machine-readable failure-reason strings.

A copy of the JAX package's ``serve/reasons.py``, kept string for string:
``ShedError.reason``, ``Request.fail_reason`` and, in later slices, the
gateway's HTTP mapping all draw from the constants here, so a reason string
cannot drift between layers or between the two packages.

Two shapes of reason appear: bare reasons (``queue-full``, ``page-budget``,
...) from admission control, and prefixed reasons (``injected:<site>``,
``pool-lost:<exc>``, ...) from fault containment, where the suffix carries
the forensic detail; ``base_reason`` strips the detail.
"""
from __future__ import annotations

from typing import Optional, Tuple

# -- bare reasons (admission control + deadline sweeps) ----------------------
QUEUE_FULL = "queue-full"        # bounded submit queue at max_pending
TENANT_QUOTA = "tenant-quota"    # tenant over its worst-case page/lane quota
PAGE_BUDGET = "page-budget"      # page budget can never fit this pool
DEADLINE = "deadline"            # unmeetable at admission OR passed mid-flight
HOST_BUDGET = "host-budget"      # both memory tiers (HBM pool + host swap
                                 # slots) committed to earlier requests

# -- prefixed reasons (fault containment; detail after the colon) ------------
INJECTED = "injected"            # injected:<site> — deterministic fault drill
POOL_LOST = "pool-lost"          # pool-lost:<exc> — dispatch died post-donation
BAD_LOGITS = "bad-logits"        # non-finite prefill logits under audit
OOM = "oom"                      # oom:<where> — simulated RESOURCE_EXHAUSTED
                                 # at dispatch; the victim FAILs, co-residents
                                 # keep decoding bit-identically
SHARD_LOST = "shard-lost"        # shard-lost:<shard> — a mesh device dropped
                                 # mid-segment; every affected lane fail-fast
                                 # drains (TP shards heads, so one lane spans
                                 # all shards — all lanes are affected)
WATCHDOG = "watchdog"            # the gateway step driver stalled/crashed;
                                 # live SSE streams end with this typed error
                                 # instead of hanging

#: every reason the serving stack can emit, bare or as a prefix.
ALL_REASONS = frozenset({QUEUE_FULL, TENANT_QUOTA, PAGE_BUDGET, DEADLINE,
                         HOST_BUDGET, INJECTED, POOL_LOST, BAD_LOGITS,
                         OOM, SHARD_LOST, WATCHDOG})

#: reasons ``ShedError`` may carry (admission-time rejections only).
SHED_REASONS = frozenset({QUEUE_FULL, TENANT_QUOTA, PAGE_BUDGET, DEADLINE,
                          HOST_BUDGET})


def base_reason(reason: Optional[str]) -> Optional[str]:
    """Strip the forensic detail: ``injected:page_alloc`` → ``injected``.
    Bare reasons pass through; None stays None (normal lifecycle)."""
    if reason is None:
        return None
    return reason.split(":", 1)[0]


def format_reason(base: str, detail: str) -> str:
    """Compose a prefixed reason — the inverse of ``base_reason``."""
    return f"{base}:{detail}"


# -- HTTP mapping (the gateway's admission-rejection contract) ---------------
#: reason → (status code, Retry-After seconds or None). Only SHED_REASONS
#: appear here: anything later than admission is an SSE error event, not a
#: status code (the headers are long gone by then).
HTTP_STATUS: dict = {
    QUEUE_FULL: (429, 1),
    TENANT_QUOTA: (429, 1),
    PAGE_BUDGET: (503, None),
    DEADLINE: (429, 1),
    HOST_BUDGET: (429, 1),
}


def http_for_reason(reason: str) -> Tuple[int, Optional[int]]:
    """(status, retry_after_seconds) for an admission-time rejection.
    Unknown reasons map to a plain 503 — fail safe, never crash the
    gateway over a new reason string the table hasn't learned yet."""
    return HTTP_STATUS.get(base_reason(reason), (503, None))


#: ceiling for the live Retry-After hint — past this the client should be
#: backing off on its own schedule, not ours.
RETRY_AFTER_CAP = 30

#: reasons whose Retry-After scales with live queue depth: both drain as
#: requests finish, so the honest hint is "how long until my turn", not a
#: constant. tenant-quota and deadline stay at the table floor — their
#: clearing time depends on the CLIENT's own traffic, not the queue.
_DEPTH_SCALED = frozenset({QUEUE_FULL, HOST_BUDGET})


def retry_after_seconds(reason: str, stats: Optional[dict] = None,
                        floor: Optional[int] = None) -> Optional[int]:
    """Live ``Retry-After`` hint for a shed, derived from a
    ``ServeSession.stats()`` snapshot: queue depth (pending + active) in
    units of lane-batches approximates how many admission rounds must
    drain before the retry can land. Falls back to the static table value
    when no snapshot is given, the reason isn't depth-scaled, or the
    snapshot is malformed; returns None exactly when the table says no
    Retry-After (``page-budget`` — retrying verbatim is futile)."""
    table = http_for_reason(reason)[1]
    if floor is None:
        floor = table
    if floor is None:
        return None
    if stats is None or base_reason(reason) not in _DEPTH_SCALED:
        return floor
    try:
        lanes = max(int(stats.get("lanes", 1)), 1)
        depth = int(stats.get("pending", 0)) + int(stats.get("active", 0))
    except (TypeError, ValueError):
        return floor
    return max(floor, min(RETRY_AFTER_CAP, -(-depth // lanes)))
