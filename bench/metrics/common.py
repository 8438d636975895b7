"""Shared arithmetic of the metric readers."""
from __future__ import annotations

import statistics
from typing import Iterable, List, Optional

from bench.yardstick.peaks import bound_s
from bench.yardstick.work import Sizes

GEMV = (r"(^|\W)xnor_gemv_(tc_kernel|split|reduce)(\W|$)",)
PAGED_DECODE = (r"(^|\W)(decode_tc|paged_decode_split|paged_decode_combine)"
                r"(\W|$)",)
FLASH = (r"(^|\W)flash_(tc|fwd)(\W|$)",)
WEIGHT_BWD = (r"weight_bwd",)


def sizes(run) -> Sizes:
    return Sizes.of(run.model)


def window_steps(run, traced: bool = False) -> List[dict]:
    """The ``session.step`` / ``train.step`` spans inside the window (or
    inside the traced sub-window)."""
    keep = run.in_trace if traced else run.in_window
    return [s for s in run.spans
            if s["name"] in ("session.step", "train.step") and keep(s)]


def window_len(run) -> Optional[float]:
    if run.window is None or run.window[1] is None:
        return None
    return run.window[1] - run.window[0]


def steps_len(run) -> Optional[float]:
    """Seconds the window spent inside its steps: the window's length
    less what the harness did between steps (in a traced run, stopping
    and reading the profiler)."""
    t = sum(s["t1"] - s["t0"] for s in window_steps(run))
    return t or None


def share(work_s: float, time_s: Optional[float]) -> Optional[float]:
    """A share of a bound in %, None where nothing was timed."""
    if not time_s or work_s <= 0:
        return None
    return 100.0 * work_s / time_s


def median(xs: Iterable[float]) -> Optional[float]:
    xs = list(xs)
    return statistics.median(xs) if xs else None


def idle_share(run) -> Optional[float]:
    t = run.traced
    if t is None or t.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())


def bound(work) -> float:
    nbytes, flops = work
    return bound_s(nbytes, flops, "bf16")
