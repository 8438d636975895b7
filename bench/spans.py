"""The port's own ranges in the traced sub-window of a ``--trace 1`` run.

The port opens a ``record_function`` range at each layer boundary while
a profiler runs (``repro_torch.spans``; the names are PERF.md §3's); the
harness's own are named ``bench.<span>``. Both are read here from the
same ``torch.profiler`` trace as ``bench.trace.Trace``, on the trace's
own clock (host nanoseconds; kineto puts the device's timestamps on it).

A kernel is **attributed** to the innermost range whose host interval
holds its launch: the runtime call that launched it, joined to the
kernel by the profiler's correlation id (or, where that call is missing,
the aten op that launched it). Ranges of every thread count: the
backward's kernels launch from the autograd engine's thread while
``train.backward`` stays open on the caller's. Of ranges that hold a
launch, the one that opened last is the innermost.

The selective scan's backward is found by sequence number: each aten op
under a ``mamba.scan`` range records its autograd node's sequence
number and thread, and the autograd engine's ``evaluate_function``
events of the same (number, forward thread) are the scan's backward
functions. They join the ranges as ``mamba.scan.backward``, so a
recompute of the scan inside one of them (the remat's) stays
``mamba.scan``.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

HARNESS = "bench."
SCAN = "mamba.scan"
SCAN_BACKWARD = "mamba.scan.backward"
BACKWARD = "autograd::engine::evaluate_function: "

Range = Tuple[str, int, int]            # name, host start ns, host end ns
Kernel = Tuple[int, int, int]           # device start ns, end ns, launch ns


class Spans:
    """Ranges and kernels of one trace, each kernel attributed once."""

    def __init__(self, ranges: Iterable[Range], kernels: Iterable[Kernel]):
        self.ranges: List[Range] = sorted(ranges, key=lambda r: (r[1], -r[2]))
        self.kernels: List[Kernel] = sorted(kernels, key=lambda k: k[2])
        self.owner: List[Optional[str]] = self._attribute()
        self._busy = _union((a, b) for a, b, _ in self.kernels)

    @classmethod
    def of_events(cls, events) -> "Spans":
        """From ``prof.profiler.kineto_results.events()``."""
        ranges, kernels, launches, op_start = [], [], {}, {}
        ops, functions = [], []             # for the scan's backward
        for e in events:
            on_card = str(e.device_type()).endswith("CUDA")
            if e.is_user_annotation():
                if not on_card:
                    ranges.append((e.name(), e.start_ns(), e.end_ns(),
                                   e.start_thread_id()))
            elif on_card:
                kernels.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                                e.linked_correlation_id()))
            elif e.linked_correlation_id() > 0:         # a runtime call
                launches[e.correlation_id()] = e.start_ns()
            else:                                       # an aten op
                op_start[e.correlation_id()] = e.start_ns()
                if e.name().startswith(BACKWARD):
                    functions.append((e.sequence_nr(), e.fwd_thread_id(),
                                      e.start_ns(), e.end_ns()))
                elif e.sequence_nr() >= 0:
                    ops.append((e.sequence_nr(), e.start_thread_id(),
                                e.start_ns()))
        scans = [(t, a, b) for n, a, b, t in ranges if n == SCAN]
        out = [(n, a, b) for n, a, b, _ in ranges]
        out += [(SCAN_BACKWARD, a, b)
                for a, b in scan_backward(scans, ops, functions)]
        ks = []
        for a, b, corr, linked in kernels:
            at = launches.get(corr, op_start.get(linked))
            if at is not None:
                ks.append((a, b, at))
        return cls(out, ks)

    # ---- attribution -------------------------------------------------------
    def _attribute(self) -> List[Optional[str]]:
        owner, open_, i = [], [], 0
        for _, _, t in self.kernels:
            while i < len(self.ranges) and self.ranges[i][1] <= t:
                open_.append(self.ranges[i])
                i += 1
            open_ = [r for r in open_ if r[2] >= t]
            owner.append(open_[-1][0] if open_ else None)
        return owner

    def innermost(self, t: int) -> Optional[str]:
        """The name of the innermost range that holds host time ``t``."""
        best = None
        for r in self.ranges:
            if r[1] > t:
                break
            if r[2] >= t:
                best = r
        return best[0] if best else None

    # ---- what the metrics read ---------------------------------------------
    def named(self, name: str) -> List[Range]:
        return [r for r in self.ranges if r[0] == name]

    def count(self, name: str) -> int:
        return len(self.named(name))

    def wall_s(self, name: str) -> float:
        return sum(b - a for _, a, b in self.named(name)) / 1e9

    def device_s(self, name: str) -> float:
        """Device seconds of the kernels attributed to ``name``."""
        return sum(b - a for (a, b, _), o in zip(self.kernels, self.owner)
                   if o == name) / 1e9

    def idle_s(self, name: str) -> float:
        """Seconds of the ``name`` ranges' wall in which no kernel ran."""
        idle = 0
        for _, a, b in self.named(name):
            idle += (b - a) - _overlap(self._busy, a, b)
        return idle / 1e9

    def holding(self, outer: str, inner: str) -> int:
        """How many ``outer`` ranges hold an ``inner`` range."""
        inner_r = self.named(inner)
        return sum(1 for _, a, b in self.named(outer)
                   if any(a <= x0 and x1 <= b for _, x0, x1 in inner_r))

    def steps(self, harness_span: str) -> int:
        """The harness's ``bench.<harness_span>`` ranges in the trace."""
        return self.count(HARNESS + harness_span)

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest gaps between kernels, each named by the
        innermost range, the port's or the harness's, that holds its
        start (the host's doing when the card went idle)."""
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(self._busy,
                                                      self._busy[1:])]
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        return [[self.innermost(a) or "outside any span", (b - a) / 1e9]
                for a, b in gaps[:n]]

    def notes(self) -> List[str]:
        """Lines for standard error: the idle gaps by the port's spans,
        the device seconds by innermost span, each span's count, wall
        and idle seconds, and how much of the harness's steps the port's
        top spans cover."""
        by: Dict[str, float] = {}
        for (a, b, _), o in zip(self.kernels, self.owner):
            by[o or "outside any span"] = by.get(o or "outside any span",
                                                 0.0) + (b - a) / 1e9
        top = sorted(by.items(), key=lambda kv: -kv[1])[:12]
        lines = ["idle gaps by span (s): " + ", ".join(
            f"{name} {s:.6f}" for name, s in self.idle_gaps()),
            "device s by innermost span: " + ", ".join(
                f"{name} {s:.4f}" for name, s in top)]
        counts: Dict[str, int] = {}
        for name, _, _ in self.ranges:
            counts[name] = counts.get(name, 0) + 1
        lines.append("ranges: " + ", ".join(
            f"{k} {v}" for k, v in sorted(counts.items())))
        lines.append("wall / idle s by span: " + ", ".join(
            f"{k} {self.wall_s(k):.4f} / {self.idle_s(k):.4f}"
            for k in sorted(counts)))
        step = self.wall_s(HARNESS + "session.step")
        if step:
            cover = sum(self.wall_s(k) for k in
                        ("serve.admit", "serve.segment", "serve.drain"))
            lines.append(f"session.step covered by serve.admit, "
                         f"serve.segment, serve.drain: "
                         f"{100 * cover / step:.2f}% of {step:.4f} s")
        return lines


def scan_backward(scans, ops, functions) -> List[Tuple[int, int]]:
    """The host intervals of the scan's backward functions.

    ``scans``: (thread, start, end) of each ``mamba.scan`` range;
    ``ops``: (sequence number, thread, start) of each aten op that
    recorded one; ``functions``: (sequence number, forward thread,
    start, end) of each ``evaluate_function`` event."""
    by_thread: Dict[int, List[Tuple[int, int]]] = {}
    for tid, a, b in scans:
        by_thread.setdefault(tid, []).append((a, b))
    starts = {}
    for tid, rs in by_thread.items():
        rs.sort()
        starts[tid] = [a for a, _ in rs]
    keys = set()
    for seq, tid, t in ops:
        rs = by_thread.get(tid)
        if not rs:
            continue
        i = bisect.bisect_right(starts[tid], t) - 1
        if i >= 0 and rs[i][1] >= t:
            keys.add((seq, tid))
    return [(a, b) for seq, fwd, a, b in functions if (seq, fwd) in keys]


def _union(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(busy: List[Tuple[int, int]], a: int, b: int) -> int:
    """Nanoseconds of [a, b] that the sorted, disjoint ``busy`` covers."""
    i = max(bisect.bisect_right(busy, (a, a)) - 1, 0)
    tot = 0
    while i < len(busy) and busy[i][0] < b:
        lo, hi = max(busy[i][0], a), min(busy[i][1], b)
        if hi > lo:
            tot += hi - lo
        i += 1
    return tot


def of(run) -> Optional[Spans]:
    """The run's ``Spans``, read from its traced sub-window once; None
    without one. The first reader to ask also queues the spans' notes
    for standard error (``run.notes``): a metric reader is the only code
    of this module the harness calls after the traced window."""
    if run.traced is None:
        return None
    sp = getattr(run, "port_spans", None)
    if sp is None:
        sp = Spans.of_events(run.traced.prof.profiler.kineto_results.events())
        run.port_spans = sp
        run.notes.extend(sp.notes())
    return sp
