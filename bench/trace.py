"""The traced sub-window of a ``--trace 1`` run: ``torch.profiler`` over
the card's kernels and the harness's own spans (``record_function``
annotations named ``bench.<span>``), read once when it stops.

``busy_s`` is the union of the kernels' intervals, ``window_s`` the
sub-window's length on the host clock; the breakdown gives the kernels
that took most device time and the longest idle gaps, each named by the
harness span the host was in when the card went idle."""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple


def start(record_shapes: bool = False):
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=record_shapes)
    prof.__enter__()
    return prof


def stop(prof, t0: float, t1: float) -> "Trace":
    import torch
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    return Trace(prof, t0, t1)


def _annotation(e) -> bool:
    """A ``record_function`` range mirrored on the device's timeline
    (kineto's gpu_user_annotation): a span, not a kernel."""
    if e.name().startswith("bench."):
        return True
    try:
        return bool(e.is_user_annotation())
    except AttributeError:
        return False


class Trace:
    def __init__(self, prof, t0: float, t1: float):
        self.prof = prof
        self.t0, self.t1 = t0, t1
        self.kernels: List[Tuple[str, int, int]] = []   # name, start, end ns
        self.spans: List[Tuple[str, int, int]] = []
        for e in prof.profiler.kineto_results.events():
            dt = str(e.device_type())
            if dt.endswith("CUDA") and not _annotation(e):
                self.kernels.append((e.name(), e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
            elif not dt.endswith("CUDA") and e.name().startswith("bench."):
                self.spans.append((e.name()[6:], e.start_ns(),
                                   e.start_ns() + e.duration_ns()))
        self.kernels.sort(key=lambda k: k[1])
        self.spans.sort(key=lambda s: s[1])
        self._busy = self._union()

    def _union(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, a, b in self.kernels:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) / 1e9

    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernel_s(self, patterns) -> Optional[float]:
        """Device seconds of the kernels whose name matches one of the
        regular expressions ``patterns``; None if none ran."""
        rx = [re.compile(p) for p in patterns]
        ts = [b - a for n, a, b in self.kernels if any(r.search(n) for r in rx)]
        return sum(ts) / 1e9 if ts else None

    def top_kernels(self, n: int = 10) -> List[Tuple[str, float]]:
        tot: Dict[str, int] = {}
        for name, a, b in self.kernels:
            tot[name] = tot.get(name, 0) + (b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        gaps = []
        for (a0, b0), (a1, _) in zip(self._busy, self._busy[1:]):
            if a1 > b0:
                gaps.append((b0, a1))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for a, b in gaps[:n]:
            label = "outside any span"
            for name, s0, s1 in self.spans:
                if s0 <= a <= s1:
                    label = name        # the innermost span that holds it
            out.append([label, (b - a) / 1e9])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.top_kernels(), "idle_gaps": self.idle_gaps()}

    def op_kernels_reading(self, tail: Tuple[int, ...]) -> Optional[float]:
        """Device seconds of the kernels launched by an aten op that reads
        a tensor whose last dims are ``tail`` (needs record_shapes): the
        grouping phase 18 of ``chip_smoke.py`` uses for the scan."""
        def reads(shapes):
            for s in shapes or ():
                if s and isinstance(s[0], (list, tuple)):
                    if reads(s):
                        return True
                elif len(s) >= len(tail) and tuple(s[-len(tail):]) == tail:
                    return True
            return False

        total, seen = 0.0, False
        for e in self.prof.events():
            if str(e.device_type) != "DeviceType.CPU" or not e.kernels:
                continue
            if not reads(e.input_shapes):
                continue
            for k in e.kernels:
                total += k.duration / 1e6
                seen = True
        return total if seen else None
