"""Named ranges at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs, and one shared no-op context otherwise: a range costs
microseconds even with no profiler listening, the check ~0.2 µs. The
names and what each covers are listed in PERF.md §3; the benchmark's
trace reader (``bench/spans.py``) attributes each kernel to the
innermost range whose host interval holds its launch.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler is on
    (also on the autograd engine's threads, which inherit its state),
    else a shared ``nullcontext``."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
