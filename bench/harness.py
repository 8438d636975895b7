"""One run of one cell: find its files by name, set up, measure the
window, read the metrics, decide ``correct`` and print the result line.

The result line is the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``: each number compared with its
limit. The same checks close standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str):
    """(workload entry of BENCHMARK.json, cell file, configuration file)."""
    spec = benchmark()
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(BENCH / "cells" / f"{name}.json")
    config = load_json(BENCH / "configs" / f"{entry['config']}.json")
    return entry, cell, config


def metrics_of(name: str, trace: bool) -> List[dict]:
    """The metrics a run of cell ``name`` reports: the end-to-end ones, or
    with ``trace`` the per-layer ones, that list the cell (or list no
    cells)."""
    spec = benchmark()
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is that of JAX or of the JAX
    package (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    the port's nvcc libraries already live in ``build/``."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ.setdefault("USE_FLAX", "0")


class Run:
    """What one run measured: the cell, host spans, the window, the
    traced sub-window's kernels, the checks."""

    def __init__(self, name: str, entry: dict, cell: dict, config: dict,
                 seed: int, seconds: float, trace: bool, device: str):
        self.name, self.entry, self.cell, self.config = name, entry, cell, \
            config
        self.model = config["model"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), \
            bool(trace)
        self.device = device
        self.t_start = time.perf_counter()
        self.spans: List[dict] = []
        self.window = None              # (t0, t1) host seconds
        self.setup_s = None
        self.attempted = self.failed = 0
        self.checks: Dict[str, dict] = {}    # name -> {"value", "limit"}
        self.notes: List[str] = []           # printed before the checks
        self.correct = None
        self.memory_peak = None
        self.traced = None              # bench.trace.Trace of the sub-window
        self.shape_traced = None        # one step traced with shapes
        self._prof = None
        self.trace_seconds = float(cell.get("trace_seconds", seconds))

    # ---- spans -------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **info):
        rec = {"name": name, "t0": time.perf_counter(), "info": info}
        ctx = contextlib.nullcontext()
        if self._prof is not None:
            from torch.profiler import record_function
            ctx = record_function("bench." + name)
        with ctx:
            try:
                yield rec
            finally:
                rec["t1"] = time.perf_counter()
                self.spans.append(rec)

    def in_window(self, rec) -> bool:
        return self.window is not None and rec["t0"] >= self.window[0] \
            and rec["t1"] <= self.window[1]

    def in_trace(self, rec) -> bool:
        return self.traced is not None and rec["t0"] >= self.traced.t0 \
            and rec["t1"] <= self.traced.t1

    # ---- the traced sub-window ---------------------------------------------
    def warm_profiler(self) -> None:
        """With ``--trace 1``, start and stop the profiler once during
        set-up: its first start in a process initialises CUPTI, seconds
        that would otherwise fall inside the traced sub-window."""
        if self.trace and self.device == "cuda":
            from bench.trace import start
            import torch
            prof = start(False)
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)

    def window_open(self) -> float:
        """Start the window (and, with ``--trace 1``, the profiler)."""
        if self.trace and self.device == "cuda":
            from bench.trace import start
            self._prof = start(False)
        t0 = time.perf_counter()
        self.window = (t0, None)
        if self._prof is not None:
            self._prof_t0 = t0
        return t0

    def tick(self) -> None:
        """At a step boundary: stop the profiler once the traced
        sub-window has run its length."""
        if self._prof is not None and \
                time.perf_counter() - self._prof_t0 >= self.trace_seconds:
            self._stop_trace()

    def _stop_trace(self) -> None:
        from bench.trace import stop
        t1 = time.perf_counter()
        self.traced = stop(self._prof, self._prof_t0, t1)
        self._prof = None

    def window_close(self, t1: float) -> None:
        if self._prof is not None:
            self._stop_trace()
        self.window = (self.window[0], t1)

    def shape_probe(self, step) -> None:
        """With ``--trace 1`` and a cell that sets ``trace_shapes``: once
        the window has closed, trace one more ``step()`` with the aten
        ops' input shapes (for readers that group kernels by operand
        shape). Recording shapes costs the host far more than the step's
        own dispatch, so this step lies outside the window and the traced
        sub-window, whose idle share and rates it would skew."""
        if not (self.trace and self.device == "cuda"
                and self.cell.get("trace_shapes", False)):
            return
        from bench.trace import start, stop
        prof = start(True)
        t0 = time.perf_counter()
        step()
        self.shape_traced = stop(prof, t0, time.perf_counter())

    def check(self, name: str, value: float, limit: float) -> bool:
        ok = value is not None and math.isfinite(value) and value <= limit
        self.checks[name] = {"value": value, "limit": limit}
        return ok


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_or_exit(chips: int) -> str:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        raise SystemExit(3)
    return "cuda"


def execute(run: Run) -> dict:
    """Set up, measure, check; returns the result object."""
    system = importlib.import_module(f"bench.systems.{run.cell['system']}")
    system.run(run)
    names = metrics_of(run.name, run.trace)
    metrics = {}
    for m in names:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device == "cuda" else run.device,
              "kind": _device_kind(run.device),
              "count": int(run.entry["chips"]),
              "memory_peak_bytes": run.memory_peak}
    out = {"correct": bool(run.correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.traced is not None:
        device["busy_s"] = run.traced.busy_s()
        device["window_s"] = run.traced.window_s()
        out["breakdown"] = run.traced.breakdown()
    out["checks"] = run.checks
    return _finite(out)


def _finite(x):
    """The result with every non-finite number as null (JSON has none)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _device_kind(device: str) -> str:
    import torch
    if device == "cuda":
        return torch.cuda.get_device_name(0)
    return device


def local_run(name: str, cell: dict, config: dict, seed: int,
              seconds: float, trace: bool = False, device: str = "cpu"):
    """A run of cell ``name`` with the given cell and configuration
    dicts (small ones in the CPU tests): the harness without its look for
    a card. -> (Run, result object)."""
    entry = next(w for w in benchmark()["workloads"] if w["name"] == name)
    run = Run(name, entry, cell, config, seed, seconds, trace, device)
    return run, execute(run)


def main(argv=None, t0: float = None) -> int:
    """``t0``: the host clock at the process's start (``run.py``), from
    which ``setup_s`` runs."""
    args = parse(argv)
    entry, cell, config = cell_files(args.workload)
    cache_env(ROOT)
    device = card_or_exit(int(entry["chips"]))
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    run = Run(args.workload, entry, cell, config, args.seed, args.seconds,
              bool(args.trace), device)
    if t0 is not None:
        run.t_start = t0
    out = execute(run)
    bad = forbidden_modules()
    if bad:
        print(f"loaded the JAX stack or the JAX package: {bad}",
              file=sys.stderr)
        return 4
    sums: Dict[str, float] = {}
    for sp in run.spans:
        if not sp["name"].startswith("session.step"):
            sums[sp["name"]] = sums.get(sp["name"], 0.0) + sp["t1"] - sp["t0"]
    print("spans (s): " + ", ".join(f"{k} {v:.2f}" for k, v in sums.items()),
          file=sys.stderr)
    for note in run.notes:
        print(note, file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0
