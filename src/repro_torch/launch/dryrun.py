"""Dry run: trace one rank's step of every (architecture × input shape ×
mesh) cell on a fake world of 256 or 512 ranks, and record its memory,
collectives and roofline (the JAX package's ``launch/dryrun.py``).

The JAX package lowers and compiles each cell on placeholder devices and
reads XLA's memory and cost analyses and the collectives of its HLO. The
port runs eagerly, so it traces instead: ``launch.mesh.fake_world`` starts
torch's ``"fake"`` process-group backend at rank 0 of the production
world, the parameters, optimizer state, cache and inputs are
``FakeTensorMode`` tensors (shapes and dtypes, no storage; on ``meta``,
which the kernel wrappers and ``matmul_f32`` take for the card) at this
rank's placement, and the step runs once under
``hlo_analysis.CollectiveRecord`` (every collective it dispatches) and
torch's ``MemTracker`` (the peak bytes of the rank's live tensors, by
kind). The kernel wrappers take their traced branch on fake tensors: they
allocate what their launch allocates, build and launch nothing, and count
``fake_launches``. The roofline's FLOPs and bytes are
``flops_model.analytic_cell_cost``'s, on the ``hlo_analysis.H100_SXM``
datasheet record: a prediction, not a reading. In every cell its compute
and memory terms and its collective term (the trace's record) share one
placement, the JAX package's, but for the port's two stated differences
(``STATED_DIFFERENCES``); ``roofline_placement`` says so in each record.

Placement: the JAX package's (``launch/shardings.py::train_param_specs``),
in every cell: FSDP of every large weight over "data", the "model" split
of the heads, d_ff, d_inner, the experts and the vocab; the two stated
differences are k/v replicated over "model" where the KV heads do not
divide it, and ``wo`` replicated over "model". Training: the batch over
"pod"/"data", a layer group's slices gathered per microbatch, the grads
reduce-scattered. Prefill and decode (no grad, no optimizer state): the
batch over "pod"/"data" (long_500k: over no axis), each layer group's
slices gathered once, the cache the JAX package's ``cache_init`` specs
(``cache_specs``: the rows over "model", long_500k's over every axis;
every KV head; the SSM state's d_inner over "model"), the logits gathered
whole over the vocab. Each record states its placement.

The ssm and hybrid train cells trace a scan of ~72 s of CPU a layer: they
are traced at two depths, each at one and two microbatches
(``DEPTH_CUT``, ``--depths``), and the record's peak, collectives and launches are
extrapolated (``trace_cut``), the record saying what it traced
(``depth_cut``).

Usage (CPU only; writes ``results/dryrun_torch/`` unless ``--out``):
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape decode_32k --mesh single                              # one cell
  ... --variant '{"moe_impl": "scatter"}' --tag scatter
  ... --calibrate      # analytic FLOPs against FlopCounterMode, loop-free
  ... --depths 1,2     # train: traced at 1 and 2 layers, each at 1 and 2
                       # microbatches, extrapolated

The fake world belongs to the process: run one sweep a process.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.optimizer import (hybrid_optimizer, tree_leaves,
                                        tree_map)
from repro_torch.distributed.placement import named, place
from repro_torch.kernels import KERNELS
from repro_torch.models import cache_init, lm_init

from .flops_model import analytic_cell_cost
from .hlo_analysis import (CollectiveRecord, active_params,
                           collective_breakdown, collective_bytes,
                           model_flops, roofline_terms, total_params)
from .mesh import PRODUCTION, fake_world
from .shapes import SHAPES, ShapeDef, applicable, input_specs
from .shardings import (apply_policy, kv_replicated, train_microbatches,
                        train_param_specs)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: run options of ``--variant`` (keys with a leading underscore)
_RUN_OPTS = ("_grad_accum_bf16",)


def _fake_launches() -> dict:
    return {k.__name__: k.fake_launches for k in KERNELS}


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


#: the train cells traced at a depth cut and extrapolated per layer: the
#: two depths traced
DEPTH_CUT = {"falcon-mamba-7b": (1, 2), "jamba-1.5-large-398b": (8, 16)}

#: the two microbatch counts each depth of a cut is traced at
CUT_MICROS = (1, 2)

#: the port's two differences from the JAX package's training specs
STATED_DIFFERENCES = (
    "1: wk/wv split over 'model' when the KV heads divide it, replicated "
    "otherwise (the JAX package: split at 16 or more KV heads)",
    "2: wo FSDP over 'data' but replicated over 'model' (the JAX package "
    "splits its rows): the heads are gathered before it")


def _placement(cfg, shape: ShapeDef, mesh) -> dict:
    tp = mesh.shape.get("model", 1)
    kv = "replicated" if kv_replicated(cfg, tp) else "columns"
    out = {"batch": list(cfg.batch_axes),
           "weights": ("the JAX package's lm_init specs: FSDP of every "
                       "large weight over 'data', the 'model' split of the "
                       "heads, d_ff, d_inner, the experts and the vocab"),
           "heads": f"'model': q columns, k/v {kv}" if tp > 1
           else "unsharded",
           "stated_differences": list(STATED_DIFFERENCES),
           "cache_seq": list(cfg.cache_seq_axes)
           if shape.kind != "train" else []}
    if shape.kind != "train":
        out["cache"] = ("the JAX package's cache_init specs: the rows over "
                        f"{list(cfg.cache_seq_axes)}, every KV head; the "
                        "SSM state's d_inner over 'model'")
        out["logits"] = "gathered over 'model': whole over the vocab"
    if shape.kind == "prefill":
        out["cache_rows"] = ("k/v replicated: each rank keeps its slab's "
                             "rows, no collective" if kv == "replicated"
                             else "k/v split: one all-to-all over 'model' "
                             "a layer trades heads for rows")
    return out


def _track(mt, tree, kind) -> None:
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            mt._update_and_maybe_create_winfos(t, kind)


def _inputs(cfg, shape: ShapeDef, mesh, fake_mode, variant_opts, mb,
            dev=None):
    """The cell's step and its arguments as fake tensors on ``dev`` (the
    mesh's device by default) at this rank's placement -> (step, args,
    {"param", "opt" / "cache"} trees to tag)."""
    from repro_torch.train import (make_decode_step, make_prefill_step,
                                   make_train_step)

    dev = mesh.device if dev is None else dev
    tp = mesh.shape.get("model", 1)
    dp = mesh.size_of(cfg.batch_axes)        # the policy's batch axes
    with fake_mode:
        params = _to(lm_init(cfg, torch.Generator().manual_seed(0)), dev)
        ins = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
               for k, v in input_specs(cfg, shape).items()}
        # every cell's params take the training placement (a serving
        # step's without optimizer state)
        shardings = None
        if mesh.size > 1:
            shardings = named(mesh, train_param_specs(
                params, replicate_kv=kv_replicated(cfg, tp)))
            params = place(params, shardings)
        if shape.kind == "train":
            opt = hybrid_optimizer(eta=8.0, fp_lr=1e-3)
            opt_state = opt.init(params)
            gdtype = (torch.bfloat16 if variant_opts.get("_grad_accum_bf16")
                      else torch.float32)
            step = make_train_step(cfg, opt, microbatches=mb,
                                   grad_accum_dtype=gdtype,
                                   grad_shardings=shardings)
            return step, (params, opt_state, ins), {"param": params,
                                                    "opt": opt_state}
        if shape.global_batch % dp:
            raise ValueError(f"a batch of {shape.global_batch} does not "
                             f"split over {dp} batch shards")
        b = shape.global_batch // dp
        ins = {k: v[:b] for k, v in ins.items()}
        if shape.kind == "prefill":
            return (make_prefill_step(cfg, shardings), (params, ins),
                    {"param": params})
        n = mesh.size_of(cfg.cache_seq_axes) if cfg.cache_seq_axes else 1
        if shape.seq_len % n:
            raise ValueError(f"{shape.seq_len} cache rows do not split over "
                             f"{n} ranks")
        # this rank's slice under cache_specs: its rows and slab, its
        # d_inner channels of the SSM state
        cache = cache_init(cfg, b, shape.seq_len // n, dev)
        cache["pos"] = shape.seq_len - 1     # a full context
        return (make_decode_step(cfg, shardings), (params, cache, ins),
                {"param": params, "cache": cache})


def trace_cell(arch: str, shape, layout, variant: dict = None,
               trace: bool = True, microbatches: int = None) -> dict:
    """Trace one cell on a fake world -> its record. ``shape``: a name of
    ``SHAPES`` or a ``ShapeDef``; ``layout``: the mesh's (shape, axes);
    ``microbatches``: train's grad-accumulation factor (default
    ``train_microbatches``). ``trace=False`` stops after building the
    inputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker, _MemRefType

    t0 = time.time()
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mshape, axes = layout
    cfg0 = get_config(arch)
    rec = {"arch": arch, "shape": shape.name,
           "mesh": "x".join(map(str, mshape)), "n_chips": math.prod(mshape),
           "variant": variant or {}}
    if not applicable(cfg0, shape):
        rec["skipped"] = ("long_500k needs sub-quadratic attention; "
                          f"{arch} is full-attention")
        return rec
    opts = {k: v for k, v in (variant or {}).items() if k.startswith("_")}
    unknown = set(opts) - set(_RUN_OPTS)
    if unknown:
        raise ValueError(f"unknown run options {sorted(unknown)}; the port "
                         f"has {list(_RUN_OPTS)}")
    mesh = fake_world(mshape, axes)
    try:
        cfg = apply_policy(cfg0, shape, mesh)
        over = {k: v for k, v in (variant or {}).items()
                if not k.startswith("_")}
        if over:
            cfg = cfg.scaled(**over)
        mb = 1
        if shape.kind == "train":
            mb = microbatches or train_microbatches(cfg, shape, mesh)
            rec["microbatches"] = mb
        rec["placement"] = _placement(cfg, shape, mesh)
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        step, args, tags = _inputs(cfg, shape, mesh, fake_mode, opts, mb)
        rec["build_s"] = round(time.time() - t0, 1)
        if not trace:
            return rec

        t1 = time.time()
        before = _fake_launches()
        coll = CollectiveRecord()
        mt = MemTracker()
        _track(mt, tags["param"], _MemRefType.PARAM)
        _track(mt, tags.get("opt"), _MemRefType.OPT)
        _track(mt, tags.get("cache"), _MemRefType.BUFFER)
        _track(mt, args[-1], _MemRefType.OTH)
        grad = torch.enable_grad() if shape.kind == "train" \
            else torch.no_grad()
        with fake_mode, coll, mt, grad:
            out = step(*args)
        del out
        rec["trace_s"] = round(time.time() - t1, 1)
        after = _fake_launches()
        rec["fake_launches"] = {k: after[k] - before[k] for k in after
                                if after[k] != before[k]}
        snap = mt.get_tracker_snapshot("peak").get(mesh.device, {})
        rec["peak_bytes_per_device"] = int(snap.get("Total", 0))
        rec["mem_by_kind"] = {str(getattr(k, "name", k)): int(v)
                              for k, v in snap.items() if k != "Total"}

        cb = collective_bytes(coll)
        rec["collectives"] = {k: int(v) for k, v in cb.items()}
        rec["collective_top"] = collective_breakdown(coll)
        rec["collective_sites"] = _sites(coll)
        rec["collective_ops"] = [
            {k: op[k] for k in ("kind", "dtype", "shape", "group", "site")}
            for op in coll.ops]
        ana = analytic_cell_cost(cfg, shape, mesh, microbatches=mb)
        rec["analytic"] = {k: float(v) for k, v in ana.items()}
        terms = roofline_terms(ana["flops_per_device"],
                               ana["bytes_per_device"], cb["total"],
                               mesh.size, ring_total=cb["ring_total"],
                               record=coll)
        rec["roofline"] = terms
        rec["roofline_placement"] = _roofline_placement(shape)
        mf = model_flops(cfg0, shape)
        rec["model_flops_total"] = mf
        per_dev_model = mf / mesh.size
        rec["model_flops_per_device"] = per_dev_model
        rec["useful_flops_ratio"] = (
            per_dev_model / terms["hlo_flops_per_device"]
            if terms["hlo_flops_per_device"] else 0.0)
        rec["total_params"] = total_params(cfg0)
        rec["active_params"] = active_params(cfg0)
        rec["total_s"] = round(time.time() - t0, 1)
        return rec
    finally:
        mesh.close()


class _Layout:
    """A mesh's axis names and sizes, which ``apply_policy``,
    ``train_microbatches`` and ``analytic_cell_cost`` read, without a
    world."""

    def __init__(self, layout):
        mshape, self.axis_names = layout
        self.shape = dict(zip(self.axis_names, mshape))


def trace_cut(arch: str, shape, layout, variant: dict = None,
              depths=(1, 2)) -> dict:
    """A train cell traced at a depth and microbatch cut, extrapolated to
    its published depth and microbatch count -> its record, with
    ``depth_cut`` saying what was traced. Each trace runs ``n_layers`` in
    ``depths`` and microbatches in ``CUT_MICROS`` at the cell's own rows a
    microbatch (the global batch cut alike), so a microbatch's work and
    activations are the cell's. A collective count, its bytes and seconds
    and a launch count are bilinear in (layers, microbatches) — per step,
    per layer (a stacked leaf's bytes), per microbatch, per layer and
    microbatch — so the four traces fix them; the peak and the bytes by
    kind are linear in the layers at the larger microbatch count (the
    grad accumulators exist from two microbatches on)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg0 = get_config(arch)
    lay = _Layout(layout)
    cfg = apply_policy(cfg0, shape, lay)
    over = {k: v for k, v in (variant or {}).items() if not k.startswith("_")}
    if over:
        cfg = cfg.scaled(**over)
    full_l = cfg.n_layers
    full_mb = train_microbatches(cfg, shape, lay)
    dp = 1
    for a in cfg.batch_axes:
        dp *= lay.shape[a]
    rows = shape.global_batch // (dp * full_mb)
    (l1, l2), (m1, m2) = depths, CUT_MICROS
    recs = {}
    for n in (l1, l2):
        for m in (m1, m2):
            cut = ShapeDef(shape.name, shape.seq_len, rows * dp * m,
                           shape.kind)
            recs[n, m] = trace_cell(arch, cut, layout,
                                    dict(variant or {}, n_layers=n),
                                    microbatches=m)

    def at(get):
        """``get`` of the records, extrapolated to (full_l, full_mb)."""
        def line(m):
            lo, hi = get(recs[l1, m]), get(recs[l2, m])
            return lo + (full_l - l1) * (hi - lo) / (l2 - l1)
        a, b = line(m1), line(m2)
        return a + (full_mb - m1) * (b - a) / (m2 - m1)

    def along_layers(get):
        lo, hi = get(recs[l1, m2]), get(recs[l2, m2])
        return lo + (full_l - l1) * (hi - lo) / (l2 - l1)

    last = recs[l2, m2]
    rec = {k: v for k, v in last.items() if k not in (
        "collective_ops", "collective_top", "trace_s", "build_s", "total_s")}
    rec["variant"] = variant or {}
    rec["microbatches"] = full_mb
    rec["peak_bytes_per_device"] = int(round(along_layers(
        lambda r: r["peak_bytes_per_device"])))
    rec["mem_by_kind"] = {k: int(round(along_layers(
        lambda r: r["mem_by_kind"].get(k, 0)))) for k in last["mem_by_kind"]}
    rec["collectives"] = {k: int(round(at(lambda r: r["collectives"][k])))
                          for k in last["collectives"]}
    rec["collective_sites"] = {k: int(round(at(
        lambda r: r["collective_sites"].get(k, 0))))
        for k in last["collective_sites"]}
    rec["fake_launches"] = {k: int(round(at(
        lambda r: r["fake_launches"].get(k, 0))))
        for k in last["fake_launches"]}
    mesh_s = {"collective_s": at(lambda r: r["roofline"]["collective_s"]),
              "collective_ring_s": at(
                  lambda r: r["roofline"].get("collective_ring_s", 0.0))}
    ana = analytic_cell_cost(cfg, shape, lay, microbatches=full_mb)
    rec["analytic"] = {k: float(v) for k, v in ana.items()}
    terms = roofline_terms(ana["flops_per_device"], ana["bytes_per_device"],
                           rec["collectives"]["total"], rec["n_chips"])
    terms.update(mesh_s)
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["step_time_lower_bound_s"] = total
    terms["roofline_fraction_of_compute"] = terms["compute_s"] / total
    rec["roofline"] = terms
    rec["model_flops_total"] = model_flops(cfg0, shape)
    per_dev = rec["model_flops_total"] / rec["n_chips"]
    rec["model_flops_per_device"] = per_dev
    rec["useful_flops_ratio"] = per_dev / terms["hlo_flops_per_device"]
    rec["trace_s"] = round(sum(r["trace_s"] for r in recs.values()), 1)
    rec["depth_cut"] = {
        "traced": [{"n_layers": n, "microbatches": m,
                    "global_batch": rows * dp * m,
                    "peak_bytes_per_device": r["peak_bytes_per_device"],
                    "trace_s": r["trace_s"]} for (n, m), r in recs.items()],
        "extrapolated_to": {"n_layers": full_l, "microbatches": full_mb,
                            "global_batch": shape.global_batch},
        "note": "the peak and bytes by kind extrapolated per layer, the "
                "collectives, call sites and launches per layer and "
                "microbatch, from the traces listed (not a trace of the "
                "whole cell)"}
    return rec


def _roofline_placement(shape: ShapeDef) -> dict:
    """Which placement each roofline term models: one, the JAX package's,
    but for the port's stated differences (the analytic terms count the
    JAX package's shares: k/v and ``wo`` split over "model")."""
    traced = {"train": "FSDP gathers and reduce-scatters over 'data', the "
                       "'model' sums",
              "prefill": "FSDP gathers over 'data', the 'model' sums, the "
                         "head gathers, the heads traded for cache rows "
                         "where k/v split, the vocab gather",
              "decode": "FSDP gathers over 'data', the 'model' sums, the "
                        "q (and split k/v) gathers, the slabs' softmax "
                        "combines, the vocab gather"}[shape.kind]
    return {"compute_s": "the JAX package's (analytic_cell_cost: FSDP, the "
                         "'model' splits)",
            "memory_s": "the JAX package's (analytic_cell_cost)",
            "collective_s": f"the same placement, traced (this trace's "
                            f"CollectiveRecord: {traced})",
            "shared": "one placement for the three terms, but for the "
                      "port's stated differences: "
                      + "; ".join(STATED_DIFFERENCES),
            "not_in_analytic": "the compute and memory terms count every "
                               "piece at its 1/chips share and the MoE "
                               "dispatch einsums' FLOPs; the trace runs k/v "
                               "(where replicated), wo and the MoE router "
                               "whole over 'model', in decode each data "
                               "rank's capacity slots of its experts, and "
                               "the dispatch by index"}


def _sites(coll) -> dict:
    """Collective count by (kind, call site)."""
    out: dict = {}
    for op in coll.ops:
        key = f"{op['kind']} {op['site']}"
        out[key] = out.get(key, 0) + 1
    return out


def run_and_save(arch, shape_name, multi_pod, variant=None, tag="baseline",
                 out_dir: Path = RESULTS_DIR, trace: bool = True,
                 depths=None) -> dict:
    """Trace one cell and write its record. A train cell of ``DEPTH_CUT``
    (or any train cell given ``depths``) is traced at the cut and
    extrapolated (``trace_cut``)."""
    mesh_tag = "multi" if multi_pod else "single"
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{arch}__{shape_name}__{mesh_tag}__{tag}.json"
    if depths is None:
        depths = DEPTH_CUT.get(arch)
    cut = trace and depths is not None and SHAPES[shape_name].kind == "train"
    try:
        if cut:
            rec = trace_cut(arch, shape_name, PRODUCTION[multi_pod], variant,
                            tuple(depths))
        else:
            rec = trace_cell(arch, shape_name, PRODUCTION[multi_pod],
                             variant, trace=trace)
        rec["status"] = "skipped" if "skipped" in rec else "ok"
    except Exception as e:  # record the failure, keep the sweep going
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "variant": variant or {}, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    out.write_text(json.dumps(rec, indent=2, default=str))
    extra = ""
    if rec["status"] == "ok" and "roofline" in rec:
        r = rec["roofline"]
        extra = (f" trace={rec.get('trace_s')}s"
                 f" bottleneck={r.get('bottleneck')}"
                 f" bound={r.get('step_time_lower_bound_s'):.4g}s"
                 f" mem/dev={rec.get('peak_bytes_per_device', 0)/2**30:.2f}GiB")
    print(f"[dryrun] {arch} × {shape_name} × {mesh_tag} [{tag}]: "
          f"{rec['status']}{extra}", flush=True)
    return rec


def calibrate(arch: str, shape_name: str,
              out_dir: Path = RESULTS_DIR) -> dict:
    """Validate the analytic FLOPs model against ``FlopCounterMode`` on a
    LOOP-FREE config (the JAX package's: n_layers = group_size, one
    microbatch, chunks = seq, no remat), traced on fake CPU tensors, where
    every product is an aten op that the counter sees (the kernels' plain
    versions). The world is one rank: the port's placement replicates
    some of the model's work over "model" (the stated differences: k/v
    where the KV heads do not divide the axis, ``wo``), so a per-device
    count on the production mesh would not be the analytic model's
    per-device share; on one rank both count the whole step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    shape = SHAPES[shape_name]
    cfg0 = get_config(arch)
    small = ShapeDef(shape.name, min(shape.seq_len, 4096),
                     min(shape.global_batch, 32), shape.kind)
    overrides = dict(n_layers=cfg0.group_size, attn_chunk=small.seq_len,
                     ssm_chunk=small.seq_len, decode_chunk=small.seq_len,
                     remat=False)
    mesh = fake_world((1, 1), ("data", "model"))
    try:
        cfg = apply_policy(cfg0.scaled(**overrides), small, mesh)
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        step, args, _ = _inputs(cfg, small, mesh, fake_mode, {}, 1,
                                dev=torch.device("cpu"))
        counter = FlopCounterMode(display=False)
        grad = torch.enable_grad() if small.kind == "train" \
            else torch.no_grad()
        with fake_mode, counter, grad:
            step(*args)
        counted = float(counter.get_total_flops())
    finally:
        mesh.close()
    ana = analytic_cell_cost(cfg, small, mesh, microbatches=1)
    rec = {"arch": arch, "shape": shape_name, "kind": "calibration",
           "loopfree_counted_flops_per_dev": counted,
           "loopfree_analytic_flops_per_dev": ana["flops_per_device"],
           "ratio_analytic_over_counted": (ana["flops_per_device"] / counted
                                           if counted else float("nan"))}
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"calibrate__{arch}__{shape_name}.json").write_text(
        json.dumps(rec, indent=2))
    print(f"[calibrate] {arch} × {shape_name}: analytic/counted = "
          f"{rec['ratio_analytic_over_counted']:.3f}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default=None,
                    help="JSON dict of ModelConfig overrides (and the run "
                         "option _grad_accum_bf16)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--lower-only", action="store_true",
                    help="build the inputs, do not trace the step")
    ap.add_argument("--calibrate", action="store_true",
                    help="loop-free analytic-vs-counted FLOPs validation")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory of the records")
    ap.add_argument("--depths", default=None,
                    help="train cells: trace at these two layer counts "
                         "(e.g. 1,2) and extrapolate per layer (default: "
                         "DEPTH_CUT's archs only)")
    args = ap.parse_args(argv)
    depths = tuple(int(x) for x in args.depths.split(",")) \
        if args.depths else None
    out_dir = Path(args.out)

    if args.calibrate:
        archs = ARCH_IDS if args.arch in (None, "all") else [args.arch]
        shapes = (["train_4k", "prefill_32k", "decode_32k"]
                  if args.shape in (None, "all") else [args.shape])
        for arch in archs:
            for shape_name in shapes:
                try:
                    calibrate(arch, shape_name, out_dir)
                except Exception as e:
                    print(f"[calibrate] {arch} × {shape_name}: "
                          f"ERROR {type(e).__name__}: {e}", flush=True)
        return

    archs = ARCH_IDS if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPES) if args.shape in (None, "all") else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    variant = json.loads(args.variant) if args.variant else None
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                run_and_save(arch, shape_name, multi_pod, variant, args.tag,
                             out_dir, trace=not args.lower_only,
                             depths=depths)


if __name__ == "__main__":
    main()
