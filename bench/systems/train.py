"""Training cells: the port's ``make_train_step`` with the hybrid
optimizer (flip rule for Boolean leaves, Adam for FP ones), driven step
after step by the cell's batches, then checked against the reference.

Set-up builds the one step, its parameters and optimizer state from the
seed and drives them through the first ``check.steps`` steps with the
window's own call and feed (that also warms every shape); the window
then runs further steps of the same object. ``correct`` compares, with
the reference's own steps from the same weights and batches (run after
the window, the port's state freed): each step's loss, each leaf's
first gradient as the optimizer holds it after step 1, and each leaf's
change after the last checked step, by the worst leaf: |‖a‖ − ‖b‖| over the
larger of the reference's ‖b‖ and the median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out (rounding moves them under Adam)."""
from __future__ import annotations

import gc
import importlib
import statistics
import time
from typing import Dict

from bench.reference.numerics import Numerics
from bench.reference.train import flat, follow


def model_config(model: dict):
    from bench.systems.serve import model_config as mc
    return mc(model)


def worst_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep) -> tuple:
    """(the worst leaf's gap, that leaf)."""
    med = statistics.median(ref[k] for k in keep)
    return max((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in keep)


def compare(run, prog: dict, ref: dict) -> bool:
    lim = run.cell["check"]["limits"]
    med = statistics.median(ref["grads"].values())
    keep = sorted(k for k, v in ref["grads"].items() if v >= 1e-3 * med)
    run.left_out = sorted(set(ref["grads"]) - set(keep))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                       ref["losses"]))
    ok = run.check("loss_gap", loss_gap, lim["loss_gap"])
    for name, key in (("first_grad_gap", "grads"), ("change_gap",
                                                     "changes")):
        gap, leaf = worst_gap(prog[key], ref[key], keep)
        ok &= run.check(name, gap, lim[name])
        run.notes.append(f"{name}: worst leaf {leaf}")
    return ok


def program_grad_norms(state, eta: float) -> Dict[str, float]:
    import torch
    out = {}
    for k, m in flat(state.boolean.accum).items():
        out[k] = float(torch.linalg.vector_norm(m.float())) / eta
    for k, m in flat(state.adam.mu).items():
        out[k] = float(torch.linalg.vector_norm(m.float())) / (1 - 0.9)
    return out


def run(run) -> None:
    import torch
    from repro_torch.core.optimizer import hybrid_optimizer
    from repro_torch.train import make_train_step

    from bench import weights
    from bench.reference.train import change_norms

    cell, dev = run.cell, run.device
    tp = cell["traffic_params"]
    cfg = model_config(run.model)
    kind = importlib.import_module(f"bench.traffic.{cell['traffic']}")
    traffic = kind.Traffic(tp, run.seed, cfg.vocab_size)
    n_check = int(cell["check"]["steps"])
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with run.span("setup.weights"):
        params = weights.program_params(run.model, run.seed, dev)
    opt = hybrid_optimizer(eta=float(tp["eta"]), fp_lr=float(tp["fp_lr"]))
    state = opt.init(params)
    step = make_train_step(cfg, opt, microbatches=int(tp["microbatches"]))
    prog = {"losses": []}

    def one(i: int):
        nonlocal params, state
        with run.span("train.step", tokens=traffic.tokens_per_step):
            params, state, m = step(params, state, traffic.batch(i, dev))
            loss = float(m["loss"])             # waits for the step
            if dev == "cuda":
                torch.cuda.synchronize()
        return loss

    for i in range(n_check):
        with run.span("setup.checked_step"):
            prog["losses"].append(one(i))
        if i == 0:
            prog["grads"] = program_grad_norms(state, float(tp["eta"]))
    with run.span("setup.read_changes"), torch.no_grad():
        stacked = flat(params)
        prog["changes"] = change_norms(
            run.model, run.seed,
            lambda k, l: stacked[k] if l < 0 else stacked[k][l], dev)
        del stacked
    run.warm_profiler()
    run.setup_s = time.perf_counter() - run.t_start
    t0 = run.window_open()
    i = n_check
    while True:
        one(i)
        i += 1
        run.tick()
        t = time.perf_counter()
        if t - t0 >= run.seconds:
            break
    run.window_close(t)
    run.attempted, run.failed = i - n_check, 0
    run.shape_probe(lambda: one(i))
    if dev == "cuda":
        run.memory_peak = int(torch.cuda.max_memory_allocated())
    del params, state, step, opt
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    batches = [traffic.batch(j, dev) for j in range(n_check)]
    with run.span("check.reference"):
        ref = follow(run.model, run.seed, batches, float(tp["eta"]),
                     float(tp["fp_lr"]), int(tp["microbatches"]), dev,
                     Numerics("bfloat16"))
    run.correct = compare(run, prog, ref)
    if getattr(run, "control", False):
        with run.span("check.control"):
            ctl = follow(run.model, run.seed, batches, float(tp["eta"]),
                         float(tp["fp_lr"]), int(tp["microbatches"]), dev,
                         Numerics("fp8"))
        saved, notes = dict(run.checks), list(run.notes)
        compare(run, ctl, ref)
        run.control_reading = {k: v["value"] for k, v in run.checks.items()}
        run.checks, run.notes = saved, notes
