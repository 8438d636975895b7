"""End-to-end driver: train a B⊕LD qwen-family LM on synthetic data, with
checkpoint/restart fault tolerance — the JAX package's
``examples/train_lm.py`` on the port.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 \\
        [--device cpu] [--full-100m] [--resume]

Defaults are qwen2.5-14b's smoke config; ``--full-100m`` selects the ~100M
config the JAX example scales from it. ``hybrid_optimizer`` on two cosine
schedules (warmup steps/20), ``make_train_step(cfg, opt,
microbatches=1)``, the synthetic pipeline and ``TrainLoop`` with a
checkpoint every 50 steps; ``--resume`` continues from the latest
checkpoint in ``--ckpt-dir`` (else the directory is cleared first). The
JAX example jits the step with its params and optimizer state donated;
the port's step updates both in place, so nothing is donated or copied.

``--ckpt-dir`` defaults to ``bold_lm_ckpt_torch`` under the temporary
directory, never the JAX example's. ``--device`` defaults to ``cuda`` and
raises on a host without a card.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
from pathlib import Path

import torch

from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import (cosine_schedule, hybrid_optimizer,
                                        tree_leaves)
from repro_torch.data import make_pipeline
from repro_torch.models import lm_init
from repro_torch.serve import resolve_device
from repro_torch.train import TrainLoop, make_train_step

DEFAULT_CKPT = str(Path(tempfile.gettempdir()) / "bold_lm_ckpt_torch")


def config(full_100m: bool = False):
    cfg = get_smoke("qwen2.5-14b")
    if full_100m:
        cfg = cfg.scaled(name="bold-qwen-100m", n_layers=6, d_model=768,
                         n_heads=12, n_kv_heads=4, d_ff=2048,
                         vocab_size=32_000)
    return cfg


def make_loop(cfg, params, steps: int, seq: int, batch: int, ckpt_dir,
              ckpt_every: int = 50, log_every: int = 20) -> TrainLoop:
    """The example's ``TrainLoop`` over ``params`` (restored from
    ``ckpt_dir``'s latest checkpoint where it holds one)."""
    warmup = max(steps // 20, 1)
    opt = hybrid_optimizer(eta=cosine_schedule(6.0, steps, warmup=warmup),
                           fp_lr=cosine_schedule(2e-3, steps, warmup=warmup))
    return TrainLoop(make_train_step(cfg, opt, microbatches=1), params,
                     opt.init(params), make_pipeline(cfg, seq, batch),
                     ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                     log_every=log_every)


def main(argv=None) -> TrainLoop:
    """-> the finished loop (``history``: this run's losses,
    ``step_times``: each step's seconds, ended by reading its loss)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true",
                    help="~100M-param config")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    cfg = config(args.full_100m)
    print(f"[example] arch={cfg.name} "
          f"layers={cfg.n_layers} d={cfg.d_model} vocab={cfg.vocab_size}")
    params = lm_init(cfg, torch.Generator(device=dev).manual_seed(0))
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    n_bool = sum(p.numel() for p in leaves if p.dtype == torch.int8)
    print(f"[example] params {n_params/1e6:.1f}M "
          f"({n_bool/1e6:.1f}M native Boolean = "
          f"{100*n_bool/n_params:.0f}%)")

    loop = make_loop(cfg, params, args.steps, args.seq, args.batch,
                     args.ckpt_dir)
    hist = loop.run(args.steps)
    k = max(len(hist) // 10, 1)
    first, last = sum(hist[:k]) / k, sum(hist[-k:]) / k
    print(f"[example] loss {first:.3f} -> {last:.3f} "
          f"({100 * (first - last) / first:.1f}% reduction)")
    assert last < first, "Boolean training must reduce loss"
    return loop


if __name__ == "__main__":
    main()
