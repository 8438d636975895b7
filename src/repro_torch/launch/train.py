"""Training launcher of the port, with the JAX package's flags.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --smoke --steps 50 --batch 8 --seq 128 [--device cpu]

Builds ``lm_init`` on a seeded generator, ``hybrid_optimizer`` with cosine
schedules (warmup steps/20), ``make_train_step`` and ``TrainLoop`` over the
synthetic pipeline (or ``--data`` .bin tokens). ``--device`` defaults to
``cuda`` and raises on a host without a card; ``--device cpu`` runs the
kernels' plain versions. The JAX launcher's ``--mesh`` and ``--model-axis``
come with the multi-device slice.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eta", type=float, default=4.0, help="Boolean lr η")
    ap.add_argument("--fp-lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data", default=None, help=".bin token file (else synthetic)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core.optimizer import cosine_schedule, hybrid_optimizer
    from repro_torch.data import make_pipeline
    from repro_torch.models import lm_init
    from repro_torch.serve import resolve_device
    from repro_torch.train import TrainLoop, make_train_step

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    params = lm_init(cfg, torch.Generator(device=device).manual_seed(0))
    opt = hybrid_optimizer(
        eta=cosine_schedule(args.eta, args.steps, warmup=args.steps // 20),
        fp_lr=cosine_schedule(args.fp_lr, args.steps, warmup=args.steps // 20))
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, args.microbatches)
    pipeline = make_pipeline(cfg, args.seq, args.batch, path=args.data)

    loop = TrainLoop(step_fn, params, opt_state, pipeline,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    history = loop.run(args.steps)
    if history:
        k = max(len(history) // 10, 1)
        print(f"[train] loss first{k}-avg {sum(history[:k])/k:.4f} -> "
              f"last{k}-avg {sum(history[-k:])/k:.4f}")
    print(f"[train] stragglers observed: {len(loop.stragglers)}")
    return history


if __name__ == "__main__":
    main()
