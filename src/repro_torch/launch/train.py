"""Training launcher of the port, with the JAX package's flags.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --smoke --steps 50 --batch 8 --seq 128 [--device cpu]

Builds ``lm_init`` on a seeded generator, ``hybrid_optimizer`` with cosine
schedules (warmup steps/20), ``make_train_step`` and ``TrainLoop`` over the
synthetic pipeline (or ``--data`` .bin tokens). ``--device`` defaults to
``cuda`` and raises on a host without a card; ``--device cpu`` runs the
kernels' plain versions.

``--mesh local`` (the default) trains over the ("data", "model") mesh of
the world this process is in, ``--model-axis`` ranks a data row: a world
started by ``torchrun`` (one process a card, NCCL; gloo under ``--device
cpu``), else a world of one. ``--mesh single`` / ``multi`` build the
256- / 512-rank production mesh. Over more than one rank the step is
sharded by the JAX package's training placement (``launch/shardings.py``:
the batch and FSDP of the large weights over "data", the heads, d_ff,
d_inner, the experts and the vocab over "model"), and MoE archs route in
as many groups as batch shards:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch gemma2-2b --smoke --steps 10 --device cpu --model-axis 2
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
    ap.add_argument("--mesh", default="local", choices=["local", "single", "multi"])
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core.optimizer import cosine_schedule, hybrid_optimizer
    from repro_torch.data import make_pipeline
    from repro_torch.distributed.placement import named, place
    from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                         mesh_batch_axes)
    from repro_torch.launch.shardings import (kv_replicated,
                                              train_param_specs,
                                              train_state_specs)
    from repro_torch.models import lm_init
    from repro_torch.serve import resolve_device
    from repro_torch.train import TrainLoop, make_train_step

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.mesh == "local":
        mesh = make_local_mesh(args.model_axis, device)
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=device)
    try:
        sharded = mesh.size > 1
        axes = mesh_batch_axes(mesh)
        cfg = cfg.scaled(batch_axes=axes, use_sharding_constraints=sharded)
        dp = mesh.size_of(axes)
        if cfg.n_experts and dp > 1:
            # a rank routes its own rows: one routing group a batch shard
            cfg = cfg.scaled(moe_groups=dp)
        rank0 = mesh.index(mesh.axis_names) == 0
        params = lm_init(cfg, torch.Generator(device=mesh.device)
                         .manual_seed(0))
        specs = shardings = None
        if sharded:
            specs = train_param_specs(params, replicate_kv=kv_replicated(
                cfg, mesh.shape["model"]))
            shardings = named(mesh, specs)
            params = place(params, shardings)
        opt = hybrid_optimizer(
            eta=cosine_schedule(args.eta, args.steps, warmup=args.steps // 20),
            fp_lr=cosine_schedule(args.fp_lr, args.steps,
                                  warmup=args.steps // 20))
        opt_state = opt.init(params)
        step_fn = make_train_step(cfg, opt, args.microbatches,
                                  grad_shardings=shardings)
        pipeline = make_pipeline(cfg, args.seq, args.batch, path=args.data)
        if rank0:
            print(f"[train] mesh {mesh.shape} over {mesh.device.type}"
                  + (f", moe_groups {cfg.moe_groups}" if cfg.n_experts
                     else ""), flush=True)

        loop = TrainLoop(step_fn, params, opt_state, pipeline,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         shardings=named(mesh, train_state_specs(
                             params, opt_state, specs)) if sharded else None)
        history = loop.run(args.steps)
        if rank0:
            if history:
                k = max(len(history) // 10, 1)
                print(f"[train] loss first{k}-avg {sum(history[:k])/k:.4f} -> "
                      f"last{k}-avg {sum(history[-k:])/k:.4f}")
            print(f"[train] stragglers observed: {len(loop.stragglers)}")
        return history
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
