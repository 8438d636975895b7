"""The elastic restore (the JAX package's ``tests/test_distributed.py::
test_elastic_restore_across_mesh_sizes``): a checkpoint written under one
training mesh restores onto another.

A gloo world of 4 (data 2, model 2) trains the gemma2-2b smoke config two
sharded steps through ``TrainLoop(shardings=)``, which gathers the sharded
leaves and lets rank 0 alone write full arrays. A world of 8 then restores
it twice: onto (data 4, model 2), as the reference does, through
``TrainLoop``'s auto-restore, and onto (data 2, model 4), which changes
the "model" shard count, through ``restore_pytree(shardings=)``. Every
rank's leaves must be its slice of the checkpoint's full arrays bit for bit
(q/k/v weights, biases and their optimizer-state mirrors cut on the last
axis in rank order, everything else whole), and the gathered tree must
equal the checkpoint. The checkpoint's manifest matches an unsharded
run's leaf for leaf (keys, dtypes, full shapes).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import hybrid_optimizer
from repro_torch.data import make_pipeline
from repro_torch.models import lm_init
from repro_torch.train import TrainLoop, make_train_step

ROOT = Path(__file__).resolve().parents[1]

_PREAMBLE = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=sys.argv[3], rank=RANK,
                        world_size=WORLD)
"""


def run_world(n: int, script: str, tmp_path, *args: str,
              timeout: float = 150) -> str:
    """Run ``script`` (after ``_PREAMBLE``) as a gloo world of ``n``
    processes over a ``file://`` store under ``tmp_path``, ``args`` from
    ``sys.argv[4]`` on; every rank must exit 0. Returns rank 0's stdout."""
    src = tmp_path / f"world{n}.py"
    # every rank leaves the world together, its meshes closed first: a
    # group object still held once the world is destroyed is torn down at
    # the interpreter's exit, where gloo's threads can abort the process
    src.write_text(_PREAMBLE + textwrap.dedent(script)
                   + "\ndist.barrier()\ndist.destroy_process_group()\n")
    store = tmp_path / f"store{n}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(src), str(r), str(n), f"file://{store}", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {n}:\n{err[-4000:]}"
    return outs[0][0]


_COMMON = """
from repro_torch.checkpoint import restore_pytree
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import hybrid_optimizer
from repro_torch.data import make_pipeline
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.distributed.placement import gather_tree, named, place
from repro_torch.launch.shardings import train_param_specs, train_state_specs
from repro_torch.models import lm_init
from repro_torch.train import TrainLoop, make_train_step

CKPT = sys.argv[4]
cfg = get_smoke("gemma2-2b").scaled(dtype=torch.float32,
                                    use_sharding_constraints=True)


def parts(mesh):
    params = lm_init(cfg, torch.Generator().manual_seed(0))
    specs = train_param_specs(params)
    local = place(params, named(mesh, specs))
    opt = hybrid_optimizer(eta=1000.0, fp_lr=1e-3)
    state = opt.init(local)
    step = make_train_step(cfg, opt, 2, grad_shardings=named(mesh, specs))
    sh = named(mesh, train_state_specs(local, state, specs))
    return params, opt, local, state, step, sh
"""

_SAVE = _COMMON + """
mesh = make_local_mesh(2, "cpu")
params, opt, local, state, step, sh = parts(mesh)
loop = TrainLoop(step, local, state, make_pipeline(cfg, 16, 8),
                 ckpt_dir=CKPT, ckpt_every=2, log_every=100, shardings=sh)
loop.run(2, install_signal_handlers=False)
print(json.dumps({"history": loop.history, "writer": loop.writer}))
mesh.close()
"""

_RESTORE = _COMMON + """
COLS = ("/attn/wq/", "/attn/wk/", "/attn/wv/")
report = []
for model_axis in (2, 4):
    mesh = make_local_mesh(model_axis, "cpu")
    params, opt, local, state, step, sh = parts(mesh)
    full, at = restore_pytree({"params": params, "opt": opt.init(params)},
                              CKPT)
    if model_axis == 2:
        loop = TrainLoop(step, local, state, make_pipeline(cfg, 16, 8),
                         ckpt_dir=CKPT, log_every=100, shardings=sh)
        got, at2 = {"params": loop.params, "opt": loop.opt_state}, loop.step
    else:
        got, at2 = restore_pytree({"params": local, "opt": state}, CKPT,
                                  shardings=sh)
    assert at == at2 == 2, (at, at2)
    tp, m = mesh.shape["model"], mesh.coords["model"]
    flat_full, flat_got = _flatten(full), _flatten(got)
    assert flat_full.keys() == flat_got.keys()
    n_cut = 0
    for key, f in flat_full.items():
        want = f
        if any(c in "/" + key for c in COLS) and f.dim() >= 2 \\
                and flat_got[key].shape != f.shape:
            cols = f.shape[-1] // tp
            want = f[..., m * cols:(m + 1) * cols]
            n_cut += 1
        assert torch.equal(flat_got[key], want), (model_axis, key)
    back = _flatten(gather_tree(got, sh))
    assert all(torch.equal(back[k], f) for k, f in flat_full.items())
    report.append({"model_axis": model_axis, "cut": n_cut,
                   "leaves": len(flat_full), "mesh": dict(mesh.shape)})
    mesh.close()
print(json.dumps(report))
"""


def test_checkpoint_under_2x2_restores_onto_4x2_and_2x4(tmp_path):
    ckpt = tmp_path / "ckpt"
    out = run_world(4, _SAVE, tmp_path, str(ckpt), timeout=200)
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["writer"] and len(rec["history"]) == 2
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_000000002"]
    report = json.loads(run_world(8, _RESTORE, tmp_path, str(ckpt),
                                  timeout=200).strip().splitlines()[-1])
    assert [r["mesh"] for r in report] == [{"data": 4, "model": 2},
                                           {"data": 2, "model": 4}]
    # q/k/v weights of two block roles: the params and their Boolean
    # accumulators (the weights are Boolean: no Adam moments)
    assert all(r["cut"] == 12 for r in report), report

    # the manifest of an unsharded run: the same leaves, full shapes
    cfg = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params = lm_init(cfg, torch.Generator().manual_seed(0))
    opt = hybrid_optimizer(eta=1000.0, fp_lr=1e-3)
    loop = TrainLoop(make_train_step(cfg, opt, 2), params, opt.init(params),
                     make_pipeline(cfg, 16, 8), ckpt_dir=str(tmp_path / "one"),
                     ckpt_every=2, log_every=100)
    loop.run(2, install_signal_handlers=False)
    man = [json.loads((d / "step_000000002" / "manifest.json").read_text())
           for d in (ckpt, tmp_path / "one")]
    strip = [{k: (e["dtype"], e["shape"]) for k, e in m["leaves"].items()}
             for m in man]
    assert strip[0] == strip[1]
    assert abs(rec["history"][0] - loop.history[0]) <= 1e-5
