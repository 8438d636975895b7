"""The elastic restore (the JAX package's ``tests/test_distributed.py::
test_elastic_restore_across_mesh_sizes``): a checkpoint written under one
training mesh restores onto another.

A gloo world of 4 (data 2, model 2) trains the gemma2-2b smoke config two
sharded steps through ``TrainLoop(shardings=)`` under the JAX package's
placement (``train_param_specs``: FSDP over "data", the heads, d_ff and
vocab over "model"), which gathers the sharded leaves over both axes and
lets rank 0 alone write full arrays. A world of 8 then restores it twice:
onto (data 4, model 2), as the reference does, through ``TrainLoop``'s
auto-restore, and onto (data 2, model 4), which changes the "model" shard
count, through ``restore_pytree(shardings=)``; a world of 4 restores it
onto (data 4, model 1), no "model" split, through ``TrainLoop``; and
``restore_pytree`` restores it unsharded. Every rank's leaves must be its
slice of the checkpoint's full arrays bit for bit (each leaf and its
optimizer-state mirrors cut on the dims its spec splits, in rank order,
the scalars whole), the gathered tree must equal the checkpoint, and the
unsharded restore must equal the gathered tree. The checkpoint's manifest
matches an unsharded run's leaf for leaf (keys, dtypes, full shapes).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import hybrid_optimizer
from repro_torch.data import make_pipeline
from repro_torch.checkpoint import restore_pytree
from repro_torch.checkpoint.manager import _flatten
from repro_torch.launch.shardings import train_param_specs
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
import torch.distributed as dist
from repro_torch.core.optimizer import tree_leaves


def cut(t, spec, mesh):
    # this rank's slice of a full leaf: each dim its spec names cut in
    # rank order over that axis
    for d, axis in enumerate(spec):
        if axis is not None:
            n = t.shape[d] // mesh.shape[axis]
            t = t[(slice(None),) * d + (slice(mesh.coords[axis] * n,
                                               (mesh.coords[axis] + 1) * n),)]
    return t


report = []
for model_axis in map(int, sys.argv[5].split(",")):
    mesh = make_local_mesh(model_axis, "cpu")
    params, opt, local, state, step, sh = parts(mesh)
    full, at = restore_pytree({"params": params, "opt": opt.init(params)},
                              CKPT)
    if model_axis == int(sys.argv[5].split(",")[0]):
        loop = TrainLoop(step, local, state, make_pipeline(cfg, 16, 8),
                         ckpt_dir=CKPT, log_every=100, shardings=sh)
        got, at2 = {"params": loop.params, "opt": loop.opt_state}, loop.step
    else:
        got, at2 = restore_pytree({"params": local, "opt": state}, CKPT,
                                  shardings=sh)
    assert at == at2 == 2, (at, at2)
    flat_full, flat_got = _flatten(full), _flatten(got)
    flat_sh = _flatten(sh)
    assert flat_full.keys() == flat_got.keys()
    n_cut = 0
    for key, f in flat_full.items():
        spec = tuple(flat_sh[key].spec)
        want = cut(f, spec, mesh)
        n_cut += want.shape != f.shape
        assert torch.equal(flat_got[key], want), (model_axis, key)
    back = gather_tree(got, sh)
    flat_back = _flatten(back)
    assert all(torch.equal(flat_back[k], f) for k, f in flat_full.items())
    report.append({"model_axis": model_axis, "cut": n_cut,
                   "leaves": len(flat_full), "mesh": dict(mesh.shape)})
    if RANK == 0 and len(sys.argv) > 6:
        np.savez(sys.argv[6], **{k: (v.float() if v.dtype == torch.bfloat16
                                     else v).numpy()
                                 for k, v in flat_back.items()})
    mesh.close()
print(json.dumps(report))
"""


def _n_cut(params, specs, axes):
    """The state leaves a placement cuts on a mesh whose split axes are
    ``axes``: each cut parameter and its mirrors (a Boolean leaf's
    accumulator, an FP leaf's two Adam moments)."""
    from repro_torch.core.optimizer import tree_leaves, tree_map
    n = 0
    for p, sp in zip(tree_leaves(params),
                     tree_leaves(tree_map(tuple, specs))):
        if any(a in axes for a in sp):
            n += 1 + (1 if p.dtype == torch.int8 else 2)
    return n


def test_checkpoint_under_2x2_restores_onto_4x2_and_2x4(tmp_path):
    ckpt = tmp_path / "ckpt"
    out = run_world(4, _SAVE, tmp_path, str(ckpt), timeout=200)
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["writer"] and len(rec["history"]) == 2
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_000000002"]
    report = json.loads(run_world(8, _RESTORE, tmp_path, str(ckpt), "2,4",
                                  timeout=200).strip().splitlines()[-1])
    assert [r["mesh"] for r in report] == [{"data": 4, "model": 2},
                                           {"data": 2, "model": 4}]
    cfg = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params = lm_init(cfg, torch.Generator().manual_seed(0))
    specs = train_param_specs(params)
    assert all(r["cut"] == _n_cut(params, specs, ("data", "model"))
               for r in report), report

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


def test_checkpoint_under_2x2_restores_onto_4x1_and_unsharded(tmp_path):
    """The (data 2, model 2) checkpoint onto (data 4, model 1) through
    ``TrainLoop``'s auto-restore (each rank's slices, only "data" cuts),
    and unsharded through ``restore_pytree``: the unsharded tree equals the
    (data 4, model 1) ranks' gathered one, bit for bit."""
    ckpt = tmp_path / "ckpt"
    # each world its own store
    save, restore = tmp_path / "save", tmp_path / "restore"
    save.mkdir()
    restore.mkdir()
    run_world(4, _SAVE, save, str(ckpt), timeout=200)
    back = tmp_path / "back.npz"
    report = json.loads(run_world(4, _RESTORE, restore, str(ckpt), "1",
                                  str(back), timeout=200)
                        .strip().splitlines()[-1])
    assert [r["mesh"] for r in report] == [{"data": 4, "model": 1}]
    cfg = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params = lm_init(cfg, torch.Generator().manual_seed(0))
    specs = train_param_specs(params)
    assert report[0]["cut"] == _n_cut(params, specs, ("data",))
    opt = hybrid_optimizer(eta=1000.0, fp_lr=1e-3)
    whole, at = restore_pytree({"params": params, "opt": opt.init(params)},
                               ckpt)
    assert at == 2
    gathered = dict(np.load(back))
    flat = _flatten(whole)
    assert flat.keys() == gathered.keys()
    for key, t in flat.items():
        t = t.float() if t.dtype == torch.bfloat16 else t
        assert np.array_equal(t.numpy(), gathered[key]), key
