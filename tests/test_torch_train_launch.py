"""The training launcher over a training mesh, and the mesh itself.

``python -m repro_torch.launch.train --mesh local --model-axis 2`` under
``torchrun --standalone`` (``python -m torch.distributed.run``) as a
(data 2, model 2) gloo world of 4 processes against the world of one,
and the worlds it refuses; in this process, the mesh of one that
``make_local_mesh`` starts and the meshes it refuses; and a (pod 2, data
2, model 2) mesh's process groups over 8 gloo processes (``run_world``).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

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


def _torchrun(n, *args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
         "--arch", "gemma2-2b", "--smoke", "--device", "cpu", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def test_launcher_mesh_local_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train
    --mesh local --model-axis 2``: a (data 2, model 2) world that trains,
    prints its summary once (rank 0), writes one checkpoint of full arrays,
    and reads the world of one's first loss."""
    args = ("--steps", "3", "--batch", "8", "--seq", "16",
            "--microbatches", "2", "--mesh", "local")
    res = _torchrun(4, *args, "--model-axis", "2", "--ckpt-dir",
                    str(tmp_path / "w4"))
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.count("[train] loss") == 1
    assert "[train] mesh {'data': 2, 'model': 2} over cpu" in res.stdout
    man = json.loads((tmp_path / "w4" / "step_000000003" / "manifest.json")
                     .read_text())
    assert man["leaves"]["params/blocks/b0/attn/wq/w"]["shape"] == \
        [2, 64, 16 * 16]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma2-2b", "--smoke", "--device", "cpu", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert one.returncode == 0, one.stderr[-4000:]
    def losses(out):
        line = next(ln for ln in out.splitlines() if "[train] loss" in ln)
        return [float(w) for w in line.split() if w[0].isdigit()]

    (first4, last4), (first1, last1) = losses(res.stdout), losses(one.stdout)
    # the first step's loss agrees to the printed digits; the smoke config
    # is bf16, whose FP leaves' Adam updates round an ulp apart once their
    # grads are summed in another order, so later losses part slightly
    assert first4 == first1 and abs(last4 - last1) <= 0.05, (
        (first4, last4), (first1, last1))


@pytest.mark.parametrize("args, message", [
    (("--model-axis", "3"), "not divisible by model_axis=3"),
    (("--mesh", "single"), "needs a world of 256 ranks"),
])
def test_launcher_refuses_meshes_the_world_cannot_hold(args, message):
    """A world of 2 cannot hold a model axis of 3 or the 256-rank pod mesh:
    every rank exits non-zero with the reason."""
    res = _torchrun(2, "--steps", "1", *args, timeout=120)
    assert res.returncode != 0
    assert message in res.stderr


def test_training_mesh_of_one_and_its_refusals(monkeypatch):
    """In this process (a world of none): a model axis that does not divide
    the world and the production meshes are refused before any group
    starts; on CUDA more ranks on a host than visible cards are refused
    (NCCL takes one card a rank); ``make_local_mesh(1)`` starts a world of
    one, whose (data 1, model 1) mesh issues no collective, and its
    ``close`` ends that world."""
    import torch.distributed as dist

    from repro_torch.distributed import TrainMesh, get_mesh
    from repro_torch.launch import mesh as M

    with pytest.raises(ValueError, match="not divisible by model_axis=2"):
        M.make_local_mesh(2, "cpu")
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        M.make_production_mesh(multi_pod=True, device="cpu")
    assert not dist.is_initialized()
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"),
                     ("LOCAL_WORLD_SIZE", "2"), ("MASTER_ADDR", "localhost"),
                     ("MASTER_PORT", "1")):
            mp.setenv(k, v)
        with pytest.raises(ValueError, match="only 1 CUDA devices"):
            M.make_local_mesh(1, "cuda")
    assert not dist.is_initialized()
    mesh = M.make_local_mesh(1, "cpu")
    try:
        assert isinstance(mesh, TrainMesh) and get_mesh() is mesh
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.coords == {"data": 0, "model": 0} and mesh.size == 1
        assert M.mesh_batch_axes(mesh) == ("data",)
        assert M.mesh_num_chips(mesh) == 1
        assert mesh.index(("data", "model")) == 0
        t = torch.arange(6.0).reshape(2, 3)
        assert mesh.all_reduce(t, "data") is t
        assert mesh.all_gather(t, "model", 1) is t
        assert not any(mesh.counts.values())
    finally:
        mesh.close()
    assert not dist.is_initialized()


_POD = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed import TrainMesh

mesh = TrainMesh(init_device_mesh("cpu", (2, 2, 2),
                                  mesh_dim_names=("pod", "data", "model")),
                 "cpu")
got = {}
for axes in (("pod",), ("data",), ("model",), ("pod", "data"),
             ("pod", "data", "model")):
    t = torch.tensor([float(RANK)])
    mesh.all_reduce(t, axes)
    got[" ".join(axes)] = [float(t[0]), mesh.size_of(axes), mesh.index(axes)]
every = [None] * WORLD
dist.all_gather_object(every, (mesh.coords, got))
if RANK == 0:
    print(json.dumps(every))
mesh.close()
"""


def test_pod_mesh_groups_cover_the_ranks_they_should(tmp_path):
    """A (pod 2, data 2, model 2) mesh over 8 gloo ranks: each axis's group,
    the batch axes' group ("pod", "data": 4 ranks of one model coordinate)
    and the whole world sum exactly the ranks that share the other
    coordinates; ``index`` is the row-major index over the axes."""
    every = json.loads(run_world(8, _POD, tmp_path).strip().splitlines()[-1])
    coords = [c for c, _ in every]
    for rank, (c, got) in enumerate(every):
        assert rank == 4 * c["pod"] + 2 * c["data"] + c["model"]
        for axes, (total, size, index) in got.items():
            names = axes.split()
            peers = [r for r, o in enumerate(coords)
                     if all(o[a] == c[a] for a in c if a not in names)]
            assert total == sum(peers) and size == len(peers), (rank, axes)
            want = 0
            for a in names:
                want = want * 2 + c[a]
            assert index == want, (rank, axes)
