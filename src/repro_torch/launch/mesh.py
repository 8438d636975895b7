"""Mesh construction over ``torch.distributed``.

The serve mesh is the JAX package's 1-D ("model",) mesh with one PROCESS
a shard: ``init_serve_world`` joins this process to a world of N (NCCL on
``cuda:rank``, gloo on the CPU), and ``make_serve_mesh`` builds the
``DeviceMesh`` of its "model" dimension. A process that never joined a
world is a world of one: ``make_serve_mesh(1)`` starts that world itself
(an in-memory store, nothing leaves the process), and refuses more shards
than there are processes or, on CUDA, cards — NCCL takes one card a rank.

``make_local_mesh`` and ``make_production_mesh`` are the training
meshes, the JAX package's ("data", "model") and ("pod", "data", "model")
shapes, one process a device: a ``TrainMesh`` over the whole world. The
world is the one this process has joined, else the one torch's standard
environment describes (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), else a world of one
started here. ``mesh_batch_axes`` and ``mesh_num_chips`` read any mesh.

``fake_world`` is the dry run's world (``launch/dryrun.py``): torch's
``"fake"`` backend at rank 0 of any number of ranks, whose collectives
return at once and move nothing, for a step traced under
``FakeTensorMode``. Its mesh's device is ``meta``: a fake tensor there
has no storage and no device guard (a CPU-only torch cannot index a fake
``cuda`` tensor), and the kernel wrappers take it for the card's
(``kernels.build.traced``). Given a real device it runs rank 0 of the
same mesh on real tensors, to hold a trace's memory and launches to the
card's. A training run never starts that backend: the worlds above are
NCCL or gloo.
"""
from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed import ServeMesh, TrainMesh, set_mesh

#: how long a collective (and the world's rendezvous) may wait on a rank
#: before it raises: a rank that died never hangs the others
TIMEOUT = datetime.timedelta(seconds=120)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device, rank: int) -> torch.device:
    """``cuda`` -> ``cuda:rank`` (one card a rank); the CPU as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    return dev


def check_serve_world(n: int, device="cuda", world: int = None) -> None:
    """Raise ``ValueError`` when ``n`` shards cannot be served: more than
    ``world`` processes (default: the current world, 1 outside one) or,
    on CUDA, more than the visible cards."""
    if n < 1:
        raise ValueError(f"make_serve_mesh: {n} shards")
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if n > cards:
            raise ValueError(
                f"make_serve_mesh: asked for {n} shards but only {cards} CUDA "
                "devices are visible (NCCL serves one card a rank)")
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if n > world:
        raise ValueError(
            f"make_serve_mesh: asked for {n} shards but only {world} devices "
            "(processes) are in the world (start one process a shard: "
            "python -m repro_torch.launch.serve --shards N)")


def init_serve_world(rank: int, world: int, init_method: str,
                     device="cuda") -> torch.device:
    """Join this process to a serve world of ``world`` ranks at
    ``init_method`` (``tcp://localhost:PORT`` or ``file://PATH``), NCCL on
    ``cuda:rank`` or gloo on the CPU, every collective bounded by
    ``TIMEOUT``. Returns this rank's device."""
    dev = _rank_device(device, rank)
    check_serve_world(world, dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(_backend(dev), init_method=init_method,
                            rank=rank, world_size=world, timeout=TIMEOUT,
                            **kw)
    return dev


def make_serve_mesh(n_shards: int = 0, device="cuda") -> ServeMesh:
    """1-D ("model",) mesh for tensor-parallel serving
    (``ServeEngine(mesh=)``): every rank of the world, or a world of one
    started here. ``n_shards=0`` takes the whole world. Installs the mesh
    as the process's (``get_mesh``)."""
    started = not dist.is_initialized()
    world = dist.get_world_size() if not started else 1
    n = n_shards or world
    dev = _rank_device(device, dist.get_rank() if not started else 0)
    check_serve_world(n, dev, world)
    if n != world:
        raise ValueError(f"make_serve_mesh: {n} shards over a world of "
                         f"{world}: the serve mesh spans the whole world")
    if started:
        kw = {}
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1, timeout=TIMEOUT, **kw)
    elif dist.get_backend() != _backend(dev):
        raise ValueError(f"make_serve_mesh: a {dev.type} mesh needs the "
                         f"{_backend(dev)} backend, the world runs "
                         f"{dist.get_backend()}")
    dm = init_device_mesh(dev.type, (n,), mesh_dim_names=("model",))
    ctrl = dist.new_group(backend="gloo", timeout=TIMEOUT) if n > 1 else None
    mesh = ServeMesh(dm, dev, ctrl, owns_world=started)
    set_mesh(mesh)
    return mesh


def _join_world(device) -> tuple:
    """Join the world for a training mesh -> (device, started here): the
    world already joined, torch's environment (``torchrun``), or a world
    of one. NCCL on ``cuda:LOCAL_RANK`` (more ranks than visible cards are
    refused: NCCL takes one card a rank), gloo on the CPU."""
    dev = torch.device(device)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        local = int(os.environ.get("LOCAL_RANK", rank))
        started = False
    elif "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        started = True
    else:
        rank, world, local, started = 0, 1, 0, True
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        here = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if here > cards:
            raise ValueError(
                f"a training mesh of {here} ranks on this host but only "
                f"{cards} CUDA devices are visible (NCCL takes one card a "
                "rank)")
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if started:
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        if world == 1 and "MASTER_ADDR" not in os.environ:
            kw["store"] = dist.HashStore()
        else:
            kw["init_method"] = "env://"
        dist.init_process_group(_backend(dev), rank=rank, world_size=world,
                                timeout=TIMEOUT, **kw)
    elif dist.get_backend() != _backend(dev):
        raise ValueError(f"a {dev.type} training mesh needs the "
                         f"{_backend(dev)} backend, the world runs "
                         f"{dist.get_backend()}")
    return dev, started


def _train_mesh(shape, axes, device, fake_device="meta") -> TrainMesh:
    if dist.is_initialized() and dist.get_backend() == "fake":
        # fake_world's: the traced step's tensors are fake ones on meta,
        # or real ones on the device a caller names
        dev, started = torch.device(fake_device), False
    else:
        dev, started = _join_world(device)
    try:
        dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
        mesh = TrainMesh(dm, dev, owns_world=started)
    except BaseException:
        if started:
            dist.destroy_process_group()
        raise
    set_mesh(mesh)
    return mesh


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


#: the production meshes' (shape, axes), by ``multi_pod``
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def fake_world(shape, axes, device="meta") -> TrainMesh:
    """A ``TrainMesh`` of ``shape`` named ``axes`` over a world of
    ``prod(shape)`` ranks of torch's ``"fake"`` backend, started here at
    rank 0 (``close()`` ends it); its device is ``meta`` (tensors there are
    ``FakeTensorMode``'s: the dry run), or ``device`` (real tensors: rank 0
    of a large mesh run on one card, its memory and time measured, whose
    collectives move nothing, so its values are not the mesh's). Its
    collectives return at once. ``make_production_mesh`` also builds on
    such a world. Installs the mesh as the process's."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: this process already joined a world")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        mesh = _train_mesh(tuple(shape), tuple(axes), "cuda", device)
    except BaseException:
        dist.destroy_process_group()
        raise
    mesh._owns_world = True
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> TrainMesh:
    """The (data 16, model 16) mesh of a 256-card pod, with a leading pod
    axis of 2 under ``multi_pod``: a world of exactly that many ranks (or
    ``fake_world``'s). Installs it as the process's mesh."""
    shape, axes = PRODUCTION[multi_pod]
    want = math.prod(shape)
    n = _world_size()
    if n != want:
        raise ValueError(
            f"make_production_mesh: the {'multi' if multi_pod else 'single'}"
            f"-pod mesh {dict(zip(axes, shape))} needs a world of {want} "
            f"ranks, this one has {n} (--mesh local trains over the world "
            "that is there)")
    return _train_mesh(shape, axes, device)


def make_local_mesh(model_axis: int = 1, device="cuda") -> TrainMesh:
    """A (data, model) mesh over the whole world: model_axis ranks a data
    row. Installs it as the process's mesh."""
    n = _world_size()
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(f"make_local_mesh: a world of {n} ranks is not "
                         f"divisible by model_axis={model_axis}")
    return _train_mesh((n // model_axis, model_axis), ("data", "model"),
                       device)


def mesh_batch_axes(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return tuple(a for a in names if a in ("pod", "data"))


def mesh_num_chips(mesh) -> int:
    return int(mesh.size if isinstance(mesh, (ServeMesh, TrainMesh))
               else mesh.size())
