"""The serve mesh over ``torch.distributed``, and the process-wide mesh
context.

The JAX package traces its tensor-parallel serving graphs under
``shard_map`` on a 1-D ("model",) mesh. The port runs one process per
shard instead: ``ServeMesh`` holds what the traced body reached through
``shard_map`` — the process group of the "model" dimension, this rank and
the world of that dimension — and the one collective the serving model
needs, an all-gather of the head axis. Ranks hold contiguous head slices
(rank r the heads [r·h, (r+1)·h) of h a shard), so the shard-major
gathered order IS the global head order.

``serving(mesh)`` marks the model body the engine runs as sharded: the
attention layers read ``active_mesh()`` for the rank (the padded-head
mask tests global head indices) and the head gather before ``wo``.
``set_mesh`` / ``get_mesh`` are the launcher's process-wide slot, as in
the JAX package.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist

_MESH = None
_ACTIVE = threading.local()


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """Gather every rank's ``x`` into ``out`` along dim 0, rank-major:
    ``all_gather_single`` where torch has it (it deprecates
    ``all_gather_into_tensor``), else the older name."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


class ServeMesh:
    """A 1-D tensor-parallel serve mesh: ``device_mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh`` of one dimension), this
    process's ``device`` and, when the world holds more than this rank,
    ``ctrl``: a gloo group that carries the engine's host commands (NCCL
    moves no CPU tensors). ``axis_names`` and ``shape`` read as a JAX
    mesh's do. ``counts`` tallies the collectives issued: ``head_gathers``
    (one per attention block of a prefill or decode step) and
    ``token_gathers`` (one per decode segment)."""

    def __init__(self, device_mesh, device: torch.device, ctrl=None,
                 owns_world: bool = False):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names or ())
        self.group = device_mesh.get_group(0)
        self.rank = device_mesh.get_local_rank(0)
        self.size = device_mesh.size()
        self.device = torch.device(device)
        self.ctrl = ctrl
        self._owns_world = owns_world
        self.counts = {"head_gathers": 0, "token_gathers": 0}

    @property
    def shape(self) -> dict:
        return {name: self.size for name in self.axis_names}

    def all_gather_heads(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Every rank's head slice of ``x`` (heads on ``axis``) gathered
        into the global head order on that axis."""
        xs = x.movedim(axis, 0).contiguous()
        out = torch.empty((self.size * xs.shape[0],) + tuple(xs.shape[1:]),
                          dtype=xs.dtype, device=xs.device)
        _all_gather(out, xs, self.group)
        self.counts["head_gathers"] += 1
        return out.movedim(0, axis)

    def agree(self, tokens: torch.Tensor) -> bool:
        """All-gather every rank's ``tokens`` and say whether they are all
        equal to this rank's (each rank reads the same answer)."""
        t = tokens.contiguous()[None]
        out = torch.empty((self.size,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        _all_gather(out, t, self.group)
        self.counts["token_gathers"] += 1
        return bool((out == t).all())

    def close(self) -> None:
        """Destroy the command group and, when ``make_serve_mesh`` started
        the world itself, the world's default group."""
        if self.ctrl is not None:
            dist.destroy_process_group(self.ctrl)
            self.ctrl = None
        if self._owns_world and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_world = False
        if _MESH is self:
            set_mesh(None)


def set_mesh(mesh: Optional[ServeMesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> ServeMesh:
    if _MESH is None:
        raise RuntimeError("no mesh installed — launcher must call set_mesh()")
    return _MESH


@contextlib.contextmanager
def serving(mesh: Optional[ServeMesh]):
    """Run the block under ``mesh`` on this thread (None: unsharded)."""
    prev = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev


def active_mesh() -> Optional[ServeMesh]:
    """The mesh the model body on this thread runs under, else None."""
    return getattr(_ACTIVE, "mesh", None)
