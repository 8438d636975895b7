"""The serve and training meshes over ``torch.distributed``, and the
process-wide mesh context.

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

``TrainMesh`` is the JAX package's ("data", "model") training mesh (with
a leading "pod" axis on the production mesh), one process a device: the
process groups of its axes and of the tuples of axes the model reaches
(the batch axes, the cache-seq axes), this rank's coordinates, and the
collectives the training path issues. A group of one issues none. Its
two autograd functions are those head-parallel training needs, as in
Megatron-LM: ``gather_heads`` (all-gather forward, this rank's slice
backward; ``torch.distributed.nn``'s gather reduce-scatters in the
backward, which would multiply a replicated downstream grad by the
shard count), and, for the input of a column-sharded projection, the
grad sum over the group (``models.modules.copy_to_group`` and
``core.boolean_dense``'s ``group``). The reference's training placement
adds three: ``fsdp_gather`` (one flat all-gather over "data" of a layer
group's weight slices; the backward reduce-scatters their grads),
``reduce_from_group`` (a row-split projection's partial sums over
"model"; the identity backward) and ``vocab_embed`` (the vocab-parallel
lookup). ``counts`` names each kind, so the dry run's record does.

The JAX package places its prefill and decode steps as it places
training, and so does the port (``models.lm.lm_prefill`` /
``lm_decode_step(shardings=)``): ``fsdp_gather`` without a grad (one
flat all-gather a layer group, no autograd function, no reduce-scatter),
``all_to_all`` over "model" where a prefill trades its KV heads for its
slab of cache rows, the gather of the logits' vocab shards and, in a
decode whose one routing group spans the batch ranks, of the tokens'
expert choices (``models.moe``).
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading
from typing import Optional, Tuple

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


class TrainMesh:
    """An N-D training mesh: ``device_mesh`` (a ``DeviceMesh`` whose dims
    are named ``axis_names``, e.g. ("data", "model")) and this process's
    ``device``. ``shape`` maps each axis to its size and ``coords`` to this
    rank's index on it, as a JAX mesh's ``shape`` and ``axis_index`` do.
    ``group(axes)`` is the process group of the ranks that share this
    rank's coordinates off ``axes``; ``index(axes)`` this rank's row-major
    index over ``axes``. ``counts`` tallies the collectives issued."""

    def __init__(self, device_mesh, device: torch.device,
                 owns_world: bool = False):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names,
                              (int(n) for n in device_mesh.mesh.shape)))
        coords = device_mesh.get_coordinate()
        self.coords = dict(zip(self.axis_names, coords))
        self.size = device_mesh.size()
        self.device = torch.device(device)
        self._owns_world = owns_world
        self._groups = {(a,): device_mesh.get_group(a)
                        for a in self.axis_names}
        self._groups[self.axis_names] = dist.group.WORLD
        batch = tuple(a for a in self.axis_names if a in ("pod", "data"))
        if len(batch) > 1 and batch not in self._groups:
            self._groups[batch] = self._subgroup(batch)
        # the training step's kinds; a serving step's own ("vocab_gathers",
        # "route_gathers", "cache_exchanges") appear at their first call
        self.counts = collections.Counter(dict.fromkeys((
            "grad_reduces", "head_gathers", "seq_combines", "vote_reduces",
            "count_reduces", "leaf_gathers", "fsdp_gathers", "fsdp_scatters",
            "model_sums", "vocab_reduces", "expert_gathers"), 0))

    def _subgroup(self, axes: Tuple[str, ...]):
        """The group over ``axes`` (every rank calls this alike): the ranks
        of the mesh with ``axes`` moved last, one group a row."""
        ranks = self.device_mesh.mesh
        dims = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(ranks.dim()) if i not in dims]
        rows = ranks.permute(*rest, *dims).reshape(-1, self.size_of(axes))
        group, _ = dist.new_subgroups_by_enumeration(rows.tolist())
        return group

    def size_of(self, axes) -> int:
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        axes = _axes(axes)
        if axes not in self._groups:
            raise ValueError(f"no process group over {axes} on a mesh of "
                             f"{self.axis_names}")
        return self._groups[axes]

    def all_reduce(self, t: torch.Tensor, axes, op=dist.ReduceOp.SUM,
                   count: str = "grad_reduces") -> torch.Tensor:
        """``t`` reduced in place over ``axes`` (no collective on a group
        of one); returns ``t``."""
        if self.size_of(axes) > 1:
            dist.all_reduce(t, op=op, group=self.group(axes))
            self.counts[count] += 1
        return t

    def all_gather(self, t: torch.Tensor, axes, dim: int,
                   count: str = "leaf_gathers") -> torch.Tensor:
        """Every rank of ``axes``'s ``t`` concatenated on ``dim`` in rank
        order (``t`` itself on a group of one)."""
        n = self.size_of(axes)
        if n == 1:
            return t
        xs = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * xs.shape[0],) + tuple(xs.shape[1:]),
                          dtype=xs.dtype, device=xs.device)
        _all_gather(out, xs, self.group(axes))
        self.counts[count] += 1
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int = 0,
                       count: str = "fsdp_scatters") -> torch.Tensor:
        """``t`` summed over the ranks of ``axes`` and cut on ``dim`` into
        as many blocks: this rank's block, in rank order (``t`` itself on a
        group of one)."""
        n = self.size_of(axes)
        if n == 1:
            return t
        xs = t.movedim(dim, 0).contiguous()
        if xs.shape[0] % n:
            raise ValueError(f"reduce_scatter: {xs.shape[0]} rows do not "
                             f"split over {n} ranks")
        out = torch.empty((xs.shape[0] // n,) + tuple(xs.shape[1:]),
                          dtype=xs.dtype, device=xs.device)
        fn = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        fn(out, xs, group=self.group(axes))
        self.counts[count] += 1
        return out.movedim(0, dim)

    def all_to_all(self, t: torch.Tensor, axes,
                   count: str = "cache_exchanges") -> torch.Tensor:
        """``t``'s dim 0 holds one block for each rank of ``axes``, in rank
        order: block r goes to rank r, and the result's block r is the one
        rank r sent here (``t`` itself on a group of one)."""
        n = self.size_of(axes)
        if n == 1:
            return t
        if t.shape[0] != n:
            raise ValueError(f"all_to_all: {t.shape[0]} blocks for {n} "
                             "ranks")
        x = t.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group(axes))
        self.counts[count] += 1
        return out

    def close(self) -> None:
        """Let go of the mesh's process groups, and destroy the world when
        ``make_local_mesh`` started it, every rank together. A group object
        still held once its world is destroyed is torn down only at the
        interpreter's exit, where the backend's threads can abort the
        process."""
        self._groups.clear()
        self.device_mesh = None
        if _MESH is self:
            set_mesh(None)
        if self._owns_world and dist.is_initialized():
            if dist.get_world_size() > 1:
                dist.barrier()
            dist.destroy_process_group()
        self._owns_world = False


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, count):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, "model", dim, count=count)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.coords["model"]
        return (g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None,
                None)


def gather_heads(x: torch.Tensor, mesh: TrainMesh, dim: int,
                 count: str = "head_gathers") -> torch.Tensor:
    """Every "model" rank's head slice of ``x`` (heads on ``dim``; or any
    slice the ranks hold in rank order: the experts, the router's columns)
    gathered in the global order; the backward takes this rank's slice of
    the grad, which every rank holds whole."""
    if mesh.size_of("model") == 1:
        return x
    return _GatherHeads.apply(x, mesh, dim, count)


def _gather_flat(mesh: TrainMesh, shards, dims, dtype) -> tuple:
    """The full leaves of the "data" slices ``shards`` (each cut on its
    dim of ``dims``), gathered in one flat all-gather over "data" at
    ``dtype``."""
    n = mesh.size_of("data")
    flat = torch.cat([s.to(dtype).reshape(-1) for s in shards])
    rows = mesh.all_gather(flat, "data", 0, count="fsdp_gathers").view(n, -1)
    fulls, off = [], 0
    for s, d in zip(shards, dims):
        shape = tuple(s.shape)
        k = math.prod(shape)
        # rank r's slice is block r of dim d
        pieces = rows[:, off:off + k].reshape(n, *shape).movedim(0, d)
        fulls.append(pieces.reshape(*shape[:d], n * shape[d],
                                    *shape[d + 1:]).contiguous())
        off += k
    return tuple(fulls)


class _FsdpGather(torch.autograd.Function):
    """One flat all-gather over "data" of several leaves' slices (each cut
    on its own dim), and in the backward one flat reduce-scatter of their
    grads, as FSDP's flat parameter does."""

    @staticmethod
    def forward(ctx, mesh, dims, dtype, grad_dtype, *shards):
        ctx.mesh, ctx.dims, ctx.grad_dtype = mesh, dims, grad_dtype
        ctx.shapes = [tuple(s.shape) for s in shards]
        return _gather_flat(mesh, shards, dims, dtype)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.mesh.size_of("data")
        parts = []
        for g, shape, d in zip(grads, ctx.shapes, ctx.dims):
            blocks = g.to(ctx.grad_dtype).reshape(
                *shape[:d], n, shape[d], *shape[d + 1:]).movedim(d, 0)
            parts.append(blocks.reshape(n, -1))
        mine = ctx.mesh.reduce_scatter(torch.cat(parts, 1).reshape(-1),
                                       "data", 0, count="fsdp_scatters")
        out, off = [], 0
        for shape in ctx.shapes:
            k = math.prod(shape)
            out.append(mine[off:off + k].view(shape))
            off += k
        return (None, None, None, None, *out)


def fsdp_gather(mesh: TrainMesh, shards, dims, dtype=None,
                grad_dtype=torch.float32) -> list:
    """The full leaves of this rank's "data" slices ``shards`` (``dims``:
    the dim each is cut on), gathered in one all-gather over "data" at
    ``dtype`` (None: the slices' own, which must be one). The backward
    reduce-scatters their grads over "data" in one call, summed at
    ``grad_dtype``: each rank gets its slice of the sum of every data
    rank's grad. ``grad_dtype=None`` is the serving steps' form: the
    gather alone, no autograd function and so no reduce-scatter."""
    if not shards:
        return []
    if dtype is None:
        dtypes = {s.dtype for s in shards}
        if len(dtypes) != 1:
            raise ValueError(f"fsdp_gather: slices of {sorted(map(str, dtypes))}"
                             " in one gather need a dtype")
        dtype = dtypes.pop()
    if grad_dtype is None:
        return list(_gather_flat(mesh, shards, tuple(dims), dtype))
    return list(_FsdpGather.apply(mesh, tuple(dims), dtype, grad_dtype,
                                  *shards))


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, count):
        out = x.contiguous().clone()
        mesh.all_reduce(out, axis, count=count)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def reduce_from_group(x: torch.Tensor, mesh: TrainMesh, axis: str = "model",
                      count: str = "model_sums") -> torch.Tensor:
    """``x`` summed over the ranks of ``axis`` (each holds a partial sum:
    a row-split projection's output); the backward is the identity, since
    every rank holds the whole grad of the sum (Megatron-LM's reduce from
    the region)."""
    if mesh.size_of(axis) == 1:
        return x
    return _ReduceFromGroup.apply(x, mesh, axis, count)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                mesh: TrainMesh) -> torch.Tensor:
    """A vocab-parallel embedding lookup: ``table`` holds this "model"
    rank's rows of the vocab (rank r the rows [r·V, (r+1)·V)); each rank
    looks up the tokens it owns, zeros elsewhere, and the rows are summed
    over "model". The sum is exact: one term is non-zero."""
    vl = table.shape[0]
    idx = tokens.long() - mesh.coords["model"] * vl
    mine = (idx >= 0) & (idx < vl)
    rows = table[idx.clamp(0, vl - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return reduce_from_group(rows, mesh, "model")


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
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
