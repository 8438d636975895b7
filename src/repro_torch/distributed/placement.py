"""Where a training or serving tree's leaves live on a training mesh.

A leaf's placement is a ``PartitionSpec``: for each dim of the leaf, the
mesh axis it splits over ("data" or "model"), a tuple of axes it splits
over in row-major order (a cache's batch over ("pod", "data"), its rows
over every axis), or None, as the JAX package's ``PartitionSpec`` reads
(``launch.shardings.train_param_specs`` / ``train_state_specs`` /
``cache_specs`` build the trees). An axis a spec does not name holds the
leaf whole. ``named(mesh, specs)`` pairs each spec with its mesh and the
leaf's path (``NamedPlacement``, the counterpart of the JAX package's
``NamedSharding``); ``place`` and ``gather_tree`` move a tree between its
full and its local form under such a tree, and ``BatchRows`` is a batch
leaf's placement, this rank's rows of each microbatch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.optimizer import _is_namedtuple, tree_map

#: the mesh axes a leaf may split over, in the order ``local`` cuts them
#: (``full`` gathers in the reverse order); a dim split over several names
#: them in this order, so that its slices are row-major over them
SPLIT_AXES = ("pod", "data", "model")


def _entry_axes(entry) -> tuple:
    """The axes one dim of a spec splits over: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class PartitionSpec(tuple):
    """Per dim of a leaf, the mesh axis (or tuple of axes) it splits over,
    or None (a dim past the spec's length is whole). A tuple that the tree
    utilities take for a leaf: ``PartitionSpec("data", "model")`` is the
    JAX package's ``P("data", "model")``, ``PartitionSpec(("data",))`` its
    ``P(("data",))``."""

    def __new__(cls, *dims):
        named = [a for d in dims for a in _entry_axes(d)]
        for d in dims:
            axes = _entry_axes(d)
            if any(a not in SPLIT_AXES for a in axes) or \
                    list(axes) != sorted(axes, key=SPLIT_AXES.index):
                raise ValueError(f"a leaf splits over axes of {SPLIT_AXES} "
                                 f"in that order, not {d!r}")
        if len(set(named)) != len(named):
            raise ValueError(f"a spec names an axis twice: {dims!r}")
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)

    def dim(self, axis: str) -> Optional[int]:
        """The dim split over ``axis`` (alone or among others), or None."""
        for i, d in enumerate(self):
            if axis in _entry_axes(d):
                return i
        return None

    def axes(self) -> tuple:
        """Every axis the spec splits over."""
        return tuple(a for d in self for a in _entry_axes(d))


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedPlacement:
    """A leaf's placement on a training mesh: its ``spec``, and ``name``
    (its path in the tree) for the errors."""
    mesh: object
    spec: PartitionSpec
    name: str = ""

    def dim(self, axis: str) -> Optional[int]:
        """The leaf's dim split over ``axis`` (whatever the axis's size),
        or None."""
        return self.spec.dim(axis)

    def over(self, axis: str) -> int:
        """How many slices the leaf has along ``axis`` (1: whole)."""
        return self.mesh.shape.get(axis, 1) if axis in self.spec.axes() \
            else 1

    @property
    def shards(self) -> int:
        """How many ranks hold distinct slices of the leaf (1: whole)."""
        n = 1
        for axis in SPLIT_AXES:
            n *= self.over(axis)
        return n

    def fsdp(self) -> bool:
        """Whether the leaf is cut over "data" into more than one slice."""
        return self.over("data") > 1

    def check(self, shape) -> None:
        """Raise ``ValueError`` naming the leaf when a split dim of
        ``shape`` (the full leaf's) does not divide its axes."""
        for d, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            if not axes:
                continue
            if d >= len(shape):
                raise ValueError(f"{self.name}: {self.spec} places a leaf of "
                                 f"{len(shape)} dims")
            n = 1
            for axis in axes:
                n *= self.mesh.shape.get(axis, 1)
            if shape[d] % n:
                raise ValueError(f"{self.name}: dim {d} of {tuple(shape)} "
                                 f"does not split {n} ways over {entry!r}")

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full leaf (the leaf itself when it is
        whole on every rank; a contiguous copy otherwise)."""
        if not self.spec.axes():
            return full
        self.check(full.shape)
        t = full
        for axis in SPLIT_AXES:
            d = self.dim(axis)
            if d is not None:
                n = self.mesh.shape.get(axis, 1)
                size = t.shape[d] // n
                t = t.narrow(d, self.mesh.coords.get(axis, 0) * size, size)
        return t.clone(memory_format=torch.contiguous_format)

    def sum_over_shards(self, t: torch.Tensor):
        """-> (``t`` summed over the ranks holding the leaf's other slices,
        their count): a per-leaf statistic of the whole leaf."""
        for axis in SPLIT_AXES:
            if self.over(axis) > 1:
                self.mesh.all_reduce(t, axis, count="count_reduces")
        return t, self.shards

    def full(self, local: torch.Tensor) -> torch.Tensor:
        """The full leaf from every rank's slice (a collective over each
        axis the leaf splits over, on more than one rank)."""
        t = local
        for axis in reversed(SPLIT_AXES):
            d = self.dim(axis)
            if d is not None and self.over(axis) > 1:
                t = self.mesh.all_gather(t.contiguous(), axis, d)
        return t


def named(mesh, spec_tree, _path: str = ""):
    """The spec tree with each spec paired with ``mesh`` and its leaf's
    path."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v, f"{_path}/{k}" if _path else k)
                for k, v in spec_tree.items()}
    if _is_namedtuple(spec_tree):
        return type(spec_tree)(*(
            named(mesh, v, f"{_path}/{f}" if _path else f)
            for f, v in zip(spec_tree._fields, spec_tree)))
    if spec_tree is None:
        return None
    return NamedPlacement(mesh, spec_tree, _path)


def place(tree, shardings):
    """This rank's slice of every leaf of a full ``tree`` (``shardings``:
    its structure, a placement for every leaf). A split that does not
    divide its axis raises ``ValueError`` naming the leaf."""
    return tree_map(lambda t, sh: sh.local(t), tree, shardings)


def gather_tree(tree, shardings):
    """The full leaves of a placed ``tree``: every split leaf gathered over
    the axes it splits over (every rank must call it alike)."""
    return tree_map(lambda t, sh: sh.full(t), tree, shardings)


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """This rank's rows of a global batch leaf: its slice over the batch
    ``axes`` of every one of ``microbatches`` consecutive row blocks (the
    JAX package shards each microbatch over the batch axes, so rank r's
    rows of microbatch i are the r-th slice of global microbatch i)."""
    mesh: object
    axes: tuple

    def take(self, x: torch.Tensor, microbatches: int = 1) -> torch.Tensor:
        n = self.mesh.size_of(self.axes)
        if n == 1:
            return x
        rows = x.shape[0] // microbatches
        if x.shape[0] % microbatches or rows % n:
            raise ValueError(f"a batch of {x.shape[0]} rows in "
                             f"{microbatches} microbatches does not split "
                             f"over {n} batch shards")
        per, r = rows // n, self.mesh.index(self.axes)
        mbs = x.reshape(microbatches, rows, *x.shape[1:])
        return mbs[:, r * per:(r + 1) * per].reshape(
            microbatches * per, *x.shape[1:])
