"""Where a training tree's leaves live on a training mesh.

A training leaf's placement is a ``PartitionSpec``: for each dim of the
leaf, the mesh axis it splits over ("data" or "model") or None, as the
JAX package's ``PartitionSpec`` reads (``launch.shardings.
train_param_specs`` / ``train_state_specs`` build the trees). Every leaf
is replicated across "pod". ``named(mesh, specs)`` pairs each spec with
its mesh and the leaf's path (``NamedPlacement``, the counterpart of the
JAX package's ``NamedSharding``); ``place`` and ``gather_tree`` move a
tree between its full and its local form under such a tree, and
``BatchRows`` is a batch leaf's placement, this rank's rows of each
microbatch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.optimizer import _is_namedtuple, tree_map

#: the mesh axes a training leaf may split over, in the order ``local``
#: cuts them (``full`` gathers in the reverse order)
SPLIT_AXES = ("data", "model")


class PartitionSpec(tuple):
    """Per dim of a leaf, the mesh axis it splits over, or None (a dim past
    the spec's length is whole). A tuple that the tree utilities take for a
    leaf: ``PartitionSpec("data", "model")`` is the JAX package's
    ``P("data", "model")``."""

    def __new__(cls, *dims):
        for d in dims:
            if d is not None and d not in SPLIT_AXES:
                raise ValueError(f"a training leaf splits over {SPLIT_AXES}, "
                                 f"not {d!r}")
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)

    def dim(self, axis: str) -> Optional[int]:
        """The dim split over ``axis``, or None."""
        return self.index(axis) if axis in self else None


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
        return self.mesh.shape.get(axis, 1) if axis in self.spec else 1

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
        ``shape`` (the full leaf's) does not divide its axis."""
        for axis in SPLIT_AXES:
            d = self.dim(axis)
            if d is None:
                continue
            if d >= len(shape):
                raise ValueError(f"{self.name}: {self.spec} places a leaf of "
                                 f"{len(shape)} dims")
            n = self.mesh.shape.get(axis, 1)
            if shape[d] % n:
                raise ValueError(f"{self.name}: dim {d} of {tuple(shape)} "
                                 f"does not split {n} ways over {axis!r}")

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full leaf (the leaf itself when it is
        whole on every rank; a contiguous copy otherwise)."""
        if not any(a in self.spec for a in SPLIT_AXES):
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
            if d is not None:
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
