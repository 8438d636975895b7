"""Where a training tree's leaves live on a training mesh.

``named(mesh, specs)`` pairs each placement of a spec tree
(``launch.shardings.train_param_specs`` / ``train_state_specs``) with its
mesh (``NamedPlacement``, the counterpart of the JAX package's
``NamedSharding``); ``place`` and ``gather_tree`` move a tree between its
full and its local form under such a tree, and ``BatchRows`` is a batch
leaf's placement, this rank's rows of each microbatch.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import Shard

from repro_torch.core.optimizer import tree_map


@dataclasses.dataclass(frozen=True)
class NamedPlacement:
    """A leaf's placement on a training mesh: ``spec`` (``Shard(dim)`` or
    ``Replicate()``) along its "model" axis; every leaf is replicated
    across the batch axes."""
    mesh: object
    spec: object

    @property
    def shards(self) -> int:
        """How many "model" ranks hold a slice of the leaf (1: whole)."""
        return self.mesh.shape["model"] if isinstance(self.spec, Shard) \
            else 1

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full leaf (the leaf itself when it is
        replicated)."""
        if not isinstance(self.spec, Shard):
            return full
        return _slice(full, self.spec.dim, self.mesh.coords["model"],
                      self.mesh.shape["model"])

    def sum_over_shards(self, t: torch.Tensor):
        """-> (``t`` summed over the ranks holding the leaf's other slices,
        their count): a per-leaf statistic of the whole leaf."""
        if not isinstance(self.spec, Shard):
            return t, 1
        self.mesh.all_reduce(t, "model", count="count_reduces")
        return t, self.mesh.shape["model"]

    def full(self, local: torch.Tensor) -> torch.Tensor:
        """The full leaf from every "model" rank's slice (a collective for
        a sharded leaf on more than one rank)."""
        if not isinstance(self.spec, Shard):
            return local
        return self.mesh.all_gather(local.contiguous(), "model",
                                    self.spec.dim)


def named(mesh, spec_tree):
    """The spec tree with each placement paired with ``mesh``."""
    return tree_map(lambda sp: NamedPlacement(mesh, sp), spec_tree)


def place(tree, shardings):
    """This rank's slice of every leaf of a full ``tree`` (``shardings``:
    its structure, a placement for every leaf)."""
    return tree_map(lambda t, sh: sh.local(t), tree, shardings)


def gather_tree(tree, shardings):
    """The full leaves of a placed ``tree``: every sharded leaf gathered
    over "model" (every rank must call it alike)."""
    return tree_map(lambda t, sh: sh.full(t), tree, shardings)


def _slice(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"axis {dim} of {size} does not split {n} ways")
    return t.narrow(dim, rank * (size // n), size // n) \
        .clone(memory_format=torch.contiguous_format)


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
