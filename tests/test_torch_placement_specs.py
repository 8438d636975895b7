"""The port's training placement against the JAX package's specs, with no
world: ``launch.shardings.train_param_specs`` leaf for leaf against the
``lm_init`` specs of the JAX package for each of the ten archs at smoke
width (a ``PartitionSpec`` translated to its tuple of axis names, padded
with None to the leaf's dims), equal but for the two stated differences
(``launch.dryrun.STATED_DIFFERENCES``): k/v split over "model" where the
JAX package replicates them under 16 KV heads (equal under
``replicate_kv``, ``kv_replicated``'s answer for those meshes), and
``wo`` whole over "model" where the JAX package splits its rows; with
``boolean_fsdp=False`` every Boolean leaf whole over "data". On one
process, each rank's ``local`` slices tile the full leaf and ``full``
gathers them back (a stub mesh whose all-gather hands over the peers'
slices), an undivided split raises naming the leaf, and the PARAM and OPT
bytes the placement leaves rank 0 of gemma2-2b's 16 x 16 train mesh at
published widths (fake tensors) equal their formula. The serving cells'
cache placement (``launch.shardings.cache_specs``) against the JAX
package's ``cache_init`` specs for each arch and serving policy.
"""
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import lm_init as jax_lm_init
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.optimizer import hybrid_optimizer, tree_leaves, tree_map
from repro_torch.distributed.placement import P, NamedPlacement, named, place
from repro_torch.launch.dryrun import STATED_DIFFERENCES
from repro_torch.launch.shardings import (kv_replicated, train_param_specs,
                                          train_state_specs)
from repro_torch.models import lm_init


def _paths(tree, prefix=""):
    """{path: leaf} of a nested dict, sorted."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _padded(spec, nd):
    t = tuple(spec)
    return t + (None,) * (nd - len(t))


def _jax_specs(arch):
    params, specs = jax_lm_init(jax.random.PRNGKey(0),
                                jax_smoke(arch).scaled(dtype=jnp.float32))
    shapes = _paths(jax.tree.map(lambda x: x.shape, params))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[key] = _padded(spec, len(shapes[key]))
    return out


def _port_specs(arch, **kw):
    params = lm_init(get_smoke(arch).scaled(dtype=torch.float32),
                     torch.Generator().manual_seed(0))
    specs = train_param_specs(params, **kw)
    return {k: _padded(specs_k, params_k.dim()) for (k, specs_k), params_k
            in zip(_paths(specs).items(), _paths(params).values())}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_are_the_jax_packages_but_the_stated_differences(arch):
    want = _jax_specs(arch)
    got = _port_specs(arch)
    assert got.keys() == want.keys()
    differ = {k for k in want if got[k] != want[k]}
    cfg = get_smoke(arch)
    for k in differ:
        leaf = k.split("/")
        # 1: k/v (and their biases) split over "model" where the JAX
        # package replicates them: fewer than 16 KV heads
        if leaf[-2] in ("wk", "wv"):
            assert cfg.n_kv_heads < 16, k
            assert want[k][-1] is None and got[k][-1] == "model", k
            assert got[k][:-1] == want[k][:-1], k
        # 2: wo whole over "model" (the JAX package splits its rows), FSDP
        # over "data" alike
        else:
            assert leaf[-2:] == ["wo", "w"], k
            assert want[k] == (None, "model", "data"), k
            assert got[k] == (None, None, "data"), k
    attn = any("/attn/" in k for k in want)
    assert {k.split("/")[-2] for k in differ} == ({"wk", "wv", "wo"}
                                                  if attn else set())
    # under replicate_kv (a "model" axis wider than the KV heads) k/v are
    # the JAX package's specs exactly
    rep = _port_specs(arch, replicate_kv=True)
    assert {k for k in want if rep[k] != want[k]} == \
        {k for k in differ if "/wo/" in k}
    assert len(STATED_DIFFERENCES) == 2


@pytest.mark.parametrize("arch", ["gemma2-2b", "jamba-1.5-large-398b",
                                  "arctic-480b"])
def test_vote_placement_keeps_boolean_leaves_whole_over_data(arch):
    params = lm_init(get_smoke(arch).scaled(dtype=torch.float32),
                     torch.Generator().manual_seed(0))
    full = _paths(train_param_specs(params))
    vote = _paths(train_param_specs(params, boolean_fsdp=False))
    for (k, p), sp, sv in zip(_paths(params).items(), full.values(),
                              vote.values()):
        if p.dtype == torch.int8:
            assert tuple(sv) == tuple(None if a == "data" else a
                                      for a in sp), k
        else:
            assert sv == sp, k


class _Mesh:
    """A rank's view of a mesh without a world: its axis sizes and
    coordinates; ``all_gather`` hands over the peers' slices of ``full``
    along one axis (``world`` holds the full leaf and its spec, and the
    axes gathered so far)."""

    def __init__(self, shape, coords, world=None):
        self.shape, self.coords, self.world = shape, coords, world

    def all_gather(self, t, axis, dim, count=None):
        full, spec, done = self.world
        keep = P(*(None if a in done or a == axis else a for a in spec))
        cut = P(*(None if a in done else a for a in spec))
        peers = []
        for r in range(self.shape[axis]):
            peer = _Mesh(self.shape, dict(self.coords, **{axis: r}))
            peers.append(NamedPlacement(peer, cut, "x").local(full))
        done.add(axis)
        out = torch.cat(peers, dim)
        assert out.shape == NamedPlacement(self, keep, "x").local(full).shape
        return out


@pytest.mark.parametrize("spec", [P("data", "model"), P("model", "data"),
                                  P(None, "model", "data"), P("model"),
                                  P(None, "data"), P()])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 4)])
def test_local_slices_tile_the_leaf_and_full_gathers_them(spec, shape):
    full = torch.arange(8 * 8 * 8, dtype=torch.float32).reshape(8, 8, 8)
    sizes = dict(zip(("data", "model"), shape))
    for d in range(shape[0]):
        for m in range(shape[1]):
            coords = {"data": d, "model": m}
            pl = NamedPlacement(_Mesh(sizes, coords), spec, "x")
            loc = pl.local(full)
            assert loc.is_contiguous()
            # the slice at its place: each named dim cut in rank order
            idx = [slice(None)] * 3
            for dim, axis in enumerate(spec):
                if axis is not None:
                    n = 8 // sizes[axis]
                    idx[dim] = slice(coords[axis] * n, (coords[axis] + 1) * n)
            assert torch.equal(loc, full[tuple(idx)])
            mesh = _Mesh(sizes, coords, (full, spec, set()))
            back = NamedPlacement(mesh, spec, "x").full(loc)
            assert torch.equal(back, full)
    cut = [a for a in spec if a is not None]
    assert NamedPlacement(_Mesh(sizes, {"data": 0, "model": 0}), spec,
                          "x").shards == math.prod(sizes[a] for a in cut)


def test_an_undivided_split_raises_naming_the_leaf():
    mesh = _Mesh({"data": 3, "model": 2}, {"data": 0, "model": 0})
    tree = {"blocks": {"b0": {"w": torch.zeros(4, 6)}}}
    with pytest.raises(ValueError, match="blocks/b0/w"):
        place(tree, named(mesh, {"blocks": {"b0": {"w": P("data", "model")}}}))


def test_param_and_opt_bytes_of_a_rank_by_formula():
    """gemma2-2b at published widths on the 16 x 16 train mesh, rank 0:
    Boolean int8 weights cut over "data" and (but wo, k/v: its 4 KV heads
    under 16 ranks) over "model"; the bf16 embedding and head over both;
    fp32 norms whole, the FFN's tau over "model". The optimizer: a bf16
    accumulator per Boolean element and two fp32 scalars per Boolean leaf,
    two fp32 Adam moments per FP element, two int32 step counters."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config("gemma2-2b")
    dp = tp = 16
    mesh = _Mesh({"data": dp, "model": tp}, {"data": 0, "model": 0})
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = lm_init(cfg, torch.Generator().manual_seed(0))
        specs = train_param_specs(params,
                                  replicate_kv=kv_replicated(cfg, tp))
        local = place(params, named(mesh, specs))
        state = hybrid_optimizer(eta=1.0, fp_lr=1e-3).init(local)
    assert kv_replicated(cfg, tp)
    nbytes = lambda tree: sum(t.numel() * t.element_size()  # noqa: E731
                              for t in tree_leaves(tree))
    D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    q = cfg.heads_padded() * cfg.head_dim_
    kv = cfg.kv_heads_padded() * cfg.head_dim_
    bool_el = L * (D * q // (dp * tp) + 2 * D * kv // dp + q * D // dp
                   + 3 * D * F // (dp * tp))
    fp_el = {"bf16": 2 * cfg.vocab_padded * D // (dp * tp),
             "f32": L * (2 * D + F // tp) + D}
    param = bool_el + 2 * fp_el["bf16"] + 4 * fp_el["f32"]
    n_bool = 7 * 2          # Boolean leaves: 7 a block role, 2 roles
    opt = 2 * bool_el + 2 * 4 * n_bool \
        + 2 * 4 * (fp_el["bf16"] + fp_el["f32"]) + 2 * 4
    assert nbytes(local) == param
    assert nbytes(state) == opt
    # the state's placement mirrors the params' (scalars replicated)
    sp = train_state_specs(local, state, specs)
    assert tree_leaves(tree_map(tuple, sp["params"])) == \
        tree_leaves(tree_map(tuple, specs))
    assert param + opt < 2 ** 30, (param, opt)


class _Layout:
    """A production mesh's axis names and sizes (what ``apply_policy``
    reads), without a world."""

    def __init__(self, multi_pod):
        self.axis_names = ("pod", "data", "model") if multi_pod \
            else ("data", "model")
        self.shape = dict(zip(self.axis_names,
                              (2, 16, 16) if multi_pod else (16, 16)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_are_the_jax_packages(arch):
    """``cache_specs`` leaf for leaf against the JAX package's
    ``cache_init`` specs, under each serving cell's policy (prefill_32k,
    decode_32k, long_500k where it applies) on the single- and multi-pod
    meshes: the batch over the batch axes, the rows over the cache-seq
    axes, every KV head, the mamba state's d_inner over "model" (a rank's
    cache against its slice of the whole one under them:
    ``tests/test_torch_split_serve.py``)."""
    from repro.launch.shardings import apply_policy as jax_policy
    from repro.models import cache_init as jax_cache_init
    from repro_torch.launch.shapes import SHAPES, applicable
    from repro_torch.launch.shardings import apply_policy, cache_specs
    from repro_torch.models import cache_init

    n = 0
    for multi_pod in (False, True):
        lay = _Layout(multi_pod)
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            if not applicable(get_smoke(arch), SHAPES[shape]):
                continue
            cfg_j = jax_policy(jax_smoke(arch), SHAPES[shape], lay)
            cfg_t = apply_policy(get_smoke(arch), SHAPES[shape], lay)
            _, want = jax_cache_init(cfg_j, 2, 32)
            whole = cache_init(cfg_t.scaled(use_sharding_constraints=False),
                               2, 32, "meta")
            got = cache_specs(cfg_t, whole)
            flat = jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]
            assert len(flat) == len(tree_leaves(got))
            for path, spec in flat:
                node = got
                for k in path:
                    node = node[str(getattr(k, "key", k))]
                assert isinstance(node, P)
                assert tuple(node) == tuple(spec), (shape, path, node, spec)
                n += 1
    assert n > 0


@pytest.mark.parametrize("spec,dim", [(P(("data", "model")), 0),
                                      (P(None, ("data", "model")), 1),
                                      (P(None, None, ("pod", "data")), 2)])
def test_a_dim_split_over_several_axes_is_row_major(spec, dim):
    """A dim split over a tuple of axes (a cache's batch over ("pod",
    "data"), long_500k's rows over every axis): rank (p, d, m)'s slice is
    block ``index`` of the dim, ``index`` its row-major index over the
    tuple's axes; axes out of the mesh's order or named twice are
    refused."""
    full = torch.arange(8 * 8 * 8, dtype=torch.float32).reshape(8, 8, 8)
    sizes = {"pod": 2, "data": 2, "model": 2}
    axes = spec[dim]
    for p in range(2):
        for d in range(2):
            for m in range(2):
                coords = {"pod": p, "data": d, "model": m}
                pl = NamedPlacement(_Mesh(sizes, coords), spec, "x")
                idx = 0
                for a in axes:
                    idx = idx * sizes[a] + coords[a]
                want = full.narrow(dim, idx * 2, 2)
                assert torch.equal(pl.local(full), want)
                assert pl.shards == 4
    with pytest.raises(ValueError):
        P(("model", "data"))
    with pytest.raises(ValueError):
        P("data", ("data", "model"))
