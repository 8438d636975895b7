"""The port's tensor-parallel serving against the JAX package's
``tests/test_mesh_serve.py``: the host-only cases, in this process.

Serve-mesh construction and its refusals (more shards than the world's
processes or the visible cards), the engine's divisibility and axis
checks, the prefix cache, host swap tier and contiguous ``generate``
refused as the JAX engine refuses them, the spec trees of
``launch.shardings`` against the JAX package's ``serve_param_specs`` /
``serve_pool_specs`` leaf for leaf, ``pack_weights(tp=)``'s shard-major
words bit for bit against the JAX package's, and ``placement()``. A mesh
here is a one-rank gloo world this process starts and destroys
(``make_serve_mesh(1, "cpu")``); the worlds of 1, 2 and 4 processes run in
``test_torch_mesh_parity.py`` and ``test_torch_mesh_overload.py`` through
``run_world``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_smoke as jax_smoke
from repro.launch.shardings import serve_param_specs as jax_param_specs
from repro.launch.shardings import serve_pool_specs as jax_pool_specs
from repro.models import lm_init as jax_lm_init
from repro.serve.engine import pack_weights as jax_pack_weights
from repro.serve.paged_cache import paged_pool_init as jax_pool_init
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core import PackedBool
from repro_torch.distributed import ServeMesh
from repro_torch.launch import mesh as M
from repro_torch.launch.shardings import (serve_param_specs, serve_pool_specs,
                                          shard_tree)
from repro_torch.models import lm_init
from repro_torch.serve import ServeEngine, pack_weights, paged_pool_init

ROOT = Path(__file__).resolve().parents[1]

# run before every world script: join the world, build its serve mesh, and
# ``served(engine, body)``: rank 0 runs body(engine) and closes the engine,
# the other ranks follow its calls (serve_worker.run)
_PREAMBLE = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.distributed import serve_worker
from repro_torch.launch.mesh import init_serve_world, make_serve_mesh
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
init_serve_world(RANK, WORLD, sys.argv[3], "cpu")
MESH = make_serve_mesh(WORLD, "cpu")


def served(engine, body):
    if RANK == 0:
        try:
            return body(engine)
        finally:
            engine.close()
    serve_worker.run(engine)


def load_params(path):
    from repro_torch import bridge
    flat = np.load(path)
    tree = {}
    for key in flat.files:
        *head, leaf = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = flat[key]
    return bridge.params_from_numpy(tree, "cpu")
"""


def save_params(params_np, path) -> str:
    """A numpy parameter tree as one .npz of "/"-joined keys
    (``load_params`` in a world script reads it back)."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(params_np, "")
    np.savez(path, **flat)
    return str(path)


def run_world(n: int, script: str, tmp_path, *args: str,
              timeout: float = 150) -> str:
    """Run ``script`` (after ``_PREAMBLE``) as a gloo world of ``n``
    processes over a ``file://`` store under ``tmp_path``, ``args`` from
    ``sys.argv[4]`` on; every rank must exit 0. Returns rank 0's stdout."""
    src = tmp_path / f"world{n}.py"
    src.write_text(_PREAMBLE + textwrap.dedent(script)
                   + "\nMESH.close()\n")
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


@pytest.fixture
def one_rank():
    """A one-rank gloo world and its serve mesh, destroyed after the test."""
    mesh = M.make_serve_mesh(1, "cpu")
    try:
        yield mesh
    finally:
        mesh.close()
    assert not dist.is_initialized()


def _cfg(arch="gemma2-2b", **kw):
    return get_smoke(arch).scaled(dtype=torch.float32, **kw)


def _jax_params(arch, **kw):
    cfg = jax_smoke(arch).scaled(dtype=jnp.float32, **kw)
    params, _ = jax_lm_init(jax.random.PRNGKey(0), cfg)
    return cfg, params


# ---------------------------------------------------------------------------
# the mesh and the engine's checks
# ---------------------------------------------------------------------------
def test_make_serve_mesh_rejects_oversubscription(monkeypatch):
    """This process is a world of one: two shards are refused before any
    group starts; one shard builds the 1-D ("model",) mesh. On CUDA more
    shards than cards are refused (NCCL: one card a rank)."""
    with pytest.raises(ValueError, match="devices"):
        M.make_serve_mesh(2, "cpu")
    assert not dist.is_initialized()
    mesh = M.make_serve_mesh(1, "cpu")
    try:
        assert mesh.axis_names == ("model",) and mesh.shape["model"] == 1
        assert mesh.rank == 0 and mesh.size == 1 and mesh.ctrl is None
        assert M.mesh_num_chips(mesh) == 1 and M.mesh_batch_axes(mesh) == ()
        with pytest.raises(ValueError, match="devices"):
            M.make_serve_mesh(2, "cpu")         # the world holds one rank
    finally:
        mesh.close()
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 CUDA devices"):
        M.check_serve_world(2, "cuda", 2)
    M.check_serve_world(1, "cuda", 1)


def test_engine_rejects_indivisible_heads_and_other_axes(one_rank):
    """kvp = 2 cannot split 3 ways: the engine says so at construction (its
    validator, driven directly as the JAX test drives it); a mesh whose
    axis is not "model" is refused before anything is placed."""
    cfg = _cfg()
    params = lm_init(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, max_len=16, device="cpu")
    eng.tp = 3
    with pytest.raises(ValueError, match="n_kv_heads"):
        eng._validate_tp(cfg)
    eng.tp = 2
    eng._validate_tp(cfg)
    eng._validate_tp(_cfg("falcon-mamba-7b"))      # pure SSM: replicated
    bad = ServeMesh(init_device_mesh("cpu", (1,), mesh_dim_names=("data",)),
                    "cpu")
    with pytest.raises(ValueError, match="model"):
        ServeEngine(cfg, params, max_len=16, device="cpu", mesh=bad)
    with pytest.raises(ValueError, match="serve mesh is on cpu"):
        ServeEngine(cfg, params, max_len=16, device="cuda", mesh=one_rank)


def test_mesh_refuses_prefix_cache_and_host_swap(one_rank):
    """As the JAX mesh engine: the prefix cache (at construction and per
    session) and the host swap tier are refused under a mesh; a mesh of
    one still serves ``generate`` (only more shards refuse it:
    test_torch_mesh_overload.py), bitwise as the unsharded engine."""
    cfg = _cfg()
    params = lm_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="prefix_cache"):
        ServeEngine(cfg, params, max_len=16, device="cpu", mesh=one_rank,
                    prefix_cache=True)
    eng = ServeEngine(cfg, params, max_len=16, device="cpu", mesh=one_rank)
    with pytest.raises(NotImplementedError, match="prefix_cache"):
        eng.session(prefix_cache=True)
    with pytest.raises(NotImplementedError, match="host_page_budget"):
        eng.session(host_page_budget=8)
    prompts = np.arange(10, dtype=np.int32).reshape(2, 5) % cfg.vocab_size
    ref = ServeEngine(cfg, params, max_len=16, device="cpu")
    assert torch.equal(eng.generate(prompts, 4), ref.generate(prompts, 4))
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.init_pool(4, 4, 1)


def test_session_placement_and_mesh_stats(one_rank):
    """TP shards heads, not lanes: every lane is on shard group 0.
    ``stats()["mesh"]`` is None on one device and the mesh's health
    under one."""
    cfg = _cfg()
    params = lm_init(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, max_len=16, device="cpu")
    with eng.session(lanes=3, page_size=4) as sess:
        assert sess.placement() == {0: 0, 1: 0, 2: 0}
        assert sess.stats()["mesh"] is None
    eng = ServeEngine(cfg, params, max_len=16, device="cpu", mesh=one_rank)
    with eng.session(lanes=2, page_size=4) as sess:
        assert sess.placement() == {0: 0, 1: 0}
        assert sess.stats()["mesh"] == {"shards": 1, "shard_loss_events": 0,
                                        "lost": [], "healthy": True}
    eng.close()


# ---------------------------------------------------------------------------
# the spec trees and the shard-major packing, against the JAX package
# ---------------------------------------------------------------------------
def _placement(spec: P):
    """The port's placement for a JAX PartitionSpec."""
    axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    return Shard(axes[0]) if axes else Replicate()


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (k,))
    else:
        yield path, tree


def _jax_spec_leaves(specs):
    """{dict-key path: PartitionSpec}; a replicated PackedBool's spec is a
    node over its fields, keyed by its leaf's path."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {tuple(k.key for k in path if isinstance(k.key, str)): sp
            for path, sp in flat}


@pytest.mark.parametrize("packed", [False, True])
def test_param_specs_shard_the_jax_packages_leaves(packed):
    """jamba's attention, mamba and MoE blocks: the same leaves shard on the
    same axes as under the JAX package's ``serve_param_specs`` (only q/k/v
    or wqkv weights, on their output axis; wo replicated), packed at tp 2
    too."""
    cfg_j, params_j = _jax_params("jamba-1.5-large-398b")
    tree = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    if packed:
        params_j = jax_pack_weights(params_j, tp=2)
        tree = pack_weights(tree, tp=2)
    want = _jax_spec_leaves(jax_param_specs(params_j))
    got = dict(_spec_leaves(serve_param_specs(tree)))
    assert set(got) == set(want)
    sharded = set()
    for path, placement in got.items():
        assert placement == _placement(want[path]), path
        if isinstance(placement, Shard):
            sharded.add(path)
    assert sharded and all(p[-2] in ("wq", "wk", "wv", "wqkv")
                           for p in sharded), sharded


@pytest.mark.parametrize("quant", [False, True])
def test_pool_specs_shard_kv_heads_like_the_jax_package(quant):
    """Attention pool leaves (scales too under kv-quant) shard on KVp, the
    mamba state is replicated; a pool's local slice is its KVp slice."""
    cfg_j, _ = _jax_params("jamba-1.5-large-398b", kv_cache_quant=quant)
    cfg = _cfg("jamba-1.5-large-398b", kv_cache_quant=quant)
    want = _jax_spec_leaves(jax_pool_specs(
        cfg_j, jax_pool_init(cfg_j, lanes=1, n_pages=2, page_size=1)))
    pool = paged_pool_init(cfg, 2, 1, "cpu", lanes=1)
    got = dict(_spec_leaves(serve_pool_specs(cfg, pool)))
    assert set(got) == set(want)
    for path, placement in got.items():
        assert placement == _placement(want[path]), path
    blk = next(b for b in pool if "k" in pool[b])
    pool[blk]["k"].copy_(torch.randn(pool[blk]["k"].shape))
    local = shard_tree(pool, serve_pool_specs(cfg, pool), 1, 2)
    assert torch.equal(local[blk]["k"], pool[blk]["k"][:, :, :, 1:2])
    assert local[blk]["k"].is_contiguous()


@pytest.mark.parametrize("tp", [2, 4])
def test_pack_weights_shard_major_bit_exact_with_jax(tp):
    """The fused wqkv is laid out shard-major, [q_0|k_0|v_0|q_1|...], word
    for word as the JAX package's ``pack_weights(params, tp)``; each
    shard's column slice is its own [q_s|k_s|v_s] block."""
    cfg_j, params_j = _jax_params("gemma2-2b", n_kv_heads=4)
    tree = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    want = jax_pack_weights(params_j, tp=tp)
    got = pack_weights(tree, tp=tp)
    jl = dict(_spec_leaves(jax.tree.map(np.asarray, want)))
    n = 0
    for path, leaf in _spec_leaves(got):
        if isinstance(leaf, PackedBool):
            ref = getattr(jl[path], "bits", jl[path])
            assert np.array_equal(leaf.bits.numpy(),
                                  np.asarray(ref).view(np.int32)), path
            n += 1
    assert n == 2 * 4            # wqkv, wo, wgu, wd in each of 2 roles
    blk = tree["blocks"]["b0"]["attn"]
    whole = pack_weights(tree)["blocks"]["b0"]["attn"]["wqkv"]["w"]
    local = got["blocks"]["b0"]["attn"]["wqkv"]["w"].bits
    per = local.shape[-1] // tp
    for s in range(tp):
        cols = [blk[k]["w"].shape[-1] for k in ("wq", "wk", "wv")]
        idx = torch.cat([torch.arange(s * c // tp, (s + 1) * c // tp) + off
                         for c, off in zip(cols, (0, cols[0],
                                                  cols[0] + cols[1]))])
        assert torch.equal(local[..., s * per:(s + 1) * per],
                           whole.bits[..., idx])
