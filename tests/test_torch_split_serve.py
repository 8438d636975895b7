"""The JAX package's placement of the prefill and decode steps on gloo
worlds: gemma2-2b, qwen2.5-14b (q/k/v biases), falcon-mamba-7b,
moonshot-v1-16b-a3b and jamba-1.5-large-398b at smoke width, fp32, on
(data 2, model 2) and (data 1, model 4) worlds (``start_world``; falcon
and jamba also in long_500k's layout on (data 2, model 2), and jamba on
(data 2, model 1): every row on every rank, the cache rows over both
axes), each
rank holding its slices of the training specs (``launch.shardings.
train_param_specs``: FSDP over "data"; heads, d_ff, d_inner, experts and
vocab over "model"; the smoke KV heads split over a model axis of 2 and,
but moonshot's 4, replicated over 4). A case runs a sharded cold prefill
of a 16-token prompt into a 32-row cache (``lm_prefill(shardings=)``,
each rank its rows of the batch and its slab of the rows over "model",
every KV head: where k/v are split, one all-to-all a layer trades heads
for rows), then 4 sharded decode steps through ``make_decode_step(cfg,
shardings)`` (the decode's one routing group spans the batch ranks), and
is held to the port's unsharded ``lm_prefill`` / ``lm_decode_step`` on
the same bridged weights, both sides' Boolean-activation ties broken
alike (``break_ties``: a dead zone below tau, so a pre-activation within
rounding of it decides alike; the row-split ``wd``, ``x_proj`` and
``out_proj`` sums over "model" reassociate) and counted: every rank's
logits (whole over the vocab) within ``LOGIT_ATOL`` of its rows of the
unsharded logits, its cache slab and SSM state slab after the prefill and
after the decode within ``CACHE_ATOL`` of the same rows and channels of
the unsharded cache (``launch.shardings.cache_specs`` places the
unsharded cache; a slab's shapes are that placement's). The port's
unsharded steps (real thresholds) against the JAX package's
``make_prefill_step`` / ``make_decode_step`` on the same weights, within
``REF_ATOL``. Each step's collectives against their formula. gemma2-2b
also runs with an int8 cache (``kv_cache_quant``: its scales trade with
the rows) and through ``make_prefill_step(cfg, shardings)`` (the cache at
the prompt's rows).
"""
import json
import math
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

from repro.configs import get_smoke as jax_smoke
from repro.models import cache_init as jax_cache_init
from repro.models import lm_init as jax_lm_init
from repro.models import lm_prefill as jax_prefill
from repro.train import make_decode_step as jax_decode_step
from repro.train import make_prefill_step as jax_prefill_step
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.distributed.placement import NamedPlacement
from repro_torch.launch.shardings import cache_specs, kv_replicated
from repro_torch.models import block_roles, lm_decode_step, lm_prefill

ROOT = Path(__file__).resolve().parents[1]
BATCH, PROMPT, MAX_LEN, STEPS = 4, 16, 32, 4
# fp32 sums reassociated over "model" (the row-split projections, the
# vocab-parallel lookup, the seq combine) move logits and cache rows by a
# few ulps of their scale
LOGIT_ATOL, CACHE_ATOL = 1e-4, 1e-4
# the port's unsharded steps against the JAX package's (the tolerance of
# tests/test_torch_step_builders.py)
REF_ATOL = 1e-4
# the dead zone below the Boolean activation's tau under which both sides'
# ties break alike, and the share of a case's activations that may fall in
# it (counted)
ACT_TIE, TIE_SHARE = 1e-4, 1e-3

# breaks the Boolean activation's ties alike on both sides (the FFN's and
# the experts'), and counts the decisions it turns: a pre-activation
# within ACT_TIE below tau
_TIES = """
import repro_torch.models.ffn as _FFN
import repro_torch.models.moe as _MOE
from repro_torch.core import activation as _ACT

_REAL = _ACT.boolean_activation
TALLY = {"ties": 0, "acts": 0}


def break_ties(on, act_tie):
    if not on:
        _FFN.boolean_activation = _MOE.boolean_activation = _REAL
        return

    def act(s, tau, *args, **kw):
        d = s - tau
        # the decisions the dead zone turns: s within act_tie below tau
        TALLY["ties"] += int(((d < 0) & (d >= -act_tie)).sum())
        TALLY["acts"] += d.numel()
        return _REAL(s, tau - act_tie, *args, **kw)
    _FFN.boolean_activation = _MOE.boolean_activation = act
"""
exec(_TIES)

_PREAMBLE = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=sys.argv[3], rank=RANK,
                        world_size=WORLD)


def load_tree(path):
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


def save_tree(tree, path) -> str:
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)
    return str(path)


def start_world(shape, script: str, tmp_path, *args: str):
    """Start ``script`` (after ``_PREAMBLE``) as a gloo world of (data,
    model) ``shape``, one process a rank, over a ``file://`` store of its
    own under ``tmp_path``, ``args`` from ``sys.argv[4]`` on -> the
    processes (``finish`` waits for them)."""
    n, tag = shape[0] * shape[1], "x".join(map(str, shape))
    src = tmp_path / f"world{tag}.py"
    src.write_text(_PREAMBLE + textwrap.dedent(script)
                   + "\ndist.barrier()\ndist.destroy_process_group()\n")
    store = tmp_path / f"store{tag}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(src), str(r), str(n), f"file://{store}", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]


def finish(procs, timeout: float = 200) -> str:
    """Wait for a world; every rank must exit 0. -> rank 0's stdout."""
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
        assert p.returncode == 0, f"rank {r} of {len(procs)}:\n{err[-4000:]}"
    return outs[0][0]


# every rank: per case a sharded prefill then STEPS sharded decode steps;
# rank 0 writes every rank's logits and cache slabs and each step's
# collectives, and the tie tally summed over the ranks
_SERVE = _TIES + """
from repro_torch.configs import get_smoke
from repro_torch.distributed.placement import BatchRows, named, place
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.shardings import kv_replicated, train_param_specs
from repro_torch.models import lm_prefill
from repro_torch.train import make_decode_step, make_prefill_step

mesh = make_local_mesh(int(sys.argv[5]), "cpu")
dp, tp = mesh.shape["data"], mesh.shape["model"]
for case in json.loads(sys.argv[4]):
    TALLY.update(ties=0, acts=0)
    break_ties(True, case["act_tie"])
    kw = dict(dtype=torch.float32, use_sharding_constraints=True,
              batch_axes=("data",), cache_seq_axes=("model",),
              moe_groups=dp)
    kw.update(case["flags"])
    cfg = get_smoke(case["arch"]).scaled(**kw)
    params = load_tree(case["params"])
    sh = named(mesh, train_param_specs(params, replicate_kv=kv_replicated(
        cfg, tp)))
    local = place(params, sh)
    data = np.load(case["tokens"])
    rows = BatchRows(mesh, tuple(cfg.batch_axes))
    tok = rows.take(torch.from_numpy(data["prompt"]))
    out = {}
    counts = []

    def step_counts(before):
        return {k: v - before.get(k, 0) for k, v in mesh.counts.items()
                if v != before.get(k, 0)}

    before = dict(mesh.counts)
    logits, cache = lm_prefill(cfg, local, {"tokens": tok},
                               max_len=case["max_len"], shardings=sh)
    counts.append(step_counts(before))
    out["prefill"] = logits.numpy()
    for bi, leaves in cache["blocks"].items():
        for n, t in leaves.items():
            out[f"c0/{bi}/{n}"] = t.float().numpy().copy()
    step = make_decode_step(cfg.scaled(moe_groups=1), sh)
    for i in range(case["steps"]):
        before = dict(mesh.counts)
        logits, cache = step(local, cache, {"tokens": rows.take(
            torch.from_numpy(data[f"d{i}"]))})
        counts.append(step_counts(before))
        out[f"decode{i}"] = logits.numpy()
    for bi, leaves in cache["blocks"].items():
        for n, t in leaves.items():
            out[f"c1/{bi}/{n}"] = t.float().numpy()
    if case["builder"]:
        # the prefill through its step builder on the global batch
        before = dict(mesh.counts)
        lb, cb = make_prefill_step(cfg, sh)(local, {"tokens": tok})
        counts.append(step_counts(before))
        out["builder"] = lb.numpy()
        out["builder_pos"] = np.asarray(cb["pos"])
    every = [None] * WORLD
    dist.all_gather_object(every, (mesh.coords["data"], mesh.coords["model"],
                                   out, dict(TALLY)))
    if RANK == 0:
        flat = {f"{d}/{m}/{k}": v for d, m, o, _ in every
                for k, v in o.items()}
        np.savez(case["out"], **flat)
        ties = sum(t["ties"] for *_, t in every)
        acts = sum(t["acts"] for *_, t in every)
        print(json.dumps({"name": case["name"], "counts": counts,
                          "ties": ties, "acts": acts}))
break_ties(False, 0.0)
mesh.close()
"""

# (arch, (data, model), config flags, through make_prefill_step too)
CASES = {
    "gemma-2x2": ("gemma2-2b", (2, 2), {}, True),
    "gemma-int8-2x2": ("gemma2-2b", (2, 2), {"kv_cache_quant": True}, False),
    "qwen-2x2": ("qwen2.5-14b", (2, 2), {}, False),
    "falcon-2x2": ("falcon-mamba-7b", (2, 2), {}, False),
    "moonshot-2x2": ("moonshot-v1-16b-a3b", (2, 2), {}, False),
    "jamba-2x2": ("jamba-1.5-large-398b", (2, 2), {}, False),
    "gemma-1x4": ("gemma2-2b", (1, 4), {}, True),
    "qwen-1x4": ("qwen2.5-14b", (1, 4), {}, False),
    "falcon-1x4": ("falcon-mamba-7b", (1, 4), {}, False),
    "moonshot-1x4": ("moonshot-v1-16b-a3b", (1, 4), {}, False),
    "jamba-1x4": ("jamba-1.5-large-398b", (1, 4), {}, False),
}
# long_500k's layout: the batch over no axis (every rank holds every row),
# the cache rows over both axes
LONG = {"batch_axes": (), "cache_seq_axes": ("data", "model"),
        "moe_groups": 1}
CASES.update({
    "falcon-long-2x2": ("falcon-mamba-7b", (2, 2), LONG, False),
    "jamba-long-2x2": ("jamba-1.5-large-398b", (2, 2), LONG, False),
    # no "model" split: the ranks hold every head and slice their rows
    "jamba-long-2x1": ("jamba-1.5-large-398b", (2, 1), LONG, False),
})
ARCHS = sorted({c[0] for c in CASES.values()})


def _tokens(arch):
    rng = np.random.default_rng(7)
    vocab = get_smoke(arch).vocab_size
    out = {"prompt": rng.integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)}
    for i in range(STEPS):
        out[f"d{i}"] = rng.integers(0, vocab, (BATCH, 1)).astype(np.int32)
    return out


def _params(arch):
    params, _ = jax_lm_init(jax.random.PRNGKey(0),
                            jax_smoke(arch).scaled(dtype=jnp.float32))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started at once, their results read when first asked:
    -> (params and tokens by arch, {case: (record, {key: array})})."""
    tmp = tmp_path_factory.mktemp("split_serve")
    inputs = {}
    for arch in ARCHS:
        params, tokens = _params(arch), _tokens(arch)
        inputs[arch] = (params, tokens,
                        save_tree(params, tmp / f"{arch}.npz"),
                        save_tree(tokens, tmp / f"{arch}-tok.npz"))
    procs = {}
    for shape in {c[1] for c in CASES.values()}:
        cases = [dict(name=name, arch=arch, flags=flags, builder=builder,
                      params=inputs[arch][2], tokens=inputs[arch][3],
                      max_len=MAX_LEN, steps=STEPS, act_tie=ACT_TIE,
                      out=str(tmp / f"{name}.npz"))
                 for name, (arch, s, flags, builder) in CASES.items()
                 if s == shape]
        procs[shape] = start_world(shape, _SERVE, tmp, json.dumps(cases),
                                   str(shape[1]))
    out = {}
    for ps in procs.values():
        for line in finish(ps, timeout=300).splitlines():
            rec = json.loads(line)
            flat = np.load(tmp / f"{rec['name']}.npz")
            out[rec["name"]] = (rec, {k: flat[k] for k in flat.files})
    return inputs, out


_REFS = {}


def _unsharded(arch, dp, flags, params_np, tokens, tie=True):
    """The port's unsharded prefill (``moe_groups`` ``dp``, the batch
    shards, as the placed prefill's) and STEPS decode steps (one routing group), the
    activation ties broken as the sharded side's (``tie``) -> (prefill
    logits, decode logits, cache after the prefill, cache after the
    decode), once per (arch, data ranks, flags, tie)."""
    key = (arch, dp, json.dumps(flags, sort_keys=True), tie)
    if key in _REFS:
        return _REFS[key]
    # the placement's fields change nothing off a mesh; the routing groups
    # are the placed prefill's
    cfg = get_smoke(arch).scaled(**dict(flags, dtype=torch.float32,
                                        moe_groups=dp))
    break_ties(tie, ACT_TIE)
    try:
        params = bridge.params_from_numpy(params_np, "cpu")
        logits, cache = lm_prefill(
            cfg, params, {"tokens": torch.from_numpy(tokens["prompt"])},
            max_len=MAX_LEN)
        c0 = {bi: {n: t.clone() for n, t in leaves.items()}
              for bi, leaves in cache["blocks"].items()}
        dec = []
        for i in range(STEPS):
            lg, cache = lm_decode_step(cfg.scaled(moe_groups=1), params,
                                       cache, torch.from_numpy(tokens[f"d{i}"]))
            dec.append(lg.numpy())
    finally:
        break_ties(False, 0.0)
    _REFS[key] = (logits.numpy(), dec, c0, cache["blocks"])
    return _REFS[key]


class _Rank:
    """A rank's coordinates on a mesh of ``shape``, for ``NamedPlacement``
    (its ``local`` reads only ``shape`` and ``coords``)."""

    def __init__(self, shape, d, m):
        self.shape = {"data": shape[0], "model": shape[1]}
        self.coords = {"data": d, "model": m}


def _serve_cfg(arch, shape, flags):
    kw = dict(dtype=torch.float32, use_sharding_constraints=True,
              batch_axes=("data",), cache_seq_axes=("model",),
              moe_groups=shape[0])
    kw.update(flags)
    return get_smoke(arch).scaled(**kw)


def _batch_shards(cfg, shape) -> int:
    return shape[0] if "data" in cfg.batch_axes else 1


def want_counts(arch, shape, flags):
    """One prefill's and one decode step's collectives by formula. Both:
    over "data" (more than one rank) one FSDP gather of the embedding, one
    of each layer group's slices, one of the head; over "model" (more than
    one rank) the vocab-parallel lookup's sum and each row-split
    projection's (FFN ``wd``, mamba ``x_proj`` and ``out_proj``), one head
    gather an attention layer, each MoE layer's router gather and its
    expert outputs' (one routing group on the rank), and the logits' vocab
    gather. The prefill trades heads for rows in one all-to-all an
    attention layer where the KV heads split (two under kv_cache_quant:
    the rows and their scales); the decode combines the softmax
    statistics of the slabs (over more than one) in three all-reduces an
    attention layer and, over more than one batch shard, gathers each MoE
    layer's expert choices."""
    dp, tp = shape
    cfg = _serve_cfg(arch, shape, flags)
    roles = block_roles(cfg)
    G = cfg.n_groups
    rows = sum(2 if r["mixer"] == "mamba" else 0 for r in roles) \
        + sum("dense" in (r["ffn"] or "") for r in roles)
    attn = sum(r["mixer"] != "mamba" for r in roles)
    moe = sum("moe" in (r["ffn"] or "") for r in roles)
    split = not kv_replicated(cfg, tp)
    seq = math.prod(shape[("data", "model").index(a)]
                    for a in cfg.cache_seq_axes)
    both = {}
    if dp > 1:
        both["fsdp_gathers"] = 2 + G
    if tp > 1:
        both.update(model_sums=1 + G * rows, head_gathers=G * attn,
                    expert_gathers=2 * G * moe, vocab_gathers=1)
    prefill, decode = dict(both), dict(both)
    if tp > 1 and split and attn:
        prefill["cache_exchanges"] = G * attn * (
            2 if flags.get("kv_cache_quant") else 1)
    if seq > 1 and attn:
        decode["seq_combines"] = 3 * G * attn
    if _batch_shards(cfg, shape) > 1 and moe:
        decode["route_gathers"] = G * moe
    return ({k: v for k, v in prefill.items() if v},
            {k: v for k, v in decode.items() if v})


def _slab(tree, cfg, shape, d, m):
    """The rows and channels rank (d, m) holds of a whole cache tree
    (``cache_specs``' placement)."""
    specs = cache_specs(cfg, {"blocks": tree})["blocks"]
    rank = _Rank(shape, d, m)
    return {bi: {n: NamedPlacement(rank, specs[bi][n], f"{bi}/{n}")
                 .local(t.float()) for n, t in leaves.items()}
            for bi, leaves in tree.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_the_unsharded_steps(worlds, name):
    """Every rank's prefill and decode logits, its cache slab and SSM state
    slab after the prefill and after the decode, against the port's
    unsharded steps, ties broken alike and counted; each step's
    collectives by formula."""
    inputs, out = worlds
    arch, shape, flags, builder = CASES[name]
    params_np, tokens, *_ = inputs[arch]
    rec, got = out[name]
    cfg = _serve_cfg(arch, shape, flags)
    dp = _batch_shards(cfg, shape)
    lp, ld, c0, c1 = _unsharded(arch, dp, flags, params_np, tokens)
    b = BATCH // dp
    for d in range(shape[0]):
        for m in range(shape[1]):
            mine = slice(d * b, (d + 1) * b) if dp > 1 else slice(None)
            np.testing.assert_allclose(got[f"{d}/{m}/prefill"], lp[mine],
                                       rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"{name} prefill {d},{m}")
            for i in range(STEPS):
                np.testing.assert_allclose(
                    got[f"{d}/{m}/decode{i}"], ld[i][mine], rtol=0,
                    atol=LOGIT_ATOL, err_msg=f"{name} decode {i} {d},{m}")
            for tag, whole in (("c0", c0), ("c1", c1)):
                want = _slab(whole, cfg, shape, d, m)
                for bi, leaves in want.items():
                    for n, w in leaves.items():
                        have = got[f"{d}/{m}/{tag}/{bi}/{n}"]
                        assert have.shape == tuple(w.shape), (name, tag, bi,
                                                              n)
                        # int8 rows: a count either side of a rounding
                        atol = 1.0 if flags.get("kv_cache_quant") and \
                            n in ("k", "v") else CACHE_ATOL
                        np.testing.assert_allclose(
                            have, w.numpy(), rtol=0, atol=atol,
                            err_msg=f"{name} {tag} {bi}/{n} {d},{m}")
            if builder:
                np.testing.assert_allclose(
                    got[f"{d}/{m}/builder"], lp[mine], rtol=0,
                    atol=LOGIT_ATOL)
                assert int(got[f"{d}/{m}/builder_pos"]) == PROMPT
    assert rec["ties"] <= TIE_SHARE * max(rec["acts"], 1), rec
    want_p, want_d = want_counts(arch, shape, flags)
    assert rec["counts"][0] == want_p, (rec["counts"][0], want_p)
    for c in rec["counts"][1:1 + STEPS]:
        assert c == want_d, (c, want_d)
    if builder:
        assert rec["counts"][-1] == want_p


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_steps_match_the_jax_steps(worlds, arch):
    """The port's unsharded prefill and decode (real thresholds) against
    the JAX package's ``make_prefill_step`` and ``make_decode_step`` on the
    same weights and tokens: the prefill's last-position logits and its
    cache rows, and each decode step's logits within REF_ATOL."""
    inputs, _ = worlds
    params_np, tokens, *_ = inputs[arch]
    lp, ld, c0, _ = _unsharded(arch, 1, {}, params_np, tokens, tie=False)
    cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32)
    params_j = jax.tree.map(jnp.asarray, params_np)
    cache_j, _ = jax_cache_init(cfg_j, BATCH, MAX_LEN)
    lj, cj = jax_prefill_step(cfg_j)(params_j, {"tokens": jnp.asarray(
        tokens["prompt"])})
    np.testing.assert_allclose(lp, np.asarray(lj), rtol=0, atol=REF_ATOL)
    for bi, leaves in cj["blocks"].items():
        for n, w in leaves.items():
            have = c0[bi][n].float().numpy()
            w = np.asarray(w, np.float32)
            if w.ndim == 5:                    # rows 0..PROMPT of MAX_LEN
                have = have[:, :, :PROMPT]
            np.testing.assert_allclose(have, w, rtol=0, atol=REF_ATOL,
                                       err_msg=f"{arch} {bi}/{n}")
    # the JAX package's decode over its cache of MAX_LEN rows
    _, cache = jax_prefill(cfg_j, params_j, {"tokens": jnp.asarray(
        tokens["prompt"])}, cache=cache_j)
    step = jax_decode_step(cfg_j)
    for i in range(STEPS):
        lj, cache = step(params_j, cache, {"tokens": jnp.asarray(
            tokens[f"d{i}"])})
        np.testing.assert_allclose(ld[i], np.asarray(lj), rtol=0,
                                   atol=REF_ATOL, err_msg=f"{arch} step {i}")


# every rank: one MoE layer of a decode (16 rows of one token, 8 a data
# rank) whose router sends every token to expert 0, so the group's capacity
# binds: the rank's rows through ``moe_apply(route=("data",))`` and through
# its own rows alone, against the unsharded layer over the 16 rows
_ROUTE = """
from repro_torch.configs import get_smoke
from repro_torch.distributed.placement import P, named, place
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm_init
from repro_torch.models import moe as MOE

mesh = make_local_mesh(2, "cpu")
d = mesh.coords["data"]
cfg = get_smoke("moonshot-v1-16b-a3b").scaled(
    dtype=torch.float32, use_sharding_constraints=True, batch_axes=("data",),
    moe_groups=1)
whole = cfg.scaled(use_sharding_constraints=False)
p = lm_init(whole, torch.Generator().manual_seed(1))["blocks"]["b0"]["moe"]
p = {k: v[0].to(torch.float32) if v.dtype == torch.int8 else v[0]
     for k, v in p.items()}
p["router"] = 0.01 * p["router"]
p["router"][:, 0] += 1.0
x = torch.randn(16, 1, cfg.d_model, generator=torch.Generator().manual_seed(2))
x[:, :, 0] = 10.0 + x[:, :, 0].abs()     # every token's top choice: expert 0
un = MOE.moe_apply(whole, dict(p), x)[0][d * 8:(d + 1) * 8]
spec = {"router": P(None, "model"), "wg": P("model"), "wu": P("model"),
        "wd": P("model"), "tau": P()}
loc = place(p, named(mesh, spec))
before = mesh.counts["route_gathers"]
routed = MOE.moe_apply(cfg, dict(loc), x[d * 8:(d + 1) * 8],
                       route=("data",))[0]
gathers = mesh.counts["route_gathers"] - before
alone = MOE.moe_apply(cfg, dict(loc), x[d * 8:(d + 1) * 8])[0]
out = {"routed": float((routed - un).abs().max()),
       "alone": float((alone - un).abs().max()), "gathers": gathers}
every = [None] * WORLD
dist.all_gather_object(every, out)
if RANK == 0:
    print(json.dumps(every))
mesh.close()
"""


def test_a_decode_routing_group_spans_the_batch_ranks(tmp_path):
    """A decode's one routing group over its 16 tokens, 8 on each data
    rank of (data 2, model 2), all sent to expert 0 (capacity 8 binds:
    the group keeps the first 8 arrivals): through ``moe_apply(route=)``
    (one all-gather of the expert choices) each rank's outputs equal the
    unsharded group's within 1e-6; routed as a group of its own rows
    alone, rank 1 keeps tokens the whole group drops."""
    every = json.loads(finish(start_world((2, 2), _ROUTE, tmp_path))
                       .strip().splitlines()[-1])
    assert all(r["routed"] <= 1e-6 and r["gathers"] == 1 for r in every), \
        every
    assert max(r["alone"] for r in every) > 1e-3, every
