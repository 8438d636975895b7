"""The reference's training placement on gloo worlds, FSDP first: one
sharded step of gemma2-2b (local/global attention, both softcaps, the
vocab split), falcon-mamba-7b (ssm: d_inner split) and arctic-480b (moe
with a dense residual FFN) at smoke width, fp32, on (data 2, model 2) and
(data 4, model 2) worlds, each rank holding its slices of the JAX
package's specs (``launch.shardings.train_param_specs``): every large
weight cut over "data" and gathered per layer group and microbatch
(``distributed.fsdp_gather``, one flat all-gather; the backward one flat
reduce-scatter), the heads, d_ff, d_inner, experts and vocab split over
"model". Also gemma2-2b with remat (each group's slices gathered again in
its recompute), with bf16 grad accumulation (the reduce-scatters sum at
bf16), and falcon-mamba-7b in one microbatch.

Each case: the gathered params after a step at η 1000 against the port's
unsharded step, both sides' threshold ties (the ±1 backprop signal's, the
Boolean activation's) broken alike (``break_ties``: a dead zone below
each threshold, so a value within rounding of it decides alike on both
sides), and the port's unsharded step with the real thresholds against
the JAX package's ``make_train_step``, on the same bridged weights and
batch: the loss within 1e-5, the FP leaves within 1e-5 (and the reference
test's rtol 2e-2 against the JAX package), an FP element further only
where Adam's first step is not saturated (counted, at most 1%), the flips
identical except ties (the vote within 1e-4 of the threshold, relative
to the leaf's largest vote; under bf16 accumulation within 2e-2 of the
threshold, a bf16 ulp of the vote, and the FP leaves within the
reference test's bound with at most 1% past 1e-5), counted. The step's
collectives against their formula; the ranks that hold the same slice of
a leaf hold the same bits. gemma2-2b, falcon-mamba-7b and arctic-480b on
(data 4, model 2) also run at the real thresholds, no tie broken, and
are held to the JAX package's step directly by the same rules. qwen2.5-14b, moonshot, jamba, sign_backward,
FP projections and the exact pieces are in
``tests/test_torch_split_step.py``.
"""
import json
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
from repro.core import hybrid_optimizer as jax_hybrid
from repro.data import make_pipeline as jax_pipeline
from repro.models import lm_init as jax_lm_init
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import (hybrid_optimizer, tree_leaves,
                                        tree_map)
from repro_torch.launch.shardings import kv_replicated, train_param_specs
from repro_torch.models import block_roles, lm_loss
from repro_torch.train import make_train_step
from repro_torch.train.step import bool_view

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH, MICRO, TP = 16, 8, 2, 2
ETA, FP_LR = 1000.0, 1e-3
LOSS_ATOL, FP_ATOL, REF_RTOL = 1e-5, 1e-5, 2e-2
# a flip may differ where the unsharded vote lies within this of the
# threshold, relative to the leaf's largest vote (a vote sums a microbatch
# of terms of that scale; fp32 reassociation moves it ~1e-5 of it)
TIE = 1e-4
# bf16 accumulation rounds each microbatch's summed grads to bf16, in
# another order on each side: a vote may move by a bf16 ulp (2^-8)
TIE_BF16 = 2e-2
# Adam's first step is saturated (±lr to 1%) where |g| > ~100 eps; below,
# a reassociated grad moves it: such elements are counted, not failed
ADAM_SATURATED, ADAM_SPREAD, REF_ATOL = 0.99 * FP_LR, 0.01, 2 * FP_LR
# the dead zones below the sign's 0 and the activation's tau under which
# both sides' ties break alike (``break_ties``)
SIGN_TIE, ACT_TIE = 1e-5, 1e-4

# breaks the ties of the two thresholds a training step crosses alike on
# both sides: the ±1 backprop signal (``signal_sign``) and the Boolean
# activation of the FFN and the experts (a pre-activation a few ulps from
# tau flips a ±1 activation and moves every vote below it); each threshold
# takes a dead zone below it, so values within rounding of it decide alike
_TIES = """
import repro_torch.core.boolean_linear as _BL
import repro_torch.models.ffn as _FFN
import repro_torch.models.moe as _MOE
from repro_torch.core import activation as _ACT

_REAL = (_BL.signal_sign, _ACT.boolean_activation)


def break_ties(on, sign_tie, act_tie):
    if not on:
        _BL.signal_sign = _REAL[0]
        _FFN.boolean_activation = _MOE.boolean_activation = _REAL[1]
        return
    _BL.signal_sign = lambda gx: torch.where(gx >= -sign_tie, 1.0, -1.0)

    def act(s, tau, *args, **kw):
        return _REAL[1](s, tau - act_tie, *args, **kw)
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


def save_tree(tree, path):
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v.numpy()

    walk(tree, "")
    np.savez(path, **flat)
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


def start_world(n: int, script: str, tmp_path, *args: str):
    """Start ``script`` (after ``_PREAMBLE``) as a gloo world of ``n``
    processes over a ``file://`` store under ``tmp_path``, ``args`` from
    ``sys.argv[4]`` on -> the processes (``finish`` waits for them)."""
    src = tmp_path / f"world{n}.py"
    src.write_text(_PREAMBLE + textwrap.dedent(script)
                   + "\ndist.barrier()\ndist.destroy_process_group()\n")
    store = tmp_path / f"store{n}"
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


# every rank: one sharded step per case. Ranks that hold the same slice of
# a leaf (the same coordinate on each axis it splits over) must hold the
# same bits; rank 0 writes the gathered params, the loss, the flips and
# the step's collectives
_STEP = _TIES + """
from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import hybrid_optimizer, tree_leaves
from repro_torch.distributed.placement import gather_tree, named, place
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.shardings import kv_replicated, train_param_specs
from repro_torch.train import make_train_step

mesh = make_local_mesh(int(sys.argv[5]), "cpu")
for case in json.loads(sys.argv[4]):
    break_ties(case["tie"], case["sign_tie"], case["act_tie"])
    dp = mesh.shape["data"]
    cfg = get_smoke(case["arch"]).scaled(
        dtype=torch.float32, use_sharding_constraints=True,
        batch_axes=("data",), moe_groups=dp, **case["flags"])
    params = load_tree(case["params"])
    specs = train_param_specs(params, replicate_kv=kv_replicated(
        cfg, mesh.shape["model"]))
    sh = named(mesh, specs)
    local = place(params, sh)
    opt = hybrid_optimizer(eta=case["eta"], fp_lr=case["fp_lr"])
    step = make_train_step(cfg, opt, case["micro"],
                           grad_accum_dtype=getattr(torch, case["accum"]),
                           grad_shardings=sh)
    batch = {k: torch.from_numpy(v) for k, v in np.load(case["batch"]).items()}
    before = dict(mesh.counts)
    new, state, m = step(local, opt.init(local), batch)
    counts = {k: mesh.counts[k] - before[k] for k in before}
    placed = tree_leaves(sh)
    keys = [tuple(mesh.coords[a] for a in ("data", "model")
                  if p.over(a) > 1) for p in placed]
    sums = [float(t.double().sum()) for t in tree_leaves(new)]
    every = [None] * WORLD
    dist.all_gather_object(every, (keys, sums))
    for k2, s2 in every:
        for j, (a, b) in enumerate(zip(s2, sums)):
            if k2[j] == keys[j]:
                assert a == b, (case["name"], placed[j].name, a, b)
    full = gather_tree(new, sh)
    if RANK == 0:
        save_tree(full, case["out"])
        print(json.dumps({"name": case["name"], "loss": float(m["loss"]),
                          "flips": float(m["flips"]), "counts": counts}))
break_ties(False, 0.0, 0.0)
mesh.close()
"""

# (arch, data ranks, accumulation dtype, config flags, mode): "tie" runs
# both sides with their thresholds' ties broken alike (``break_ties``),
# "real" the real thresholds, held to the JAX package's step directly
CASES = {
    "gemma-2x2": ("gemma2-2b", 2, "float32", {}, "tie"),
    "ssm-2x2": ("falcon-mamba-7b", 2, "float32", {}, "tie"),
    "arctic-2x2": ("arctic-480b", 2, "float32", {}, "tie"),
    "gemma-4x2": ("gemma2-2b", 4, "float32", {}, "tie"),
    "ssm-4x2": ("falcon-mamba-7b", 4, "float32", {}, "tie"),
    "arctic-4x2": ("arctic-480b", 4, "float32", {}, "tie"),
    # the group's slices freed after its forward, gathered again in its
    # recompute
    "gemma-4x2-remat": ("gemma2-2b", 4, "float32", {"remat": True}, "tie"),
    # the reduce-scatters sum at bf16
    "gemma-4x2-bf16acc": ("gemma2-2b", 4, "bfloat16", {}, "tie"),
    # one microbatch: the grads straight from the reduce-scatter
    "ssm-2x2-mb1": ("falcon-mamba-7b", 2, "float32", {}, "tie"),
    "gemma-4x2-real": ("gemma2-2b", 4, "float32", {}, "real"),
    "ssm-4x2-real": ("falcon-mamba-7b", 4, "float32", {}, "real"),
    "arctic-4x2-real": ("arctic-480b", 4, "float32", {}, "real"),
}
# cases of another microbatch count than MICRO
MICROS = {"ssm-2x2-mb1": 1}


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started at once, their results read when first asked:
    -> (inputs by case, {case: (record, gathered params)})."""
    tmp = tmp_path_factory.mktemp("fsdp_step")
    inputs = {}
    for name, (arch, _, _, flags, _) in CASES.items():
        cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32, **flags)
        params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
        params_np = jax.tree.map(np.asarray, params_j)
        batch = jax_pipeline(cfg_j, SEQ, BATCH).batch_at(0)
        inputs[name] = (params_np, save_tree(params_np, tmp / f"{name}.npz"),
                        batch, save_tree(batch, tmp / f"{name}-batch.npz"))
    procs = {}
    for dp in (2, 4):
        cases = [dict(name=name, arch=arch, accum=accum, flags=flags,
                      params=inputs[name][1], batch=inputs[name][3],
                      micro=MICROS.get(name, MICRO), eta=ETA, fp_lr=FP_LR,
                      tie=mode == "tie", sign_tie=SIGN_TIE, act_tie=ACT_TIE,
                      out=str(tmp / f"{name}.out.npz"))
                 for name, (arch, d, accum, flags, mode) in CASES.items()
                 if d == dp]
        procs[dp] = start_world(dp * TP, _STEP, tmp, json.dumps(cases),
                                str(TP))
    out = {}
    for dp, ps in procs.items():
        for line in finish(ps, timeout=300).splitlines():
            rec = json.loads(line)
            flat = np.load(tmp / f"{rec['name']}.out.npz")
            out[rec["name"]] = (rec, {k: flat[k] for k in flat.files})
    return inputs, out


def _port_unsharded(arch, dp, accum, flags, params_np, batch, tie=False,
                    micro=MICRO):
    """The port's unsharded step (``tie``: its thresholds' ties broken as
    the sharded side's, ``break_ties``) -> (params, loss, votes: the
    microbatches' mean grads of the Boolean views)."""
    cfg = get_smoke(arch).scaled(dtype=torch.float32, moe_groups=dp, **flags)
    break_ties(tie, SIGN_TIE, ACT_TIE)
    try:
        params = bridge.params_from_numpy(params_np, "cpu")
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        opt = hybrid_optimizer(eta=ETA, fp_lr=FP_LR)
        n = BATCH // micro
        grads = None
        for i in range(micro):
            pf = bool_view(params, cfg.dtype)
            mb = {k: v[i * n:(i + 1) * n] for k, v in tb.items()}
            g = torch.autograd.grad(lm_loss(cfg, pf, mb)[0],
                                    tree_leaves(pf), allow_unused=True)
            g = [torch.zeros(()) if x is None else x / micro for x in g]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        votes = dict(zip(sorted(_flat(params)), grads))
        new, _, m = make_train_step(cfg, opt, micro,
                                    grad_accum_dtype=getattr(torch, accum))(
            params, opt.init(params), tb)
    finally:
        break_ties(False, 0.0, 0.0)
    return ({k: v.numpy() for k, v in _flat(new).items()}, float(m["loss"]),
            {k: v.numpy() for k, v in votes.items()})


_REFS = {}


def _cached(fn, arch, dp, accum, flags, *rest, **kw):
    """``fn``'s result, once per (arch, routing groups, dtype, flags): the
    cases' weights and batch are those of their arch and flags."""
    groups = dp if get_smoke(arch).n_experts else 0
    key = (fn.__name__, arch, groups, accum, json.dumps(flags, sort_keys=True),
           json.dumps(kw, sort_keys=True))
    if key not in _REFS:
        _REFS[key] = fn(arch, dp, accum, flags, *rest, **kw)
    return _REFS[key]


def _jax_unsharded(arch, dp, accum, flags, params_np, batch, micro=MICRO):
    cfg = jax_smoke(arch).scaled(dtype=jnp.float32, moe_groups=dp, **flags)
    params = jax.tree.map(jnp.asarray, params_np)
    opt = jax_hybrid(eta=ETA, fp_lr=FP_LR)
    new, _, m = jax.jit(jax_make_train_step(
        cfg, opt, micro, grad_accum_dtype=getattr(jnp, accum)))(
        params, opt.init(params), {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    return _flat(jax.tree.map(np.asarray, new)), float(m["loss"])


def _assert_same_step(got, want, before, votes, what, rtol=0.0,
                      bf16=False):
    """Boolean leaves flip alike except where the unsharded vote lies
    within TIE of the threshold (of η times the leaf's largest |vote|;
    under ``bf16`` accumulation also within TIE_BF16 of the threshold);
    FP leaves within FP_ATOL (+ ``rtol``), but where Adam's first step of
    ``want`` is not saturated (under ``bf16`` wherever: a grad within a
    bf16 rounding of 0 takes ±lr either way), counted, at most
    ADAM_SPREAD of the FP elements, within REF_ATOL. -> (flips, flip ties,
    FP elements past FP_ATOL)."""
    flips = ties = loose = total = 0
    for key, w0 in _flat(before).items():
        a, b = np.asarray(want[key]), np.asarray(got[key])
        assert a.shape == b.shape, (what, key)
        if w0.dtype == np.int8:
            flips += int((a != w0).sum())
            differ = a != b
            margin = np.abs(ETA * votes[key] * w0 - 1.0)
            band = TIE * ETA * np.abs(votes[key]).max()
            if bf16:
                band = max(band, TIE_BF16)
            assert (margin[differ] <= band).all(), (what, key,
                                                    margin[differ].min(),
                                                    band)
            ties += int(differ.sum())
            continue
        total += a.size
        far = np.abs(b - a) > FP_ATOL + rtol * np.abs(a)
        if far.any():
            step = np.abs(a - w0.astype(a.dtype))
            assert bf16 or (step[far] < ADAM_SATURATED).all(), (
                what, key, float(np.abs(b - a)[far].max()))
            np.testing.assert_allclose(b, a, rtol=REF_RTOL, atol=REF_ATOL,
                                       err_msg=f"{what}: {key}")
            loose += int(far.sum())
    assert loose <= ADAM_SPREAD * max(total, 1), (what, loose, total)
    return flips, ties, loose


def want_counts(arch, dp, flags, micro=MICRO):
    """One sharded step's collectives by formula: each microbatch gathers
    (over "data") the embedding, every layer group's weight slices and
    the head, one all-gather each, and reduce-scatters their grads alike;
    sums over "model" the embedding lookup and each row-split projection
    (FFN wd, mamba x_proj and out_proj), three loss statistics, gathers
    the heads before each wo and each MoE layer's router and its routing
    groups' expert outputs; then one all-reduce over "data" for each leaf
    not cut over it and the loss, and one count all-reduce over each axis
    a Boolean leaf splits over."""
    cfg = get_smoke(arch).scaled(dtype=torch.float32, moe_groups=dp,
                                 use_sharding_constraints=True, **flags)
    roles = block_roles(cfg)
    remat = 2 if cfg.remat and cfg.remat_policy != "save_block_outs" else 1
    groups = cfg.n_groups
    rows = moe = attn = 0
    for r in roles:
        rows += 2 if r["mixer"] == "mamba" else 0
        attn += r["mixer"] != "mamba"
        moe += "moe" in (r["ffn"] or "")
        rows += "dense" in (r["ffn"] or "")
    from repro_torch.models import lm_init
    params = lm_init(cfg, torch.Generator().manual_seed(0))
    specs = train_param_specs(params, replicate_kv=kv_replicated(cfg, TP))
    leaves = list(zip(tree_leaves(params), tree_leaves(
        tree_map(lambda s: tuple(s), specs))))
    whole = sum("data" not in sp for _, sp in leaves)
    counts = sum(("data" in sp) + ("model" in sp)
                 for p, sp in leaves if p.dtype == torch.int8)
    return {"fsdp_gathers": micro * (2 + groups * remat),
            "fsdp_scatters": micro * (2 + groups),
            "model_sums": micro * (1 + groups * rows * remat),
            "vocab_reduces": micro * 3,
            "head_gathers": micro * groups * attn * remat,
            "expert_gathers": micro * groups * moe * remat * (1 + 1),
            "grad_reduces": whole + 1, "count_reduces": counts,
            "vote_reduces": 0, "seq_combines": 0, "leaf_gathers": 0}


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[4] == "tie"])
def test_sharded_step_matches_the_unsharded_steps(worlds, name):
    """The gathered params and the loss after one sharded step against the
    port's unsharded step, each side's threshold ties broken alike: loss
    within 1e-5, FP leaves within 1e-5 (Adam's unsaturated first steps
    counted), flips identical outside vote ties (counted, under 0.1% of
    the flips, 2% under bf16 accumulation); the port's unsharded step with the real thresholds against
    the JAX package's, as closely (FP leaves with the reference test's
    rtol 2e-2); the step's collectives by their formula."""
    inputs, out = worlds
    arch, dp, accum, flags, _ = CASES[name]
    micro = MICROS.get(name, MICRO)
    bf16 = accum == "bfloat16"
    params_np, _, batch, _ = inputs[name]
    rec, got = out[name]
    port, loss_t, votes = _cached(_port_unsharded, arch, dp, accum, flags,
                                  params_np, batch, tie=True, micro=micro)
    assert abs(rec["loss"] - loss_t) <= LOSS_ATOL, (rec["loss"], loss_t)
    flips, ties, _ = _assert_same_step(got, port, params_np, votes, "port",
                                       bf16=bf16)
    assert flips > 0
    assert ties <= (2e-2 if bf16 else 1e-3) * flips, (ties, flips)
    real, loss_r, votes_r = _cached(_port_unsharded, arch, dp, accum, flags,
                                    params_np, batch, micro=micro)
    ref, loss_j = _cached(_jax_unsharded, arch, dp, accum, flags, params_np,
                          batch, micro=micro)
    assert abs(loss_r - loss_j) <= LOSS_ATOL, (loss_r, loss_j)
    _assert_same_step(real, ref, params_np, votes_r, "port vs jax", REF_RTOL,
                      bf16=bf16)
    want = want_counts(arch, dp, flags, micro)
    assert rec["counts"] == want, (rec["counts"], want)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[4] == "real"])
def test_real_thresholds_match_the_jax_step(worlds, name):
    """The sharded step at the real thresholds (no tie broken) against the
    JAX package's ``make_train_step`` directly, on the same weights and
    batch: loss within 1e-5, FP leaves within 1e-5 and rtol 2e-2 (Adam's
    unsaturated first steps counted), flips identical outside vote ties
    (counted, under 0.1% of the flips); the collectives by formula."""
    inputs, out = worlds
    arch, dp, accum, flags, _ = CASES[name]
    params_np, _, batch, _ = inputs[name]
    rec, got = out[name]
    ref, loss_j = _cached(_jax_unsharded, arch, dp, accum, flags, params_np,
                          batch, micro=MICRO)
    _, _, votes = _cached(_port_unsharded, arch, dp, accum, flags,
                          params_np, batch, micro=MICRO)
    assert abs(rec["loss"] - loss_j) <= LOSS_ATOL, (rec["loss"], loss_j)
    flips, ties, _ = _assert_same_step(got, ref, params_np, votes, "jax",
                                       REF_RTOL)
    assert flips > 0
    assert ties <= 1e-3 * flips, (ties, flips)
    want = want_counts(arch, dp, flags)
    assert rec["counts"] == want, (rec["counts"], want)
