"""The reference's training placement on gloo worlds, the "model" splits
first: one sharded step of qwen2.5-14b (dense, q/k/v biases),
moonshot-v1-16b-a3b (moe) and jamba-1.5-large-398b (hybrid: mamba, MoE
and attention in one group) at smoke width, fp32, on (data 2, model 2)
and (data 4, model 2) worlds (``start_world``), each rank holding its
slices of the JAX package's specs (``launch.shardings.
train_param_specs``: FSDP over "data"; heads, d_ff, d_inner, experts and
vocab over "model"). The gathered params after a step at η 1000 against
the port's unsharded step, both sides' threshold ties broken alike
(``break_ties``: a dead zone below the backprop sign's 0 and below the
Boolean activation's tau, so a value within rounding of a threshold
decides alike; the placement reassociates the sums below each
threshold, and one flipped ±1 moves every vote below it), and the port's
unsharded step with the real thresholds against the JAX package's
``make_train_step``, on the same bridged weights and batch: the loss and
the FP leaves within 1e-5 (and the reference test's rtol 2e-2 against
the JAX package), the flips identical except ties (the unsharded vote
within 1e-4 of the threshold, relative to the leaf's largest vote),
counted. An FP element may differ further only where Adam's first step
lr·g/(|g| + eps) is not saturated (|g| within ~100 eps of 0: a
reassociated grad of ~1e-7 moves it), counted, at most 1% of a case's FP
elements. The collectives of each step against their formula; the ranks
that hold the same slice of a leaf hold the same bits.

Also on (data 2, model 2): ``sign_backward`` (with the real sign the
first backprop sign that differs is a tie: a pre-sign value 0 in one
order and -4e-9 in the other), FP projections (``boolean=False``), the
scatter dispatch, and the exact pieces: the vocab-parallel embedding,
the loss's max and picked logit and the MoE layer's output (its combine)
``torch.equal`` to the unsharded ones, the NLL within 1e-6, labels in
every vocab shard and in the padded slots. jamba on (data 4, model 2)
at the real thresholds: its first Boolean activation that differs from
the unsharded step's is a tie (one ±1 in its last MoE layer, which moves
the votes below it past the flip ties' band). gemma2-2b, falcon-mamba-7b,
arctic-480b, remat and bf16 accumulation are in
``tests/test_torch_fsdp_step.py``.
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
from repro_torch.core import boolean_linear
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
# Adam's first step is saturated (±lr to 1%) where |g| > ~100 eps; below,
# a reassociated grad moves it: such elements are counted, not failed
ADAM_SATURATED, ADAM_SPREAD, REF_ATOL = 0.99 * FP_LR, 0.01, 2 * FP_LR
# the dead zones below the sign's 0 and the activation's tau under which
# both sides' ties break alike (``break_ties``)
SIGN_TIE, ACT_TIE = 1e-5, 1e-4
# a backprop sign that differs with the real sign: the unsharded pre-sign
# value within this of 0, relative to its row's largest
SIGNAL_TIE = 1e-6

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
# same bits; rank 0 writes the gathered params, the loss, the flips, the
# step's collectives and (``signals``) rank 0's pre-sign backprop signals
_STEP = _TIES + """
import repro_torch.core.boolean_linear as BL
from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import hybrid_optimizer, tree_leaves
from repro_torch.distributed.placement import gather_tree, named, place
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.shardings import kv_replicated, train_param_specs
from repro_torch.train import make_train_step

real_sign = BL.signal_sign
mesh = make_local_mesh(int(sys.argv[5]), "cpu")
for case in json.loads(sys.argv[4]):
    signals = []
    break_ties(case["tie"], case["sign_tie"], case["act_tie"])
    if case["signals"]:
        def record(gx):
            signals.append(gx.clone())
            return real_sign(gx)
        BL.signal_sign = record
    acts = []
    if case["acts"]:
        def recorder(tag):
            def act(s, tau, *args, **kw):
                acts.append((tag, (s - tau).detach().clone()))
                return _REAL[1](s, tau, *args, **kw)
            return act
        _FFN.boolean_activation = recorder("ffn")
        _MOE.boolean_activation = recorder("moe")
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
    if acts:
        torch.save((mesh.coords["data"], mesh.coords["model"], acts),
                   case["out"] + f".acts{RANK}.pt")
    full = gather_tree(new, sh)
    if RANK == 0:
        save_tree(full, case["out"])
        if signals:
            torch.save(signals, case["out"] + ".signals.pt")
        print(json.dumps({"name": case["name"], "loss": float(m["loss"]),
                          "flips": float(m["flips"]), "counts": counts}))
break_ties(False, 0.0, 0.0)
mesh.close()
"""

# (arch, data ranks, accumulation dtype, config flags, mode): "tie" runs
# both sides with their thresholds' ties broken alike (``break_ties``),
# "signals" the real thresholds, rank 0's pre-sign signals recorded, "acts"
# the real thresholds, every rank's Boolean activations recorded
CASES = {
    "dense-2x2": ("qwen2.5-14b", 2, "float32", {}, "tie"),
    "moe-2x2": ("moonshot-v1-16b-a3b", 2, "float32", {}, "tie"),
    "hybrid-2x2": ("jamba-1.5-large-398b", 2, "float32", {}, "tie"),
    "dense-4x2": ("qwen2.5-14b", 4, "float32", {}, "tie"),
    "moe-4x2": ("moonshot-v1-16b-a3b", 4, "float32", {}, "tie"),
    "hybrid-4x2": ("jamba-1.5-large-398b", 4, "float32", {}, "tie"),
    "dense-2x2-sign_backward": ("qwen2.5-14b", 2, "float32",
                                {"sign_backward": True}, "tie"),
    "dense-2x2-sign_backward-real": ("qwen2.5-14b", 2, "float32",
                                     {"sign_backward": True}, "signals"),
    "fp-2x2": ("qwen2.5-14b", 2, "float32", {"boolean": False}, "tie"),
    "moe-scatter-2x2": ("moonshot-v1-16b-a3b", 2, "float32",
                        {"moe_impl": "scatter"}, "tie"),
    "hybrid-4x2-real": ("jamba-1.5-large-398b", 4, "float32", {}, "acts"),
}


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
    tmp = tmp_path_factory.mktemp("split_step")
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
                      micro=MICRO, eta=ETA, fp_lr=FP_LR,
                      tie=mode == "tie", sign_tie=SIGN_TIE,
                      act_tie=ACT_TIE, signals=mode == "signals",
                      acts=mode == "acts",
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
            sig = tmp / f"{rec['name']}.out.npz.signals.pt"
            acts = [tmp / f"{rec['name']}.out.npz.acts{r}.pt"
                    for r in range(dp * TP)]
            recorded = torch.load(sig) if sig.exists() else [
                torch.load(a) for a in acts] if acts[0].exists() else None
            out[rec["name"]] = (rec, {k: flat[k] for k in flat.files},
                                recorded)
    return inputs, out


def _port_unsharded(arch, dp, accum, flags, params_np, batch, tie=False,
                    record=None, acts=None):
    """The port's unsharded step (``tie``: its thresholds' ties broken as
    the sharded side's, ``break_ties``; ``record``: a list the pre-sign
    signals are appended to; ``acts``: a list the Boolean activations'
    (tag, s - tau) are appended to) -> (params, loss, votes: the
    microbatches' mean grads of the Boolean views)."""
    cfg = get_smoke(arch).scaled(dtype=torch.float32, moe_groups=dp, **flags)
    break_ties(tie, SIGN_TIE, ACT_TIE)
    real = boolean_linear.signal_sign
    if record is not None:
        def sign(gx):
            record.append(gx.clone())
            return real(gx)
        boolean_linear.signal_sign = sign
    if acts is not None:
        def recorder(tag):
            def act(s, tau, *args, **kw):
                acts.append((tag, (s - tau).detach().clone()))
                return _REAL[1](s, tau, *args, **kw)
            return act
        _FFN.boolean_activation = recorder("ffn")
        _MOE.boolean_activation = recorder("moe")
    try:
        params = bridge.params_from_numpy(params_np, "cpu")
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        opt = hybrid_optimizer(eta=ETA, fp_lr=FP_LR)
        n = BATCH // MICRO
        grads = None
        for i in range(MICRO):
            pf = bool_view(params, cfg.dtype)
            mb = {k: v[i * n:(i + 1) * n] for k, v in tb.items()}
            g = torch.autograd.grad(lm_loss(cfg, pf, mb)[0],
                                    tree_leaves(pf), allow_unused=True)
            g = [torch.zeros(()) if x is None else x / MICRO for x in g]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        votes = dict(zip(sorted(_flat(params)), grads))
        for r in (record, acts):
            if r is not None:
                r.clear()
        new, _, m = make_train_step(cfg, opt, MICRO,
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


def _jax_unsharded(arch, dp, accum, flags, params_np, batch):
    cfg = jax_smoke(arch).scaled(dtype=jnp.float32, moe_groups=dp, **flags)
    params = jax.tree.map(jnp.asarray, params_np)
    opt = jax_hybrid(eta=ETA, fp_lr=FP_LR)
    new, _, m = jax.jit(jax_make_train_step(
        cfg, opt, MICRO, grad_accum_dtype=getattr(jnp, accum)))(
        params, opt.init(params), {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    return _flat(jax.tree.map(np.asarray, new)), float(m["loss"])


def _assert_same_step(got, want, before, votes, what, rtol=0.0):
    """Boolean leaves flip alike except where the unsharded vote lies
    within TIE of the threshold (of η times the leaf's largest |vote|);
    FP leaves within FP_ATOL (+ ``rtol``),
    but where Adam's first step of ``want`` is not saturated (counted, at
    most ADAM_SPREAD of the FP elements, within REF_ATOL). -> (flips,
    flip ties, unsaturated FP elements past FP_ATOL)."""
    flips = ties = loose = total = 0
    for key, w0 in _flat(before).items():
        a, b = np.asarray(want[key]), np.asarray(got[key])
        assert a.shape == b.shape, (what, key)
        if w0.dtype == np.int8:
            flips += int((a != w0).sum())
            differ = a != b
            margin = np.abs(ETA * votes[key] * w0 - 1.0)
            band = TIE * ETA * np.abs(votes[key]).max()
            assert (margin[differ] <= band).all(), (what, key,
                                                    margin[differ].min(),
                                                    band)
            ties += int(differ.sum())
            continue
        total += a.size
        far = np.abs(b - a) > FP_ATOL + rtol * np.abs(a)
        if far.any():
            step = np.abs(a - w0.astype(a.dtype))
            assert (step[far] < ADAM_SATURATED).all(), (
                what, key, float(np.abs(b - a)[far].max()))
            np.testing.assert_allclose(b, a, rtol=REF_RTOL, atol=REF_ATOL,
                                       err_msg=f"{what}: {key}")
            loose += int(far.sum())
    assert loose <= ADAM_SPREAD * max(total, 1), (what, loose, total)
    return flips, ties, loose


def want_counts(arch, dp, flags):
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
    return {"fsdp_gathers": MICRO * (2 + groups * remat),
            "fsdp_scatters": MICRO * (2 + groups),
            "model_sums": MICRO * (1 + groups * rows * remat),
            "vocab_reduces": MICRO * 3,
            "head_gathers": MICRO * groups * attn * remat,
            "expert_gathers": MICRO * groups * moe * remat * (1 + 1),
            "grad_reduces": whole + 1, "count_reduces": counts,
            "vote_reduces": 0, "seq_combines": 0, "leaf_gathers": 0}


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[4] == "tie"])
def test_sharded_step_matches_the_unsharded_steps(worlds, name):
    """The gathered params and the loss after one sharded step against the
    port's unsharded step, each side's threshold ties broken alike: loss
    within 1e-5, FP leaves within 1e-5 (Adam's unsaturated first steps
    counted), flips identical outside vote ties (counted, under 0.1% of
    the flips); the port's unsharded step with the real thresholds against
    the JAX package's, as closely (FP leaves with the reference test's
    rtol 2e-2); the step's collectives by their formula."""
    inputs, out = worlds
    arch, dp, accum, flags, _ = CASES[name]
    params_np, _, batch, _ = inputs[name]
    rec, got, _ = out[name]
    port, loss_t, votes = _cached(_port_unsharded, arch, dp, accum, flags,
                                  params_np, batch, tie=True)
    assert abs(rec["loss"] - loss_t) <= LOSS_ATOL, (rec["loss"], loss_t)
    flips, ties, _ = _assert_same_step(got, port, params_np, votes, "port")
    assert flips > 0 or not flags.get("boolean", True)
    assert ties <= 1e-3 * max(flips, 1), (ties, flips)
    real, loss_r, votes_r = _cached(_port_unsharded, arch, dp, accum, flags,
                                    params_np, batch)
    ref, loss_j = _cached(_jax_unsharded, arch, dp, accum, flags, params_np,
                          batch)
    assert abs(loss_r - loss_j) <= LOSS_ATOL, (loss_r, loss_j)
    _assert_same_step(real, ref, params_np, votes_r, "port vs jax", REF_RTOL)
    want = want_counts(arch, dp, flags)
    assert rec["counts"] == want, (rec["counts"], want)


def test_real_sign_differs_first_at_a_tie(worlds):
    """With the real ±1 signal, rank 0's pre-sign backprop signals against
    the unsharded step's on rank 0's rows (and, below a row-split
    projection, its input columns), call by call in backward order: the
    first call whose signs differ differs only where the unsharded value
    lies within SIGNAL_TIE of 0 (relative to its row's largest); the
    losses agree within 1e-5."""
    inputs, out = worlds
    name = "dense-2x2-sign_backward-real"
    arch, dp, accum, flags, _ = CASES[name]
    params_np, _, batch, _ = inputs[name]
    rec, _, sharded = out[name]
    record = []
    _, loss_t, _ = _port_unsharded(arch, dp, accum, flags, params_np, batch,
                                   record=record)
    assert abs(rec["loss"] - loss_t) <= LOSS_ATOL
    assert len(record) == len(sharded) > 0
    n = BATCH // MICRO
    per = n // dp
    for i, (u, s) in enumerate(zip(record, sharded)):
        mb = i // (len(record) // MICRO)
        # rank 0's rows of its microbatch are the first of the global ones
        u = u.reshape(n, SEQ, -1)[:per].reshape(per, SEQ, -1)
        s = s.reshape(per, SEQ, -1)
        u = u[..., :s.shape[-1]]
        differ = (u >= 0) != (s >= 0)
        if differ.any():
            row = u.abs().amax(-1, keepdim=True).expand_as(u)
            rel = (u.abs() / row)[differ]
            assert (rel <= SIGNAL_TIE).all(), (i, mb, float(rel.max()))
            break


def test_exact_pieces(tmp_path):
    """On (data 1, model 2) and (data 1, model 4) worlds: the vocab-
    parallel embedding lookup, the loss's max over the vocab and its
    picked logit, and an MoE layer's output (the combine over the gathered
    expert outputs) ``torch.equal`` to the unsharded ones; the NLL within
    1e-6 (its sum of exponentials reassociates); labels in every vocab
    shard and in the padded slots."""
    for tp in (2, 4):
        stdout = finish(start_world(tp, _EXACT, tmp_path, str(tp)),
                        timeout=200)
        rec = json.loads(stdout.strip().splitlines()[-1])
        assert rec == {"embed": True, "max": True, "picked": True,
                       "nll": True, "moe": True, "labels_in_pad": True,
                       "shards_hit": tp}, rec


_EXACT = """
from repro_torch.configs import get_smoke
from repro_torch.distributed import vocab_embed
from repro_torch.distributed.placement import P, named, place
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm_init
from repro_torch.models import moe as MOE
from repro_torch.models.lm import _vocab_nll

tp = int(sys.argv[4])
mesh = make_local_mesh(tp, "cpu")
cfg = get_smoke("moonshot-v1-16b-a3b").scaled(
    dtype=torch.float32, use_sharding_constraints=True, moe_groups=1)
gen = torch.Generator().manual_seed(0)
V, Vp = cfg.vocab_size, cfg.vocab_padded
vl, r = Vp // tp, mesh.coords["model"]
# the embedding: every shard's tokens and the padded slots' rows
table = torch.randn(Vp, cfg.d_model, generator=gen)
tokens = torch.randint(0, Vp, (4, 32), generator=gen)
mine = table[r * vl:(r + 1) * vl].clone()
emb = torch.equal(vocab_embed(mine, tokens, mesh), table[tokens])
# the loss's pieces from this rank's vocab columns
logits = torch.randn(4, 32, Vp, generator=gen) * 4
labels = torch.randint(0, Vp, (4, 32), generator=gen)
labels[0, :4] = torch.arange(V, V + 4)           # in the padded slots
hit = torch.unique(labels // vl).numel()
nll = _vocab_nll(cfg, logits[..., r * vl:(r + 1) * vl].clone(), labels, mesh)
full = logits.masked_fill(~(torch.arange(Vp) < V), -1e30)
m = full.amax(-1, keepdim=True)
want = torch.log(torch.exp(full - m).sum(-1)) + m[..., 0] \\
    - torch.gather(full, -1, labels[..., None])[..., 0]
close = bool(torch.allclose(nll, want, rtol=0, atol=1e-6)
             or torch.allclose(nll, want, rtol=1e-6, atol=0))
loc = full[..., r * vl:(r + 1) * vl]
mm = loc.amax(-1, keepdim=True)
mesh.all_reduce(mm, "model", op=dist.ReduceOp.MAX)
same_max = torch.equal(mm, m)
own = (labels >= r * vl) & (labels < (r + 1) * vl)
pk = torch.gather(loc, -1, (labels - r * vl).clamp(0, vl - 1)[..., None])[..., 0]
pk = torch.where(own, pk, torch.zeros(()))
mesh.all_reduce(pk, "model")
same_pick = torch.equal(pk, torch.gather(full, -1, labels[..., None])[..., 0])
# an MoE layer: the experts split over "model"
p = lm_init(cfg.scaled(use_sharding_constraints=False),
            torch.Generator().manual_seed(1))["blocks"]["b0"]["moe"]
p = {k: v[0] for k, v in p.items()}
x = torch.randn(2, 16, cfg.d_model, generator=gen)
un = MOE.moe_apply(cfg.scaled(use_sharding_constraints=False), dict(p), x)[0]
spec = {"router": P(None, "model"), "wg": P("model"), "wu": P("model"),
        "wd": P("model"), "tau": P()}
loc_p = place({k: v.to(torch.float32) if v.dtype == torch.int8 else v
               for k, v in p.items()}, named(mesh, spec))
sh = MOE.moe_apply(cfg, loc_p, x)[0]
out = {"embed": emb, "max": same_max, "picked": same_pick, "nll": close,
       "moe": torch.equal(sh, un), "labels_in_pad": bool((labels >= V).any()),
       "shards_hit": hit}
if RANK == 0:
    print(json.dumps(out))
mesh.close()
"""


def test_real_activation_differs_first_at_a_tie(worlds):
    """jamba at the real thresholds on (data 4, model 2), whose step cannot
    be held to the JAX package's flip for flip: every rank's Boolean
    activations (s - tau), call by call in forward order, against the
    unsharded step's on that rank's rows and d_ff columns (in an MoE layer
    its routing groups and its experts): the first call whose signs differ
    differs only where the unsharded value lies within SIGNAL_TIE of 0
    (relative to its row's largest) — one ±1 there moves the grads of
    every layer below it, past the flip ties' band; the loss within 1e-5
    of the JAX package's and of the port's unsharded step; the step's
    collectives by formula."""
    inputs, out = worlds
    name = "hybrid-4x2-real"
    arch, dp, accum, flags, _ = CASES[name]
    params_np, _, batch, _ = inputs[name]
    rec, _, ranks = out[name]
    acts = []
    _, loss_t, _ = _port_unsharded(arch, dp, accum, flags, params_np, batch,
                                   acts=acts)
    _, loss_j = _cached(_jax_unsharded, arch, dp, accum, flags, params_np,
                        batch)
    assert abs(rec["loss"] - loss_t) <= LOSS_ATOL, (rec["loss"], loss_t)
    assert abs(rec["loss"] - loss_j) <= LOSS_ATOL, (rec["loss"], loss_j)
    assert rec["counts"] == want_counts(arch, dp, flags)

    def layers(calls, groups):
        """Calls grouped a layer: a dense FFN's one, an MoE layer's one a
        routing group."""
        out, i = [], 0
        while i < len(calls):
            k = groups if calls[i][0] == "moe" else 1
            out.append((calls[i][0], [x for _, x in calls[i:i + k]]))
            i += k
        return out

    n = BATCH // MICRO
    per = n // dp
    want = layers(acts, dp)
    first = None
    for d, m, calls in ranks:
        got = layers(calls, 1)
        assert [t for t, _ in got] == [t for t, _ in want]
        for i, ((tag, u), (_, s)) in enumerate(zip(want, got)):
            if tag == "ffn":
                w = s[0].shape[-1]
                u = [u[0][d * per:(d + 1) * per, ..., m * w:(m + 1) * w]]
            else:
                gl = len(s)
                assert len(u) == dp * gl
                el = s[0].shape[0]
                u = [g[m * el:(m + 1) * el] for g in u[d * gl:(d + 1) * gl]]
            u, s = torch.stack(u), torch.stack(s)
            assert u.shape == s.shape, (i, tag, u.shape, s.shape)
            differ = (u >= 0) != (s >= 0)
            if differ.any():
                row = u.abs().amax(-1, keepdim=True).expand_as(u)
                rel = float((u.abs() / row)[differ].max())
                if first is None or i < first[0]:
                    first = (i, rel)
                elif i == first[0]:
                    first = (i, max(first[1], rel))
                break
    assert first is not None, "no activation differs: hold the step to " \
        "the JAX package's directly"
    assert first[1] <= SIGNAL_TIE, first
