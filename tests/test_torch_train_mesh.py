"""The port's sharded training step against the unsharded one and the JAX
package's (its ``tests/test_distributed.py::
test_pjit_train_step_matches_single_device``, whose own sharded run fails
in this container, so the reference is its unsharded ``make_train_step``).

One step of ``microbatches=2`` (and, dense at (2, 2), of
``microbatches=1``) runs on gloo worlds of 4 (data 2, model 2) and 8
(data 4, model 2) processes (``run_world``): each rank takes its
slice of the params (``train_param_specs``: q/k/v column-sharded over
"model"), its rows of the global batch, and reduces its grads over
"data". The full params after the step, gathered, must equal the port's
unsharded step and the JAX package's: the loss within 1e-5, FP leaves
within 1e-5 (fp32 at smoke width: sums reassociated across ranks), Boolean
flips identical except ties at the threshold; every replicated leaf and
every rank's slice identical on the ranks that share it. Dense
(qwen2.5-14b, q/k/v biases) and MoE (moonshot-v1-16b-a3b, one routing
group a batch shard) smoke archs, fp32, ``grad_accum_dtype=bfloat16``,
``sign_backward`` (the ±1 backprop signal, below which the loss's scale
does not reach: each rank differentiates its share of the global loss)
and FP projections (``boolean=False``). The launcher and the mesh's
refusals are in ``tests/test_torch_train_launch.py``.
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
from repro.models import lm_loss as jax_lm_loss
from repro.train.step import bool_view as jax_bool_view
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import hybrid_optimizer
from repro_torch.train import make_train_step

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH, MICRO = 16, 8, 2
ETA, FP_LR = 1000.0, 1e-3      # η large enough that one step flips weights
# fp32 at smoke width: losses and FP leaves differ by reassociation ulps
LOSS_ATOL, FP_ATOL = 1e-5, 1e-5
# against the JAX package also the reference test's rtol (2e-2): Adam's
# first step is lr·g/(|g| + eps), so a leaf whose grad is near eps (a k
# bias, near-invariant under the softmax) moves with the grad's last bits
REF_RTOL = 2e-2
# a flip decision may differ only where η·q·w of the reference's vote lies
# within this of the threshold 1 (fp32 vote noise is ~1e-7 relative)
TIE = 1e-4
# bf16 accumulation: the grads are rounded to bf16 at each microbatch, in
# a different order on each side, so a vote may move by a bf16 ulp (2^-8
# relative): flips may differ where η·q·w lies within this of 1
TIE_BF16 = 2e-2
# and an FP leaf whose grad lies within a bf16 rounding of 0 may take
# Adam's first step (±lr) either way: the reference test's tolerance
# (rtol 2e-2, atol 2e-3 = 2·lr) bounds every element, and at most 1% of a
# the FP elements (all leaves together) may lie beyond FP_ATOL
BF16_RTOL, BF16_ATOL, BF16_SPREAD = 2e-2, 2e-3, 0.01

# run before every world script: join a gloo world of WORLD ranks
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


def run_world(n: int, script: str, tmp_path, *args: str,
              timeout: float = 150) -> str:
    """Run ``script`` (after ``_PREAMBLE``) as a gloo world of ``n``
    processes over a ``file://`` store under ``tmp_path``, ``args`` from
    ``sys.argv[4]`` on; every rank must exit 0. Returns rank 0's stdout."""
    src = tmp_path / f"world{n}.py"
    # every rank leaves the world together, its meshes closed first: a
    # group object still held once the world is destroyed is torn down at
    # the interpreter's exit, where gloo's threads can abort the process
    src.write_text(_PREAMBLE + textwrap.dedent(script)
                   + "\ndist.barrier()\ndist.destroy_process_group()\n")
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


# every rank: one sharded step per case; rank 0 writes the gathered params
# and the loss; every rank's local leaves are checksummed and compared
# across the ranks that must hold the same slice
_STEP = """
from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import hybrid_optimizer, tree_leaves
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.distributed.placement import gather_tree, named, place
from repro_torch.launch.shardings import train_param_specs
from repro_torch.train import make_train_step

mesh = make_local_mesh(2, "cpu")
for case in json.loads(sys.argv[4]):
    cfg = get_smoke(case["arch"]).scaled(
        dtype=torch.float32, use_sharding_constraints=True,
        batch_axes=("data",), moe_groups=case["moe_groups"], **case["flags"])
    params = load_tree(case["params"])
    specs = train_param_specs(params)
    sh = named(mesh, specs)
    local = place(params, sh)
    opt = hybrid_optimizer(eta=case["eta"], fp_lr=case["fp_lr"])
    step = make_train_step(cfg, opt, case["micro"],
                           grad_accum_dtype=getattr(torch, case["accum"]),
                           grad_shardings=sh)
    batch = {k: torch.from_numpy(v) for k, v in np.load(case["batch"]).items()}
    new, state, m = step(local, opt.init(local), batch)
    sums = [float(t.double().sum()) for t in tree_leaves(new)]
    # the ranks holding the same slice of a leaf: the same coordinate on
    # each axis it splits over
    keys = [tuple(mesh.coords[a] for a in ("data", "model")
                  if p.over(a) > 1) for p in tree_leaves(sh)]
    every = [None] * WORLD
    dist.all_gather_object(every, (keys, sums))
    for k2, s in every:
        for j, (a, b) in enumerate(zip(s, sums)):
            if k2[j] == keys[j]:
                assert a == b, (case["name"], j, a, b)
    full = gather_tree(new, sh)
    if RANK == 0:
        save_tree(full, case["out"])
        print(json.dumps({"name": case["name"], "loss": float(m["loss"]),
                          "flips": float(m["flips"]),
                          "counts": mesh.counts}))
mesh.close()
"""


CASES = {
    # name: (arch, batch shards, accumulation dtype, config flags)
    "dense-2x2": ("qwen2.5-14b", 2, "float32", {}),
    "moe-2x2": ("moonshot-v1-16b-a3b", 2, "float32", {}),
    "dense-2x2-bf16acc": ("qwen2.5-14b", 2, "bfloat16", {}),
    # a ±1 backprop signal: the loss's scale does not reach below it
    "dense-2x2-sign_backward": ("qwen2.5-14b", 2, "float32",
                                {"sign_backward": True}),
    # FP projections: the q/k/v input's grad summed by copy_to_group
    "fp-2x2": ("qwen2.5-14b", 2, "float32", {"boolean": False}),
    "dense-4x2": ("qwen2.5-14b", 4, "float32", {}),
    "moe-4x2": ("moonshot-v1-16b-a3b", 4, "float32", {}),
    # one microbatch: the grads are reduced in place straight after the
    # differentiation
    "dense-2x2-mb1": ("qwen2.5-14b", 2, "float32", {}),
}
# cases of another microbatch count than MICRO
MICROS = {"dense-2x2-mb1": 1}
# a k bias's grad is zero but for rounding (the softmax does not see a
# shift of every score of a query), so Adam's first step lr·g/(|g| + eps)
# of such an element is rounding noise anywhere in [-lr, lr]: in these
# cases, as under bf16 accumulation, the FP leaves are held to the
# reference test's bound with at most 1% of their elements past FP_ATOL
SPREAD = {"dense-2x2-mb1"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds run once; -> {case: (world result, gathered params)}."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    inputs = {}
    for name, (arch, _, _, flags) in CASES.items():
        cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32, **flags)
        params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
        params_np = jax.tree.map(np.asarray, params_j)
        batch = jax_pipeline(cfg_j, SEQ, BATCH).batch_at(0)
        inputs[name] = (params_np, save_tree(params_np, tmp / f"{name}.npz"),
                        batch, save_tree(batch, tmp / f"{name}-batch.npz"))
    out = {}
    for world in (4, 8):
        cases = [dict(name=name, arch=arch, moe_groups=dp, accum=accum,
                      flags=flags, params=inputs[name][1],
                      batch=inputs[name][3], micro=MICROS.get(name, MICRO),
                      eta=ETA,
                      fp_lr=FP_LR, out=str(tmp / f"{name}.npz"))
                 for name, (arch, dp, accum, flags) in CASES.items()
                 if dp * 2 == world]
        stdout = run_world(world, _STEP, tmp, json.dumps(cases),
                           timeout=200)
        for line in stdout.splitlines():
            rec = json.loads(line)
            flat = np.load(tmp / f"{rec['name']}.npz")
            out[rec["name"]] = (rec, flat)
    return inputs, out


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _unsharded(arch, dp, accum, flags, params_np, batch, micro=MICRO):
    """The port's and the JAX package's unsharded steps at the same
    settings: (port params, port loss, JAX params, JAX loss, JAX votes)."""
    cfg_t = get_smoke(arch).scaled(dtype=torch.float32, moe_groups=dp,
                                   **flags)
    params = bridge.params_from_numpy(params_np, "cpu")
    opt = hybrid_optimizer(eta=ETA, fp_lr=FP_LR)
    new_t, _, m_t = make_train_step(
        cfg_t, opt, micro, grad_accum_dtype=getattr(torch, accum))(
        params, opt.init(params), {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32, moe_groups=dp,
                                   **flags)
    params_j = jax.tree.map(jnp.asarray, params_np)
    opt_j = jax_hybrid(eta=ETA, fp_lr=FP_LR)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    new_j, _, m_j = jax.jit(jax_make_train_step(
        cfg_j, opt_j, micro, grad_accum_dtype=getattr(jnp, accum)))(
        params_j, opt_j.init(params_j), bj)
    # the step's votes: the mean of the microbatches' grads (the routing
    # groups of an MoE layer are per microbatch)
    grad = jax.jit(jax.grad(lambda p, b: jax_lm_loss(cfg_j, p, b)[0]))
    n = BATCH // micro
    mbs = [grad(jax_bool_view(params_j, jnp.float32),
                {k: v[i * n:(i + 1) * n] for k, v in bj.items()})
           for i in range(micro)]
    votes = jax.tree.map(lambda *g: sum(g) / micro, *mbs)
    return (_flat({k: v for k, v in new_t.items()}), float(m_t["loss"]),
            _flat(jax.tree.map(np.asarray, new_j)), float(m_j["loss"]),
            _flat(jax.tree.map(np.asarray, votes)))


def _assert_same_step(got, want, before, votes, tie, what, rtol=0.0,
                      bf16=False):
    """FP leaves within FP_ATOL (+ ``rtol``; the spread bound under
    ``bf16``);
    Boolean leaves flip alike except where the reference's vote sits within
    ``tie`` of the threshold. -> flips."""
    flips = far = total = 0
    for key, w0 in _flat(before).items():
        a = np.asarray(want[key])
        b = got[key].numpy() if isinstance(got[key], torch.Tensor) \
            else np.asarray(got[key])
        assert a.shape == b.shape, (what, key)
        if w0.dtype == np.int8:
            flips += int((a != w0).sum())
            differ = a != b
            margin = np.abs(ETA * votes[key] * w0 - 1.0)
            assert (margin[differ] <= tie).all(), (what, key,
                                                   margin[differ].min())
        elif bf16:
            np.testing.assert_allclose(b, a, rtol=BF16_RTOL, atol=BF16_ATOL,
                                       err_msg=f"{what}: {key}")
            far += int((np.abs(b - a) > FP_ATOL).sum())
            total += a.size
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=FP_ATOL,
                                       err_msg=f"{what}: {key}")
    assert far <= BF16_SPREAD * max(total, 1), (what, far, total)
    return flips


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_the_unsharded_steps(worlds, name):
    """The gathered params and the loss after one sharded step against the
    port's unsharded step and the JAX package's: loss within 1e-5, FP leaves
    within 1e-5 (and the reference test's rtol 2e-2 against the JAX
    package's), flips identical outside ties (fp32 accumulation: 1e-4 of
    the threshold; bf16: 2e-2, a bf16 ulp of the vote; under bf16 and in
    ``SPREAD``'s cases the FP leaves within the reference test's bound
    with at most 1% of their elements past 1e-5), and the step flips
    weights."""
    inputs, out = worlds
    arch, dp, accum, flags = CASES[name]
    params_np, _, batch, _ = inputs[name]
    rec, flat = out[name]
    port, loss_t, ref, loss_j, votes = _unsharded(
        arch, dp, accum, flags, params_np, batch, MICROS.get(name, MICRO))
    got = {k: flat[k] for k in flat.files}
    bf16 = accum == "bfloat16"
    tie = TIE_BF16 if bf16 else TIE
    spread = bf16 or name in SPREAD
    assert abs(rec["loss"] - loss_t) <= LOSS_ATOL, (rec["loss"], loss_t)
    assert abs(rec["loss"] - loss_j) <= LOSS_ATOL, (rec["loss"], loss_j)
    flips = _assert_same_step(got, port, params_np, votes, tie, "port",
                              bf16=spread)
    _assert_same_step(got, ref, params_np, votes, tie, "jax", REF_RTOL,
                      spread)
    assert flips > 0 or not flags.get("boolean", True)
    # a world of data × model ranks reduces every grad over "data" and sums
    # the activation grads of q/k/v over "model"
    assert rec["counts"]["grad_reduces"] > 0
    assert rec["counts"]["head_gathers"] > 0


def test_bf16_accumulation_changes_the_sums(worlds):
    """grad_accum_dtype=bfloat16 is not fp32 under another name: the
    unsharded steps' FP leaves differ between the two dtypes."""
    inputs, _ = worlds
    params_np, _, batch, _ = inputs["dense-2x2"]
    a = _unsharded("qwen2.5-14b", 2, "float32", {}, params_np, batch)[0]
    b = _unsharded("qwen2.5-14b", 2, "bfloat16", {}, params_np, batch)[0]
    assert any(not torch.equal(a[k], b[k]) for k in a
               if a[k].dtype != torch.int8)
