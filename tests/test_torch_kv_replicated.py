"""Head-parallel training on a "model" axis wider than the KV heads (with
the rest of the JAX package's placement: d_ff and the vocab split over
"model" too, FSDP over a "data" axis of one): k/v
replicated (``launch.shardings.kv_replicated``,
``train_param_specs(replicate_kv=True)``), as the JAX package places KV
heads fewer than the axis (``ModelConfig.kv_heads_padded``). Every rank
computes all KV heads and its q heads read KV head ``rank // (tp / kvp)``;
the k/v votes (and biases' grads) are summed over "model".

A gloo world of 4 processes, (data 1, model 4), runs one sharded step of
the smoke gemma2-2b (2 KV heads) and qwen2.5-14b (2 KV heads, q/k/v
biases), each at 16 q heads so that every rank holds real ones and each
KV head is read from two ranks, in fp32, on the JAX package's initial
weights (bridged) and one batch of its data pipeline; at an η small
enough that no weight flips (the accumulators then hold every vote) and
at one large enough that weights flip. The gathered result is held
against the port's unsharded step and the JAX package's unsharded
``make_train_step`` on the same weights and batch: the loss within 1e-5;
the Boolean accumulators (η·votes, bf16) of every leaf -- k/v's summed
across ranks, q's gathered -- within bf16 rounding; the int8 leaves
flipped alike except ties at the threshold (where the accumulator, reset
on one side, is not compared); the FP leaves within 1e-5 (and the
reference test's rtol against the JAX package's). Every rank holds the
same replicated k/v leaves, and the collectives issued are those of the
placement (the k/v vote sums among them).
"""
import json

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
from test_torch_train_mesh import REF_RTOL, TIE, run_world, save_tree

HEADS, SEQ, BATCH, MICRO, FP_LR = 16, 16, 4, 2, 1e-3
LOSS_ATOL, FP_ATOL = 1e-5, 1e-5
# the JAX package's votes are another program's fp32 sums, and the
# sharded step's reassociated ones (d_ff and the vocab split over "model"
# with the heads): an element's vote may differ from theirs by this much
# absolute, which η scales into the accumulator before its bf16 rounding
VOTE_ATOL = 1e-8
# name: (arch, η); 1e-3 flips nothing, 1000 flips weights in every case
CASES = {"gemma2-2b-hold": ("gemma2-2b", 1e-3),
         "gemma2-2b-flip": ("gemma2-2b", 1000.0),
         "qwen2.5-14b-hold": ("qwen2.5-14b", 1e-3),
         "qwen2.5-14b-flip": ("qwen2.5-14b", 1000.0)}

# every rank: one sharded step per case; rank 0 writes the gathered params
# and accumulators, the loss, the flips and the collectives issued
_STEP = """
from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import hybrid_optimizer, tree_leaves
from repro_torch.distributed.placement import gather_tree, named, place
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.shardings import kv_replicated, train_param_specs
from repro_torch.train import make_train_step


# the tree's tensors as fp32 (bf16 has no numpy dtype), None left out
def floats(node):
    return {k: floats(v) if isinstance(v, dict) else v.float()
            for k, v in node.items() if v is not None}


mesh = make_local_mesh(4, "cpu")
for case in json.loads(sys.argv[4]):
    cfg = get_smoke(case["arch"]).scaled(dtype=torch.float32,
                                         n_heads=case["heads"])
    assert kv_replicated(cfg, 4)
    params = load_tree(case["params"])
    batch = {k: torch.from_numpy(v) for k, v in np.load(case["batch"]).items()}
    opt = hybrid_optimizer(eta=case["eta"], fp_lr=case["fp_lr"])
    sh = named(mesh, train_param_specs(params, replicate_kv=True))
    local = place(params, sh)
    scfg = cfg.scaled(use_sharding_constraints=True, batch_axes=("data",))
    for k in mesh.counts:
        mesh.counts[k] = 0
    new, state, m = make_train_step(scfg, opt, case["micro"],
                                    grad_shardings=sh)(
        local, opt.init(local), batch)
    counts = dict(mesh.counts)
    # the replicated k/v leaves: the same on every rank
    kv = [float(t.double().sum()) for bi, blk in sorted(new["blocks"].items())
          for name in ("wk", "wv") for t in tree_leaves(blk["attn"][name])]
    every = [None] * WORLD
    dist.all_gather_object(every, kv)
    assert all(e == kv for e in every), every
    acc = gather_tree(state.boolean.accum, sh)
    full = gather_tree(new, sh)
    if RANK == 0:
        save_tree(full, case["out"])
        save_tree(floats(acc), case["accum"])
        print(json.dumps({"name": case["name"], "loss": float(m["loss"]),
                          "flips": float(m["flips"]), "counts": counts}))
mesh.close()
"""


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict, None leaves left out."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's inputs (the JAX package's weights and batch) and one
    gloo world of 4 that runs them all; -> {case: (inputs, world result,
    gathered params, gathered accumulators)}."""
    tmp = tmp_path_factory.mktemp("kv_replicated")
    inputs, cases = {}, []
    for name, (arch, eta) in CASES.items():
        cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32, n_heads=HEADS)
        params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
        params_np = jax.tree.map(np.asarray, params_j)
        batch = jax_pipeline(cfg_j, SEQ, BATCH).batch_at(0)
        inputs[name] = (params_np, batch)
        cases.append(dict(name=name, arch=arch, eta=eta, heads=HEADS,
                          fp_lr=FP_LR, micro=MICRO,
                          params=save_tree(params_np, tmp / f"{name}.npz"),
                          batch=save_tree(batch, tmp / f"{name}-batch.npz"),
                          out=str(tmp / f"{name}-out.npz"),
                          accum=str(tmp / f"{name}-accum.npz")))
    stdout = run_world(4, _STEP, tmp, json.dumps(cases), timeout=200)
    out = {}
    for line in stdout.splitlines():
        rec = json.loads(line)
        name = rec["name"]
        out[name] = (inputs[name], rec,
                     dict(np.load(tmp / f"{name}-out.npz")),
                     dict(np.load(tmp / f"{name}-accum.npz")))
    return out


def _references(arch, eta, params_np, batch):
    """The port's and the JAX package's unsharded steps, and the JAX
    package's votes (the mean of the microbatches' grads): {side: (params,
    accumulators, loss)}, votes."""
    cfg_t = get_smoke(arch).scaled(dtype=torch.float32, n_heads=HEADS)
    params = bridge.params_from_numpy(params_np, "cpu")
    opt = hybrid_optimizer(eta=eta, fp_lr=FP_LR)
    new_t, st_t, m_t = make_train_step(cfg_t, opt, MICRO)(
        params, opt.init(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32, n_heads=HEADS)
    params_j = jax.tree.map(jnp.asarray, params_np)
    opt_j = jax_hybrid(eta=eta, fp_lr=FP_LR)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    new_j, st_j, m_j = jax.jit(jax_make_train_step(cfg_j, opt_j, MICRO))(
        params_j, opt_j.init(params_j), bj)
    grad = jax.jit(jax.grad(lambda p, b: jax_lm_loss(cfg_j, p, b)[0]))
    n = BATCH // MICRO
    mbs = [grad(jax_bool_view(params_j, jnp.float32),
                {k: v[i * n:(i + 1) * n] for k, v in bj.items()})
           for i in range(MICRO)]
    votes = jax.tree.map(lambda *g: sum(g) / MICRO, *mbs)
    return ({"port": (_flat(new_t), _flat(st_t.boolean.accum),
                      float(m_t["loss"])),
             "jax": (_flat(new_j), _flat(st_j.boolean.accum),
                     float(m_j["loss"]))},
            _flat(jax.tree.map(np.asarray, votes)))


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_kv_step_matches_the_unsharded_step(world, name):
    """The gathered params, accumulators and loss after one step with k/v
    replicated over a "model" axis of 4 against the port's and the JAX
    package's unsharded steps: loss within 1e-5; flips identical outside
    ties (the reference's η·q·w within 1e-4 of the threshold); the
    accumulators within a bf16 rounding where both sides kept them (of a
    vote within 1e-8 of either side's); the
    FP leaves within 1e-5 (with the reference test's rtol 2e-2 against the
    JAX package's). At the small η no weight flips, at the large one
    weights flip."""
    arch, eta = CASES[name]
    (params_np, batch), rec, got, got_acc = world[name]
    refs, votes = _references(arch, eta, params_np, batch)
    before = _flat(params_np)
    for side, (want, want_acc, loss) in refs.items():
        assert abs(rec["loss"] - loss) <= LOSS_ATOL, (side, rec["loss"], loss)
        assert set(want) == set(got), side
        rtol = REF_RTOL if side == "jax" else 0.0
        for key, w0 in before.items():
            a, b = _np(want[key]), got[key]
            assert a.shape == b.shape, (side, key)
            if w0.dtype != np.int8:
                np.testing.assert_allclose(b, a, rtol=rtol, atol=FP_ATOL,
                                           err_msg=f"{side}: {key}")
                continue
            differ = a != b
            margin = np.abs(eta * votes[key] * w0 - 1.0)
            assert (margin[differ] <= TIE).all(), (side, key,
                                                   margin[differ].min())
            # the accumulator: η·q, or 0 where the weight flipped
            acc_a, acc_b = _np(want_acc[key]), got_acc[key].astype(np.float32)
            # the placement splits d_ff and the vocab over "model" too, so
            # the sharded votes are reassociated sums on either side
            floor = eta * VOTE_ATOL
            tol = 2 ** -7 * np.abs(acc_a) + floor
            bad = (np.abs(acc_b - acc_a) > tol) & ~differ
            assert not bad.any(), (side, key, np.abs(acc_b - acc_a)[bad].max())
    flips = sum(int((got[k] != w0).sum()) for k, w0 in before.items()
                if w0.dtype == np.int8)
    assert flips == rec["flips"], (flips, rec["flips"])
    assert (flips > 0) == (eta > 1.0), (name, flips)
    c = rec["counts"]
    # one data rank: no grad all-reduce; the heads gathered in each
    # attention layer's forward; the q leaves' flip counts summed
    assert c["grad_reduces"] == 0 and c["head_gathers"] > 0, c
    assert c["count_reduces"] > 0, c
