"""The port's EF-SignSGD vote all-reduce against the JAX package's
(``distributed/compression.py``; ``tests/test_distributed.py::
test_ef_signsgd_compression_roundtrip``).

``compress_votes`` runs on gloo worlds of 2 and 8 processes, one row of g
a rank, and the JAX package's under ``shard_map`` over 2 and 8 forced CPU
devices in a subprocess, on the same rows, with a zero and a random bf16
residual. The votes must be identical (each side's votes read back from
its decoded values and its own scale); the decoded values within 8 fp32
ulps and the residuals within one bf16 ulp (each rank's scale is a mean of
64 fp32 terms, which XLA and torch sum in different orders). The port also
meets the reference test's own bounds (correlation with the true mean >
0.4, the residual under twice max|g|). Then the wrapper,
``ef_signsgd_compressed(hybrid_optimizer(...), ("data",))`` in
``make_train_step``'s sharded step on a (data 2, model 2) world: 3 steps
leave every replica identical, the Boolean grads cross the ranks once (as
votes: one scale all-reduce and one vote all-reduce a Boolean leaf a step,
fp32 all-reduces only for the FP leaves and the loss), and the params and
residuals equal those of the same steps on (data 2, model 1).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed.compression import compress_votes

ROOT = Path(__file__).resolve().parents[1]
ROWS, COLS = 8, 64
# decoded values: votes/n · scale, the scale a mean of 64 fp32 terms summed
# in another order on each side: within 8 ulps (2^-20 relative)
DEC_RTOL = 2.0 ** -20
# residuals: (g + e) − sign·scale rounded to bf16, a scale's ulp may move
# the rounding by one bf16 ulp (2^-7 relative)
ERR_RTOL = 2.0 ** -7

_PREAMBLE = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=sys.argv[3], rank=RANK,
                        world_size=WORLD)
"""


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


# the JAX package's compress_votes under shard_map, every device's output
_JAX = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed import shard_map
from repro.distributed.compression import compress_votes

inp = np.load(sys.argv[1])
out = {}
for case in ("zero", "random"):
    g = jnp.asarray(inp["g"])
    e = jnp.asarray(inp[f"e_{case}"]).astype(jnp.bfloat16)
    for n in (2, 8):
        mesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])
        f = jax.jit(shard_map(
            lambda gg, ee: compress_votes(gg, ee, ("data",)), mesh=mesh,
            in_specs=(P("data"), P("data")),
            out_specs=(P("data"), P("data")), check_vma=False))
        dec, err = f(g[:n], e[:n])
        out[f"dec_{case}_{n}"] = np.asarray(dec, np.float32)
        out[f"err_{case}_{n}"] = np.asarray(err.astype(jnp.float32))
np.savez(sys.argv[2], **out)
"""

# every rank: compress its row over the world, gather the rows on rank 0
_PORT = """
from repro_torch.distributed.compression import compress_votes
inp = np.load(sys.argv[4])
out = {}
for case in ("zero", "random"):
    g = torch.from_numpy(inp["g"][RANK:RANK + 1])
    e = torch.from_numpy(inp[f"e_{case}"][RANK:RANK + 1]).to(torch.bfloat16)
    dec, err = compress_votes(g, e, dist.group.WORLD)
    rows = [torch.empty_like(dec) for _ in range(WORLD)]
    dist.all_gather(rows, dec)
    errs = [torch.empty_like(err.float()) for _ in range(WORLD)]
    dist.all_gather(errs, err.float())
    out[f"dec_{case}"] = torch.cat(rows).numpy()
    out[f"err_{case}"] = torch.cat(errs).numpy()
if RANK == 0:
    np.savez(sys.argv[5], **out)
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression")
    rng = np.random.default_rng(0)
    inp = {"g": rng.standard_normal((ROWS, COLS)).astype(np.float32),
           "e_zero": np.zeros((ROWS, COLS), np.float32),
           # a bf16-representable residual, as the optimizer state holds
           "e_random": torch.from_numpy(
               0.5 * rng.standard_normal((ROWS, COLS)).astype(np.float32))
           .to(torch.bfloat16).float().numpy()}
    np.savez(tmp / "inp.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", _JAX, str(tmp / "inp.npz"),
                          str(tmp / "jax.npz")], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    port = {}
    for n in (2, 8):
        run_world(n, _PORT, tmp, str(tmp / "inp.npz"), str(tmp / f"p{n}.npz"))
        port[n] = dict(np.load(tmp / f"p{n}.npz"))
    return inp, dict(np.load(tmp / "jax.npz")), port


def _votes(dec, g, e, n):
    """Each row's votes read back from its decoded values and its own
    scale mean|g + e| (float64: exact for these magnitudes)."""
    scale = np.abs(g.astype(np.float64) + e).mean(axis=1, keepdims=True)
    return np.rint(dec / scale * n).astype(np.int64)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", ["zero", "random"])
def test_compress_votes_matches_the_reference(both, n, case):
    """Votes identical; decoded within 8 fp32 ulps; residuals within one
    bf16 ulp; votes are sums of n signs, the same on every rank."""
    inp, ref, port = both
    g, e = inp["g"][:n], inp[f"e_{case}"][:n]
    dec_t, err_t = port[n][f"dec_{case}"], port[n][f"err_{case}"]
    dec_j, err_j = ref[f"dec_{case}_{n}"], ref[f"err_{case}_{n}"]
    v_t, v_j = _votes(dec_t, g, e, n), _votes(dec_j, g, e, n)
    np.testing.assert_array_equal(v_t, v_j)
    signs = np.where(g + e >= 0, 1, -1)
    np.testing.assert_array_equal(v_t,
                                  np.broadcast_to(signs.sum(0), v_t.shape))
    np.testing.assert_allclose(dec_t, dec_j, rtol=DEC_RTOL, atol=0)
    np.testing.assert_allclose(err_t, err_j, rtol=ERR_RTOL, atol=0)


@pytest.mark.parametrize("n", [2, 8])
def test_reference_bounds_hold_in_the_port(both, n):
    """The reference test's bounds on the port's world of 8 (and 2): the
    decoded votes correlate with the true mean gradient (> 0.4) and the
    residual stays under twice the largest |g|."""
    inp, _, port = both
    true = inp["g"][:n].mean(0)
    corr = np.corrcoef(true, port[n]["dec_zero"][0])[0, 1]
    assert corr > 0.4, corr
    assert np.abs(port[n]["err_zero"]).max() < np.abs(inp["g"][:n]).max() * 2


def test_one_rank_alone_keeps_its_sign_and_scale():
    """``group=None`` is a rank alone: votes are the rank's signs, decoded
    sign · mean|g + e|, the residual (g + e) − decoded in bf16."""
    g = torch.tensor([[0.5, -2.0, 0.0, 1.5]])
    e = torch.tensor([[-1.0, 0.5, 0.0, 0.25]]).to(torch.bfloat16)
    dec, err = compress_votes(g, e, None)
    c = g + e.float()
    scale = c.abs().mean()
    torch.testing.assert_close(dec, torch.where(c >= 0, 1.0, -1.0) * scale,
                               rtol=0, atol=0)
    assert err.dtype == torch.bfloat16
    torch.testing.assert_close(err, (c - dec).to(torch.bfloat16), rtol=0,
                               atol=0)


# the wrapper in the sharded step: 3 steps, replicas compared every step;
# rank 0 writes the gathered params and each data shard's gathered residual
_WRAPPED = """
from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import (hybrid_optimizer, is_boolean_leaf,
                                        tree_leaves)
from repro_torch.data import make_pipeline
from repro_torch.distributed.compression import ef_signsgd_compressed
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.distributed.placement import gather_tree, named, place
from repro_torch.launch.shardings import train_param_specs
from repro_torch.models import lm_init
from repro_torch.train import make_train_step

mesh = make_local_mesh(int(sys.argv[4]), "cpu")
cfg = get_smoke("gemma2-2b").scaled(dtype=torch.float32,
                                    use_sharding_constraints=True)
params = lm_init(cfg, torch.Generator().manual_seed(0))
full_params = params
# the votes are taken on grads whole over "data": the Boolean leaves stay
# whole over it; the FP leaves' FSDP and the "model" splits apply
specs = train_param_specs(params, boolean_fsdp=False)
sh = named(mesh, specs)
params = place(params, sh)
opt = ef_signsgd_compressed(hybrid_optimizer(eta=1000.0, fp_lr=1e-3),
                            ("data",))
state = opt.init(params)
step = make_train_step(cfg, opt, 2, grad_shardings=sh)
pipe = make_pipeline(cfg, 16, 8)
placed = tree_leaves(sh)
bools = [is_boolean_leaf(p) for p in tree_leaves(params)]
n_bool = sum(bools)
n_fp = len(bools) - n_bool
# the FP leaves cut over "data" (the embedding, the head) take their grads
# from the reduce-scatters; the others' are all-reduced
n_fp_cut = sum(p.over("data") > 1 for p, b in zip(placed, bools) if not b)
keys = [tuple(mesh.coords[a] for a in ("data", "model") if p.over(a) > 1)
        for p in placed]
flips = []
for i in range(3):
    before = dict(mesh.counts)
    params, state, m = step(params, state, {
        k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()})
    d = {k: mesh.counts[k] - before[k] for k in before}
    assert d["vote_reduces"] == 1 + n_bool, d
    assert d["grad_reduces"] == n_fp - n_fp_cut + 1, d       # + the loss
    assert d["fsdp_scatters"] == 2 * n_fp_cut, d       # two microbatches
    # the ranks holding the same slices hold the same params; each rank's
    # residual is its own
    sums = [float(t.double().sum()) for t in tree_leaves(params)]
    every = [None] * WORLD
    dist.all_gather_object(every, (keys, sums))
    for k2, s in every:
        for j, (a, b) in enumerate(zip(s, sums)):
            if k2[j] == keys[j]:
                assert a == b, (i, placed[j].name)
    flips.append(sum(float(f) for f in
                     tree_leaves(state.inner.boolean.flips)))
full = [t.numpy() for t in tree_leaves(gather_tree(params, sh))]
err = [t.float().numpy() for t in tree_leaves(gather_tree(state.error, sh))]
every = [None] * WORLD
dist.all_gather_object(every, (mesh.coords["data"], mesh.coords["model"],
                               err))
# a placement that cuts the Boolean leaves over "data" is refused
cut = named(mesh, train_param_specs(full_params))
refused = ""
try:
    make_train_step(cfg, opt, 2, grad_shardings=cut)(
        place(full_params, cut), opt.init(place(full_params, cut)),
        {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()})
except ValueError as e:
    refused = str(e)
if RANK == 0:
    out = {f"p{j}": t for j, t in enumerate(full)}
    for d, mc, e in every:
        if mc == 0:
            out.update({f"e{d}_{j}": t for j, t in enumerate(e)})
    np.savez(sys.argv[5], **out)
print(json.dumps({"flips": flips, "n_bool": n_bool, "n_fp": n_fp,
                  "n_fp_cut": n_fp_cut, "refused": refused}))
mesh.close()
"""


@pytest.fixture(scope="module")
def wrapped(tmp_path_factory):
    """The wrapped steps on (data 2, model 2) and (data 2, model 1) worlds:
    -> {model axis: (record, gathered params and residuals)}."""
    tmp = tmp_path_factory.mktemp("wrapped")
    out = {}
    for tp in (2, 1):
        stdout = run_world(2 * tp, _WRAPPED, tmp, str(tp),
                           str(tmp / f"tp{tp}.npz"), timeout=200)
        out[tp] = (json.loads(stdout.strip().splitlines()[-1]),
                   dict(np.load(tmp / f"tp{tp}.npz")))
    return out


def test_wrapper_keeps_replicas_identical(wrapped):
    """3 sharded steps through ``ef_signsgd_compressed`` on a (data 2,
    model 2) world: each step issues one scale all-reduce and one vote
    all-reduce a Boolean leaf, fp32 grad all-reduces for the FP leaves and
    the loss only; the ranks of a "model" coordinate hold identical params
    after every step (each keeps its own residual); the steps flip weights
    (the decoded votes carry one magnitude a leaf, mean|g + e|, so the
    first step's accumulators may all stay under the threshold)."""
    rec = wrapped[2][0]
    assert rec["n_bool"] > 0 and rec["n_fp"] > 0
    assert sum(rec["flips"]) > 0, rec


def test_vote_optimizer_refuses_boolean_leaves_cut_over_data(wrapped):
    """The JAX package's wrapper votes on grads replicated over the batch
    axes: ``make_train_step`` with a ``VoteOptimizer`` refuses a placement
    that cuts a Boolean leaf over "data", naming the leaf; with the
    Boolean leaves whole over "data" the FP leaves' FSDP still applies
    (the embedding and the head, reduce-scattered)."""
    for tp in (2, 1):
        rec = wrapped[tp][0]
        assert "VoteOptimizer" in rec["refused"], rec
        assert "blocks/" in rec["refused"] and "boolean_fsdp=False" in \
            rec["refused"], rec
        assert rec["n_fp_cut"] == 2, rec


def test_head_sharded_wrapper_matches_the_unsharded_one(wrapped):
    """The wrapper's 3 steps on (data 2, model 2), q/k/v column-sharded,
    against the same steps on (data 2, model 1): the scale of a sharded
    leaf is the whole leaf's (its slices' sums over "model"), so the
    gathered params and each data shard's gathered residual agree — Boolean
    leaves identical, FP leaves within 1e-5 (fp32 sums reassociated across
    the head shards), residuals within one bf16 ulp (a scale's last fp32
    bits may move the rounding) plus 1e-6 (a residual near 0 holds no
    relative precision)."""
    (rec2, got), (rec1, want) = wrapped[2], wrapped[1]
    assert rec2["flips"] == rec1["flips"]
    assert got.keys() == want.keys()
    for key in sorted(want):
        a, b = want[key], got[key]
        if a.dtype == np.int8:
            np.testing.assert_array_equal(b, a, err_msg=key)
        elif key.startswith("p"):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5,
                                       err_msg=key)
        else:
            d = np.abs(b - a)
            tie = d > ERR_RTOL * np.abs(a) + 1e-6
            assert tie.sum() <= 1e-3 * a.size, (key, int(tie.sum()))
            assert (d[tie] <= ERR_RTOL * np.abs(a).max()).all(), key
