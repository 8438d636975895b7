"""The port's training path against the JAX package at gemma2-2b smoke width,
fp32: the loss and every leaf's gradient, whole train steps, the data
pipeline, checkpoints written by either package and restored by the other,
the restarting train loop and the launcher.

Weights come from the JAX package's ``lm_init`` and cross leaf by leaf as
numpy; batches come from each package's own ``SyntheticLM``, which must
agree bit for bit. Both sides sum in fp32 in different orders, so losses,
gradients and FP leaves agree to stated tolerances; Boolean flip decisions
must be identical except where the reference's vote sits on the flip
threshold within fp32 noise (a tie), and the ties are counted.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as jax_restore
from repro.checkpoint import save_pytree as jax_save
from repro.configs import get_smoke as jax_smoke
from repro.core import hybrid_optimizer as jax_hybrid
from repro.data import make_pipeline as jax_pipeline
from repro.models import lm_init as jax_lm_init
from repro.models import lm_loss as jax_lm_loss
from repro.train.step import bool_view as jax_bool_view
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.checkpoint import (CheckpointCorruption, restore_pytree,
                                    save_pytree)
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import hybrid_optimizer, tree_leaves
from repro_torch.data import make_pipeline
from repro_torch.models import lm_loss
from repro_torch.train import TrainLoop, bool_view, make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
SEQ, BATCH = 32, 4
ETA, FP_LR = 1000.0, 1e-3      # η large enough that one step flips weights
# fp32 at smoke width: the loss and FP leaves after a step differ only by
# reassociation ulps through 4 layers
LOSS_ATOL, FP_ATOL = 1e-5, 1e-5
# a flip decision may differ only where η·q·w of the reference's vote lies
# within this of the threshold 1 (fp32 vote noise is ~1e-7 relative)
TIE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-width ops are far too small to split among threads: with
    torch's default thread count a smoke train step takes seconds on a
    busy host, with one thread tens of milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_smoke("gemma2-2b").scaled(dtype=jnp.float32)
    cfg_t = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    params_np = jax.tree.map(np.asarray, params_j)
    batch = jax_pipeline(cfg_j, SEQ, BATCH).batch_at(0)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(cfg_j, p, b), has_aux=True))(
        jax_bool_view(params_j, jnp.float32),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                params_np=params_np, batch=batch, loss_j=float(loss_j),
                grads_j=jax.tree.map(np.asarray, grads_j))


def _params_t(setup):
    return bridge.params_from_numpy(setup["params_np"], "cpu")


def _batch_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(cfg, params, batch):
    pf = bool_view(params, cfg.dtype)
    loss, _ = lm_loss(cfg, pf, _batch_t(batch))
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(pf))


def test_lm_loss_and_every_leaf_grad_match_jax(setup):
    """Loss within 1e-5; each leaf's grad within 1e-6 + 1e-4·max|grad| (the
    largest, the head's, is ~0.1; measured errors are ~1e-7 of it)."""
    loss, grads = _port_grads(setup["cfg_t"], _params_t(setup), setup["batch"])
    assert abs(float(loss) - setup["loss_j"]) <= LOSS_ATOL
    want = jax.tree_util.tree_flatten_with_path(setup["grads_j"])[0]
    assert len(want) == len(grads) == 23
    for (path, a), g in zip(want, grads):
        assert tuple(g.shape) == a.shape, path
        tol = 1e-6 + 1e-4 * np.abs(a).max()
        np.testing.assert_allclose(g.numpy(), a, rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_gives_the_same_grads(setup):
    """Recomputing each group in the backward changes nothing: the grads
    with and without ``remat`` are bit-identical."""
    cfg = setup["cfg_t"]
    assert not cfg.remat                       # the smoke config's setting
    l0, g0 = _port_grads(cfg, _params_t(setup), setup["batch"])
    l1, g1 = _port_grads(cfg.scaled(remat=True), _params_t(setup),
                         setup["batch"])
    assert float(l0) == float(l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _flip_report(before, after_j, after_t, votes_j, eta):
    """-> (flips, ties) after asserting that every differing flip decision
    is a tie of the reference's vote at the threshold."""
    flips = ties = 0
    for w0, a, b, q in zip(before, after_j, after_t, votes_j):
        if w0.dtype != np.int8:
            continue
        flips += int((np.asarray(a) != w0).sum())
        differ = np.asarray(a) != b.numpy()
        margin = np.abs(eta * q * w0 - 1.0)
        assert (margin[differ] <= TIE).all(), margin[differ].min()
        ties += int(differ.sum())
    return flips, ties


def _jax_step(setup, microbatches):
    cfg_j, batch = setup["cfg_j"], setup["batch"]
    opt_j = jax_hybrid(eta=ETA, fp_lr=FP_LR)
    step_j = jax.jit(jax_make_train_step(cfg_j, opt_j, microbatches))
    return step_j(setup["params_j"], opt_j.init(setup["params_j"]),
                  {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.fixture(scope="module")
def jax_step1(setup):
    """The reference's one-microbatch step: (params, hybrid state, metrics)."""
    return _jax_step(setup, 1)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(setup, jax_step1, microbatches):
    """One full ``make_train_step`` step from the same weights and batch:
    loss within 1e-5, FP leaves within 1e-5, Boolean flips identical
    except counted ties, and the step does flip weights."""
    new_j, _, m_j = jax_step1 if microbatches == 1 else \
        _jax_step(setup, microbatches)
    opt_t = hybrid_optimizer(eta=ETA, fp_lr=FP_LR)
    params_t = _params_t(setup)
    new_t, _, m_t = make_train_step(setup["cfg_t"], opt_t, microbatches)(
        params_t, opt_t.init(params_t), _batch_t(setup["batch"]))

    assert abs(float(m_t["loss"]) - float(m_j["loss"])) <= LOSS_ATOL
    before = jax.tree.leaves(setup["params_np"])
    after_j, after_t = jax.tree.leaves(new_j), tree_leaves(new_t)
    flips, ties = _flip_report(before, after_j, after_t,
                               jax.tree.leaves(setup["grads_j"]), ETA)
    print(f"microbatches={microbatches}: {flips} flips, {ties} ties")
    assert flips > 0
    assert float(m_t["flips"]) == pytest.approx(float(m_j["flips"]), abs=ties)
    for a, b in zip(after_j, after_t):
        if b.dtype != torch.int8:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=FP_ATOL)


def test_batch_at_is_bit_identical_to_the_reference(setup, tmp_path):
    cfg_j, cfg_t = setup["cfg_j"], setup["cfg_t"]
    for step in (0, 1, 17):
        want = jax_pipeline(cfg_j, SEQ, BATCH, seed=3).batch_at(step)
        got = make_pipeline(cfg_t, SEQ, BATCH, seed=3).batch_at(step)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(want[k], got[k])
    path = tmp_path / "tokens.bin"
    np.arange(5000, dtype=np.uint16).tofile(path)
    want = jax_pipeline(cfg_j, SEQ, BATCH, path=str(path)).batch_at(4)
    got = make_pipeline(cfg_t, SEQ, BATCH, path=str(path)).batch_at(4)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k])


def _bits(x):
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) and
                   x.dtype != torch.bfloat16 else
                   (x.view(torch.int16).numpy() if isinstance(x, torch.Tensor)
                    else x))
    return a.view(np.uint16) if a.dtype.name in ("bfloat16", "int16") else a


def test_checkpoints_cross_restore_both_ways(setup, jax_step1, tmp_path):
    """A reference-written checkpoint of trained params and hybrid state
    restores in the port bit for bit; the port writes it back with the same
    manifest (keys, files, dtypes, shapes, crc32 of identical bytes); the
    reference restores the port's checkpoint bit for bit; a corrupted byte
    raises ``CheckpointCorruption``."""
    params_j, state_j, _ = jax_step1
    tree_j = {"params": params_j, "opt": state_j}
    jax_save(tree_j, tmp_path / "ref", 3, sync=True)

    params_t = _params_t(setup)
    template = {"params": params_t,
                "opt": hybrid_optimizer(eta=ETA, fp_lr=FP_LR).init(params_t)}
    tree_t, step = restore_pytree(template, tmp_path / "ref")
    assert step == 3
    leaves_j = jax.tree.leaves(tree_j)
    flat_t = _flatten(tree_t)
    assert len(leaves_j) == len(flat_t)
    assert "opt/.boolean/.accum/blocks/b0/attn/wq/w" in flat_t
    assert "opt/.adam/.step" in flat_t
    for a, b in zip(leaves_j, flat_t.values()):
        np.testing.assert_array_equal(_bits(a), _bits(b))

    save_pytree(tree_t, tmp_path / "port", 3, sync=True)
    man = [json.loads((tmp_path / d / "step_000000003" / "manifest.json")
                      .read_text()) for d in ("ref", "port")]
    assert man[0] == man[1]
    back, _ = jax_restore(jax.tree.map(jnp.zeros_like, tree_j), tmp_path / "port")
    for a, b in zip(leaves_j, jax.tree.leaves(back)):
        np.testing.assert_array_equal(_bits(a), _bits(b))

    leaf = man[1]["leaves"]["params/head/w"]["file"]
    f = tmp_path / "port" / "step_000000003" / leaf
    raw = bytearray(f.read_bytes())
    raw[200] ^= 0x01
    f.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruption):
        restore_pytree(template, tmp_path / "port")


def _loop_parts(setup):
    cfg = setup["cfg_t"]
    params = _params_t(setup)
    opt = hybrid_optimizer(eta=200.0, fp_lr=FP_LR)
    return (make_train_step(cfg, opt, 1), params, opt.init(params),
            make_pipeline(cfg, 16, 2))


def test_train_loop_restart_continues_from_the_saved_step(setup, tmp_path):
    """6 steps with a checkpoint every 5, then a fresh loop restores step 6
    and runs 4 more: the result equals 10 uninterrupted steps bit for bit."""
    step, params, state, pipe = _loop_parts(setup)
    loop1 = TrainLoop(step, params, state, pipe, ckpt_dir=str(tmp_path),
                      ckpt_every=5, log_every=100)
    loop1.run(6, install_signal_handlers=False)
    assert loop1.step == 6
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000005", "step_000000006"]

    step, params, state, pipe = _loop_parts(setup)
    loop2 = TrainLoop(step, params, state, pipe, ckpt_dir=str(tmp_path),
                      ckpt_every=5, log_every=100)
    assert loop2.step == 6
    for a, b in zip(tree_leaves(loop1.params), tree_leaves(loop2.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    loop2.run(4, install_signal_handlers=False)
    assert loop2.step == 10

    step, params, state, pipe = _loop_parts(setup)
    loop3 = TrainLoop(step, params, state, pipe, log_every=100)
    hist = loop3.run(10, install_signal_handlers=False)
    assert hist[6:] == loop2.history and np.isfinite(hist).all()
    for a, b in zip(tree_leaves(loop3.params), tree_leaves(loop2.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_launcher_trains_the_smoke_config_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma2-2b", "--smoke", "--steps", "3", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[train] loss first1-avg" in res.stdout
    assert (tmp_path / "step_000000003" / "manifest.json").exists()
