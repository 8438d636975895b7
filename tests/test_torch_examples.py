"""The port's three LM-and-MLP examples (``repro_torch.examples.quickstart``,
``train_lm``, ``serve_lm``) against the JAX package's ``examples/``.

quickstart: one step from the JAX example's own draw (keys 0, 1 and 7,
bridged through numpy) — the loss within 1e-5, the flips identical except
ties at the threshold, counted — and the whole 60-epoch run: the port's
``main`` passes its ``acc > 0.8`` and, from the bridged draw, ends within
ACC_BAND of the JAX example's final accuracy. train_lm: ``main`` reduces
the loss on the CPU, a ``--resume`` run from the step-50 checkpoint takes
the uninterrupted run's losses bit for bit, and on bridged weights the
first steps' losses equal the JAX package's ``make_train_step`` +
``TrainLoop`` over the same pipeline within TRAIN_LOSS_ATOL. serve_lm:
``main`` passes its four checks plain, packed and over an int8 KV cache,
and on bridged weights ``generate`` and ``generate_batch`` emit the JAX
package's ``ServeEngine`` tokens.
"""
import importlib.util
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core import adam as jax_adam
from repro.core import boolean_optimizer as jax_boolean_optimizer
from repro.core import cosine_schedule as jax_cosine
from repro.core import hybrid_optimizer as jax_hybrid
from repro.core import random_boolean as jax_random_boolean
from repro.data import make_pipeline as jax_pipeline
from repro.models import attention as JA
from repro.models import lm_init as jax_lm_init
from repro.serve import ServeEngine as JEngine
from repro.train.loop import TrainLoop as JTrainLoop
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import adam, boolean_optimizer
from repro_torch.examples import quickstart, serve_lm, train_lm
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
# |η·q·w − 1| within fp32 noise of the flip threshold (test_torch_vision)
TIE = 1e-4
LOSS_ATOL = 1e-5
# the final accuracy of the 60-epoch quickstart from the same draw: the
# forward is exact (±1 counts), the votes reassociate, so a flip decision
# may part at a tie; 0.02 is 82 of the 4,096 rows
ACC_BAND = 0.02
# train_lm's first steps on bridged fp32 weights: sums reassociated over
# two layers and a 128-word vocab
TRAIN_LOSS_ATOL = 1e-5
TRAIN_STEPS_COMPARED = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size steps are too small to split among threads, and one
    thread keeps the embedding grad's sums in one order (resume test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_quickstart():
    """The JAX example's module, loaded by path (``examples/`` is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def qs_draw():
    """The JAX example's draw (keys 0, 1, 7) as numpy, and its module."""
    jq = _jax_quickstart()
    params = jq.init(jax.random.PRNGKey(0))
    xs = jax_random_boolean(jax.random.PRNGKey(1), (4096, 64)).astype(
        jnp.float32)
    w_true = jax_random_boolean(jax.random.PRNGKey(7), (64, 4)).astype(
        jnp.float32)
    ys = jnp.argmax(xs @ w_true, axis=-1)
    return jq, jax.tree.map(np.asarray, params), np.asarray(xs), np.asarray(ys)


def _port_draw(params_np, xs, ys):
    return (params_from_numpy(params_np, "cpu"), torch.tensor(xs),
            torch.tensor(ys).long())


def test_quickstart_step_makes_the_reference_flip_decisions(qs_draw):
    """One step of the example from the JAX example's draw: the loss within
    1e-5, flips identical except counted ties, out_scale within 1e-6."""
    jq, params_np, xs, ys = qs_draw
    params_j = jax.tree.map(jnp.asarray, params_np)
    bool_j = {k: v for k, v in params_j.items() if v.dtype == jnp.int8}
    fp_j = {k: v for k, v in params_j.items() if v.dtype != jnp.int8}

    def loss_j(pf):
        logp = jax.nn.log_softmax(jq.forward(pf, jnp.asarray(xs)))
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(ys)[:, None],
                                             1))

    pf = {**{k: v.astype(jnp.float32) for k, v in bool_j.items()}, **fp_j}
    lj, g = jax.value_and_grad(loss_j)(pf)
    bopt_j, fopt_j = jax_boolean_optimizer(eta=8.0), jax_adam(1e-2)
    new_bool_j, _ = bopt_j.update({k: g[k] for k in bool_j},
                                  bopt_j.init(bool_j), bool_j)
    new_fp_j, _ = fopt_j.update({k: g[k] for k in fp_j}, fopt_j.init(fp_j),
                                fp_j)

    params, xs_t, ys_t = _port_draw(params_np, xs, ys)
    bool_t, fp_t = quickstart.split(params)
    before = {k: v.clone() for k, v in bool_t.items()}
    bopt, fopt = boolean_optimizer(eta=8.0), adam(1e-2)
    step = quickstart.make_step(bopt, fopt)
    bstate, _, loss = step(bool_t, fp_t, bopt.init(bool_t), fopt.init(fp_t),
                           xs_t, ys_t)
    assert abs(float(loss) - float(lj)) <= LOSS_ATOL
    flips = ties = 0
    for k, w0 in before.items():
        a, w0 = np.asarray(new_bool_j[k]), w0.numpy()
        flips += int((a != w0).sum())
        differ = a != bool_t[k].numpy()
        margin = np.abs(8.0 * np.asarray(g[k]) * w0 - 1.0)
        assert (margin[differ] <= TIE).all(), (k, margin[differ].min())
        ties += int(differ.sum())
    if not ties:
        assert sum(float(f) for f in bstate.flips.values()) == flips
    np.testing.assert_allclose(fp_t["out_scale"].numpy(),
                               np.asarray(new_fp_j["out_scale"]), rtol=0,
                               atol=1e-6)
    print(f"quickstart step: {flips} flips, {ties} ties")
    assert flips > 0


def test_quickstart_main_passes_on_the_cpu(capsys):
    acc = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert acc > 0.8
    assert out.count("epoch ") == 12 and "final acc" in out


def test_quickstart_run_lands_near_the_reference_run(qs_draw, capsys):
    """60 epochs from the JAX example's draw end within ACC_BAND of the
    JAX example's own run (its ``main``, whose printed final accuracy is
    read back)."""
    jq, params_np, xs, ys = qs_draw
    jq.main()
    acc_j = float(re.search(r"final acc ([0-9.]+)",
                            capsys.readouterr().out)[1])
    params, xs_t, ys_t = _port_draw(params_np, xs, ys)
    bool_t, fp_t, _, hist = quickstart.train(params, xs_t, ys_t, log=None)
    acc = quickstart.accuracy(bool_t, fp_t, xs_t, ys_t)
    print(f"quickstart 60 epochs: port {acc:.4f}, JAX {acc_j:.3f}; "
          f"history {hist}")
    assert acc > 0.8
    # the JAX example prints 3 decimals: half a unit of rounding on top
    assert abs(acc - acc_j) <= ACC_BAND + 5e-4, (acc, acc_j)


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------
def _train_args(tmp, *extra, batch=2):
    return ["--device", "cpu", "--batch", str(batch), "--seq", "32",
            "--ckpt-dir", str(tmp), *extra]


def test_train_lm_main_reduces_the_loss(tmp_path, capsys):
    hist = train_lm.main(_train_args(tmp_path / "ck", "--steps", "30")).history
    assert len(hist) == 30 and all(np.isfinite(hist))
    k = 3
    assert sum(hist[-k:]) < sum(hist[:k])
    out = capsys.readouterr().out
    assert "[example] loss" in out and "[loop] step 20" in out
    assert (tmp_path / "ck" / "step_000000030").is_dir()


def test_train_lm_resume_continues_the_uninterrupted_run(tmp_path, capsys):
    """An uninterrupted 100-step run checkpoints at steps 50 and 100. A
    run that kept only the step-50 checkpoint (as one killed at step 75
    would) and is restarted with the same ``--steps`` and ``--resume``
    starts at step 51 on the same schedules: its first 50 losses are the
    uninterrupted run's steps 51–100 bit for bit (it then runs 50 more
    past the schedules' end, as the JAX example's ``--resume`` does, and
    its ``last < first`` then reads the loss at step 100 against steps
    51–60: batch 8, where the loss still falls between the two)."""
    full = tmp_path / "full"
    hist = train_lm.main(_train_args(full, "--steps", "100", batch=8)).history
    assert sorted(p.name for p in full.iterdir()
                  if p.name.startswith("step_")) == ["step_000000050",
                                                     "step_000000100"]
    cut = tmp_path / "cut"
    cut.mkdir()
    shutil.copytree(full / "step_000000050", cut / "step_000000050")
    capsys.readouterr()
    resumed = train_lm.main(_train_args(cut, "--steps", "100", "--resume",
                                        batch=8)).history
    assert "[loop] restored checkpoint at step 50" in capsys.readouterr().out
    assert len(resumed) == 100 and resumed[:50] == hist[50:100]


def test_train_lm_first_steps_match_the_jax_loop(tmp_path):
    """The example's loop (``make_loop``) on bridged fp32 ``lm_init``
    weights against the JAX package's ``make_train_step`` + ``TrainLoop``
    under the same optimizer and schedules, over the same synthetic
    pipeline: the first TRAIN_STEPS_COMPARED losses within
    TRAIN_LOSS_ATOL."""
    steps, seq, batch = 200, 32, 2
    cfg_j = jax_smoke("qwen2.5-14b").scaled(dtype=jnp.float32)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    params_np = jax.tree.map(np.asarray, params_j)
    warmup = max(steps // 20, 1)
    opt = jax_hybrid(eta=jax_cosine(6.0, steps, warmup=warmup),
                     fp_lr=jax_cosine(2e-3, steps, warmup=warmup))
    loop_j = JTrainLoop(jax.jit(jax_make_train_step(cfg_j, opt, 1)),
                        params_j, opt.init(params_j),
                        jax_pipeline(cfg_j, seq, batch), log_every=1000)
    hist_j = loop_j.run(TRAIN_STEPS_COMPARED)

    cfg = train_lm.config().scaled(dtype=torch.float32)
    loop = train_lm.make_loop(cfg, params_from_numpy(params_np, "cpu"),
                              steps, seq, batch, None, log_every=1000)
    hist = loop.run(TRAIN_STEPS_COMPARED, install_signal_handlers=False)
    print(f"train_lm first steps: port {hist}, JAX {hist_j}")
    np.testing.assert_allclose(hist, hist_j, rtol=0, atol=TRAIN_LOSS_ATOL)


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flags", [[], ["--packed"], ["--kv-quant"]],
                         ids=["plain", "packed", "kv-quant"])
def test_serve_lm_main_passes_its_checks(flags, capsys):
    out = serve_lm.main(["--device", "cpu", "--batch", "2", "--gen", "6",
                         *flags])
    text = capsys.readouterr().out
    for check in ("determinism", "continuous-batching parity",
                  "session streaming parity", "prefix-cache bit-identity"):
        assert f"[serve] {check} check passed" in text
    assert out["generate"].shape == (2, 6)
    assert out["prefix_stats"]["exact_hits"] == 1
    if "--packed" in flags:
        assert "packed serving: resident weights" in text


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
def test_serve_lm_tokens_match_the_jax_engine(packed):
    """On bridged fp32 weights, the JAX example's ``generate`` prompts
    (``randint`` of key 1) and its pool prompts: ``generate`` and
    ``generate_batch`` (3 lanes, 8-row pages, 2-step segments) emit the
    JAX package's ``ServeEngine`` tokens, every one."""
    B, L, gen = 2, 32, 6
    cfg_j = jax_smoke("gemma2-2b").scaled(dtype=jnp.float32)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, L), 0,
                                            cfg_j.vocab_size))
    pool = serve_lm.pool_prompts(L, cfg_j.vocab_size)
    gens = [gen, gen // 2, gen, gen // 2, gen]
    eng_j = JEngine(cfg_j, params_j, max_len=L + gen, packed=packed)
    with JA.paged_kernel_override(False):
        want = np.asarray(eng_j.generate(jnp.asarray(prompts), gen))
        want_batch = [np.asarray(o) for o in eng_j.generate_batch(
            pool, gens, lanes=3, page_size=8, segment=2)]

    cfg = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    eng = ServeEngine(cfg, params_from_numpy(jax.tree.map(np.asarray,
                                                          params_j), "cpu"),
                      max_len=L + gen, packed=packed, device="cpu")
    got = eng.generate(prompts, gen).numpy()
    got_batch = eng.generate_batch(pool, gens, lanes=3, page_size=8,
                                   segment=2)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_batch, want_batch):
        np.testing.assert_array_equal(np.asarray(g), w)
