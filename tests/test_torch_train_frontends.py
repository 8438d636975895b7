"""One ``make_train_step`` step of the embeddings-frontend archs
(musicgen-medium, internvl2-26b: ``frontend == "embeddings"``, whose batch
holds (B, S, d_model) frame or patch embeddings and labels, no tokens)
against the JAX package's step, on the same bridged smoke weights (fp32)
and a hand-built batch, at η 1000 so that the step flips weights.

Flips identical except ties (the vote within TIE of the threshold,
relative to the leaf's largest vote; counted), the loss within LOSS_ATOL,
the FP leaves within FP_ATOL but where Adam's first step is unsaturated
(|g| near eps: a reassociated grad moves it; counted, at most
ADAM_SPREAD of the FP elements, and within REF_ATOL). The unused
``embed`` table gets no grad from the loss: the port's step zero-fills it
(a documented deviation of the port, whose autograd returns None where
JAX returns zeros), so Adam leaves it and its moments unchanged, as on
the JAX side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core import hybrid_optimizer as jax_hybrid
from repro.models import lm_init as jax_lm_init
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core.optimizer import hybrid_optimizer, tree_leaves
from repro_torch.models import lm_loss
from repro_torch.train import make_train_step
from repro_torch.train.step import bool_view

ARCHS = ("musicgen-medium", "internvl2-26b")
SEQ, BATCH = 16, 4
ETA, FP_LR = 1000.0, 1e-3
# fp32 at smoke width: sums reassociated over two layers
LOSS_ATOL, FP_ATOL = 1e-5, 1e-5
# a flip may part where the vote lies within this of the threshold,
# relative to the leaf's largest vote (test_torch_fsdp_step's rule)
TIE = 1e-4
ADAM_SATURATED, ADAM_SPREAD, REF_ATOL = 0.99 * FP_LR, 0.01, 2 * FP_LR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _batch(d_model, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return {"embeddings": rng.standard_normal((BATCH, SEQ, d_model))
            .astype(np.float32),
            "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_embeddings_step_matches_the_jax_step(arch, micro):
    cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32)
    assert cfg_j.frontend == "embeddings"
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    params_np = jax.tree.map(np.asarray, params_j)
    batch = _batch(cfg_j.d_model, cfg_j.vocab_size)
    opt_j = jax_hybrid(eta=ETA, fp_lr=FP_LR)
    new_j, state_j, m_j = jax.jit(jax_make_train_step(cfg_j, opt_j, micro))(
        params_j, opt_j.init(params_j),
        {k: jnp.asarray(v) for k, v in batch.items()})
    want = _flat(jax.tree.map(np.asarray, new_j))

    cfg = get_smoke(arch).scaled(dtype=torch.float32)
    params = bridge.params_from_numpy(params_np, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # the votes the flip rule reads: the microbatches' mean grads
    n = BATCH // micro
    votes = None
    for i in range(micro):
        pf = bool_view(params, cfg.dtype)
        mb = {k: v[i * n:(i + 1) * n] for k, v in tb.items()}
        g = torch.autograd.grad(lm_loss(cfg, pf, mb)[0], tree_leaves(pf),
                                allow_unused=True)
        embed_grad = dict(zip(sorted(_flat(params)), g))["embed/table"]
        assert embed_grad is None        # the loss never reads the table
        g = [torch.zeros(()) if x is None else x / micro for x in g]
        votes = g if votes is None else [a + b for a, b in zip(votes, g)]
    votes = {k: v.numpy() for k, v in zip(sorted(_flat(params)), votes)}
    opt = hybrid_optimizer(eta=ETA, fp_lr=FP_LR)
    new, state, m = make_train_step(cfg, opt, micro)(params, opt.init(params),
                                                     tb)
    got = {k: v.numpy() for k, v in _flat(new).items()}

    assert abs(float(m["loss"]) - float(m_j["loss"])) <= LOSS_ATOL
    flips = ties = loose = total = 0
    for key, w0 in _flat(params_np).items():
        a, b = want[key], got[key]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if w0.dtype == np.int8:
            flips += int((a != w0).sum())
            differ = a != b
            margin = np.abs(ETA * votes[key] * w0 - 1.0)
            band = TIE * ETA * np.abs(votes[key]).max()
            assert (margin[differ] <= band).all(), (key, margin[differ].min())
            ties += int(differ.sum())
            continue
        total += a.size
        far = np.abs(b - a) > FP_ATOL
        if far.any():
            step = np.abs(a - w0.astype(a.dtype))
            assert (step[far] < ADAM_SATURATED).all(), (
                key, float(np.abs(b - a)[far].max()))
            np.testing.assert_allclose(b, a, rtol=0, atol=REF_ATOL,
                                       err_msg=key)
            loose += int(far.sum())
    assert loose <= ADAM_SPREAD * total, (loose, total)
    assert flips > 0 and ties <= 1e-3 * flips, (flips, ties)
    assert float(m["flips"]) == float(m_j["flips"]) or ties

    # the zero-filled embed grad: the table and its Adam moments untouched,
    # as the JAX step leaves them
    key = "embed/table"
    np.testing.assert_array_equal(got[key], params_np["embed"]["table"])
    np.testing.assert_array_equal(got[key], want[key])
    mu, nu = state.adam.mu["embed"]["table"], state.adam.nu["embed"]["table"]
    assert not mu.any() and not nu.any()
    assert not np.asarray(state_j.adam.mu["embed"]["table"]).any()
    print(f"{arch} x{micro}: loss {float(m['loss']):.6f} (JAX "
          f"{float(m_j['loss']):.6f}), {flips} flips, {ties} ties, {loose} "
          f"unsaturated Adam elements of {total}")
