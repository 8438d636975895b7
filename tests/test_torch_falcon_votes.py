"""falcon-mamba-7b's votes at its published widths against the JAX
package's: one ``make_train_step`` step (2 microbatches) of one mamba block
at d_model 4096, d_inner 8192, dt_rank 256, state 16, conv 4 (the published
config, 1 of its 64 layers; the vocab cut to 1,024, which leaves the
votes' scale as it is: at random init the logits' grad a token has norm
~1 whatever the vocab), fp32, on the same bridged weights and batch.

With η 1 and fp32 accumulators the accumulator after one step is the
vote (β 1, m 0), so both sides' votes are read from the optimizer state:
each Boolean leaf's within VOTE_RTOL of its largest vote, and the largest
vote x weight, which sets the least η at which the first step flips a
weight (η·v·w ≥ 1), within VOTE_RTOL on both sides. That η is the
reference's as much as the port's: at phase 5's η 4 neither side's first
step flips a weight at published widths, which is why the card's
published-width falcon run trains at a larger η.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import hybrid_optimizer as jax_hybrid
from repro.data import make_pipeline as jax_pipeline
from repro.models import lm_init as jax_lm_init
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.optimizer import hybrid_optimizer
from repro_torch.train import make_train_step

SEQ, BATCH, MICRO, VOCAB = 16, 4, 2, 1024
# fp32: a vote sums 32 tokens' terms, each through sums over 4,096-8,192
# reassociated on each side; test_torch_fsdp_step's TIE scale
VOTE_RTOL = 1e-4
LOSS_ATOL = 1e-5
ETA_PHASE5 = 4.0                # chip_smoke.py phase 5's η


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
        elif v is not None:
            out[prefix + k] = v
    return out


def test_published_width_votes_match_the_jax_step():
    over = dict(n_layers=1, vocab_size=VOCAB)
    cfg_j = jax_config("falcon-mamba-7b").scaled(dtype=jnp.float32, **over)
    assert (cfg_j.d_model, cfg_j.d_inner, cfg_j.dt_rank, cfg_j.ssm_state) \
        == (4096, 8192, 256, 16)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    params_np = jax.tree.map(np.asarray, params_j)
    batch = jax_pipeline(cfg_j, SEQ, BATCH).batch_at(0)
    opt_j = jax_hybrid(eta=1.0, fp_lr=1e-3, accum_dtype=jnp.float32)
    _, state_j, m_j = jax.jit(jax_make_train_step(cfg_j, opt_j, MICRO))(
        params_j, opt_j.init(params_j),
        {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: np.asarray(v) for k, v in _flat(state_j.boolean.accum).items()}
    del params_j, state_j

    cfg = get_config("falcon-mamba-7b").scaled(dtype=torch.float32, **over)
    params = bridge.params_from_numpy(params_np, "cpu")
    opt = hybrid_optimizer(eta=1.0, fp_lr=1e-3, accum_dtype=torch.float32)
    _, state, m = make_train_step(cfg, opt, MICRO)(
        params, opt.init(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    got = {k: v.numpy() for k, v in _flat(state.boolean.accum).items()}

    assert abs(float(m["loss"]) - float(m_j["loss"])) <= LOSS_ATOL
    # η 1 flips nothing: each accumulator is its leaf's vote
    assert float(m["flips"]) == float(m_j["flips"]) == 0.0
    assert sorted(got) == sorted(want) and len(want) == 5, sorted(want)
    weights = _flat(params_np)
    reach = {}
    for key, a in want.items():
        b = got[key]
        assert a.shape == b.shape, key
        top = np.abs(a).max()
        assert top > 0, key
        np.testing.assert_allclose(b, a, rtol=0, atol=VOTE_RTOL * top,
                                   err_msg=key)
        w = weights[key].astype(np.float32)
        reach[key] = (float((a * w).max()), float((b * w).max()))
    ref, port = (max(r[i] for r in reach.values()) for i in (0, 1))
    assert abs(port - ref) <= VOTE_RTOL * ref, (port, ref)
    # the least η at which the first step flips a weight, on both sides;
    # phase 5's η is far below it
    assert ETA_PHASE5 * max(ref, port) < 1.0, (ref, port)
    print(f"falcon-mamba-7b, 1 of 64 layers at published widths, {BATCH} x "
          f"{SEQ} tokens in {MICRO} microbatches: largest vote x weight by "
          "leaf (JAX, port) "
          + ", ".join(f"{k.split('/')[-2]} {a:.4g} {b:.4g}"
                      for k, (a, b) in reach.items())
          + f"; the first step's first flip needs eta >= {1 / ref:.4g} "
          f"(JAX), {1 / port:.4g} (port)")
