"""The port's random stream (``serve/sampling.py``) against ``jax.random``
as this jax computes it (threefry2x32, ``jax_threefry_partitionable``):
keys, ``fold_in``, the bits and the uniforms bit for bit, the Gumbels
within the ulps of the two libraries' ``log``, and ``sample_tokens`` under
its three key schemes token for token against the JAX package's, near-ties
counted: both packages draw from the same logits, so a differing token is
allowed only where its score (logits / T + Gumbel) lies within a fixed
bound of the JAX winner's: twice 2^-20 of 1 + |g| + |z|, the Gumbel
tolerance plus the fp32 sum, as ``test_torch_train.py`` holds its ties to a
fixed TIE.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.serve.sampling import logits_all_finite as jax_all_finite
from repro.serve.sampling import sample_tokens as jax_sample
from repro_torch.configs import get_smoke
from repro_torch.serve import sampling as S

torch.set_num_threads(1)

TINY = float(np.finfo(np.float32).tiny)
SEEDS = ([0, 1, 42, 1234567, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1, 2**32,
          2**32 + 9, 2**40 + 7, 2**62 + 3, 2**63 - 1, -1, -5, -2**31,
          -2**31 - 1, -2**40, -2**63]
         + [int(s) for s in np.random.default_rng(0).integers(
             -2**63, 2**63 - 1, 40, dtype=np.int64)])


def _key(seed):
    return np.asarray(jax.random.PRNGKey(seed), np.uint32)


def test_prng_key_bit_exact():
    for seed in SEEDS:
        assert np.array_equal(S.PRNGKey(seed), _key(seed)), seed
        assert S.PRNGKey(seed).dtype == np.uint32
    for seed in (2**63, -2**63 - 1):          # past int64: both refuse
        with pytest.raises(OverflowError):
            jax.random.PRNGKey(seed)
        with pytest.raises(OverflowError):
            S.PRNGKey(seed)


@pytest.mark.parametrize("data", [0, 1, 2, 7, 1000, 2**16 + 3, 2**31 - 1,
                                  2**31, 2**32 - 1])
def test_fold_in_bit_exact(data):
    for seed in SEEDS[::3]:
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        got = S.fold_in(_key(seed), data).numpy()
        assert np.array_equal(got, want.astype(np.int64)), (seed, data)


def test_fold_in_vectorised_over_lanes():
    keys = np.stack([_key(s) for s in SEEDS[:12]])
    steps = np.arange(12) * 977 + 3
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(keys),
                                                   jnp.asarray(steps)))
    got = S.fold_in(keys, steps).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (2,), (7,), (3, 5), (2, 129),
                                   (4, 1000), (2, 3, 17)])
def test_bits_and_uniforms_bit_exact(shape):
    for seed in SEEDS[::5]:
        k = jax.random.PRNGKey(seed)
        bits = np.asarray(jax.random.bits(k, shape)).astype(np.int64)
        assert np.array_equal(S.random_bits(_key(seed), shape).numpy(), bits)
        for lo in (0.0, TINY):
            want = np.asarray(jax.random.uniform(k, shape, minval=lo))
            got = S.uniform(_key(seed), shape, minval=lo).numpy()
            assert got.dtype == np.float32
            assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_per_lane_bits_equal_vmap():
    keys = np.stack([_key(s) for s in SEEDS[:9]])
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (300,)))(
        jnp.asarray(keys))).astype(np.int64)
    assert np.array_equal(S.random_bits(keys, (9, 300)).numpy(), want)


@pytest.mark.parametrize("shape", [(50,), (4, 1000)])
def test_gumbel_within_log_ulps(shape):
    """Bits and uniforms are identical, so the Gumbels differ only by the
    two libraries' log (an ulp on some inputs): within 2^-20 of 1 + |g|,
    and equal on most elements."""
    equal = total = 0
    for seed in SEEDS[::4]:
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
        got = S.gumbel(_key(seed), shape).numpy()
        assert np.all(np.abs(got - want) <= 2.0 ** -20 * (1 + np.abs(want)))
        equal += int((got == want).sum())
        total += want.size
    assert equal > total // 2


def _tie_bound(g, z):
    """Twice a score's noise when both packages draw from the same logits:
    the Gumbels' 2^-20 of 1 + |g| and the fp32 sum's rounding."""
    return 2 * 2.0 ** -20 * (1 + np.abs(g).max() + np.abs(z).max())


def _scaled(lg, temps, V):
    return lg[:, :V] / np.maximum(temps, 1e-6)[:, None].astype(np.float32)


@pytest.fixture(scope="module")
def cfgs():
    return jax_smoke("gemma2-2b"), get_smoke("gemma2-2b")


def _compare(cfgs, logits, temps, key, step, zs):
    """Tokens of both packages; every difference a near-tie. Returns the
    number of near-tie rows among the sampled ones."""
    cj, ct = cfgs
    kj = None if key is None else jnp.asarray(key)
    sj = step if np.isscalar(step) else jnp.asarray(step)
    want = np.asarray(jax_sample(cj, jnp.asarray(logits), jnp.asarray(temps)
                                 if not np.isscalar(temps) else temps, kj, sj))
    got = S.sample_tokens(ct, torch.from_numpy(logits),
                          temps if np.isscalar(temps)
                          else torch.from_numpy(temps), key,
                          step if np.isscalar(step)
                          else torch.from_numpy(step)).numpy()
    assert got.shape == want.shape == (logits.shape[0], 1)
    assert got.dtype == np.int32
    ties = 0
    t = np.broadcast_to(np.asarray(temps, np.float32), logits.shape[:1])
    for row in range(logits.shape[0]):
        if not (t[row] > 0 and zs is not None):
            assert got[row, 0] == want[row, 0], (row, got[row, 0],
                                                 want[row, 0])
            continue
        sc, g_t, g_j = (a[row] for a in zs)
        assert np.all(np.abs(g_t - g_j) <= 2.0 ** -20 * (1 + np.abs(g_j)))
        z = sc + g_j
        bound = _tie_bound(g_j, z)
        top = np.sort(z)[-2:]
        ties += bool(top[1] - top[0] <= bound)
        if got[row, 0] != want[row, 0]:
            off = z.max() - z[[got[row, 0], want[row, 0]]]
            assert (off <= bound).all(), (row, got[row, 0], want[row, 0], off)
    return ties


def test_sample_tokens_greedy(cfgs):
    """No key (or temperature <= 0 as a number): the argmax over the real
    vocab (the padded tail sliced off), the lowest id of a tie."""
    rng = np.random.default_rng(1)
    V = cfgs[1].vocab_size
    lg = rng.standard_normal((6, cfgs[1].vocab_padded + 64)).astype(np.float32)
    lg[:, V:] = 100.0                    # the padded tail never wins
    lg[2, [5, 9]] = 50.0                 # a tie: the lower id
    for temps, key in ((0.0, None), (0.7, None), (0.0, _key(3))):
        assert _compare(cfgs, lg, temps, key, 0, None) == 0
    got = S.sample_tokens(cfgs[1], torch.from_numpy(lg))
    assert got[2, 0] == 5 and int(got.max()) < V


@pytest.mark.parametrize("step", [0, 1, 31, 1000, 2**31 - 1])
def test_sample_tokens_batch_stream(cfgs, step):
    """A (2,) key and a scalar step: one stream for the batch (row b takes
    the b-th vocab-long slice of a (B, V) draw)."""
    V = cfgs[1].vocab_size
    ties = 0
    for seed in (0, 7, 2**33 + 1):
        rng = np.random.default_rng(seed % 1000)
        lg = (3 * rng.standard_normal((5, V))).astype(np.float32)
        for temp in (0.5, 1.0, 2.0):
            key = _key(seed)
            g = np.asarray(jax.random.gumbel(
                jax.random.fold_in(jnp.asarray(key), step), (5, V)))
            sc = _scaled(lg, np.full(5, temp, np.float32), V)
            gt = S.gumbel(S.fold_in(key, step), (5, V)).numpy()
            ties += _compare(cfgs, lg, temp, key, step, (sc, gt, g))
    print(f"batch stream, step {step}: {ties} near-ties")


def test_sample_tokens_per_lane_streams(cfgs):
    """(L, 2) keys and (L,) steps: lane l draws from its own key folded
    with its own step; lanes at temperature <= 0 take the argmax."""
    V = cfgs[1].vocab_size
    rng = np.random.default_rng(5)
    L = 8
    ties = 0
    for trial in range(6):
        lg = (3 * rng.standard_normal((L, V + 5))).astype(np.float32)
        keys = np.stack([_key(int(s)) for s in
                         rng.integers(-2**40, 2**40, L)])
        steps = rng.integers(0, 2**31 - 1, L).astype(np.int32)
        temps = rng.choice([0.0, 0.3, 0.8, 1.7], L).astype(np.float32)
        sc = _scaled(lg, temps, V)
        folded = jax.vmap(jax.random.fold_in)(jnp.asarray(keys),
                                              jnp.asarray(steps))
        g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(folded))
        gt = S.gumbel(S.fold_in(keys, steps), (L, V)).numpy()
        ties += _compare(cfgs, lg, temps, keys, steps, (sc, gt, g))
    print(f"per-lane streams: {ties} near-ties")


def test_logits_all_finite():
    ok = np.zeros((2, 7), np.float32)
    for bad in (np.nan, np.inf, -np.inf):
        arr = ok.copy()
        arr[1, 3] = bad
        assert S.logits_all_finite(torch.from_numpy(arr)) \
            == jax_all_finite(jnp.asarray(arr)) is False
    assert S.logits_all_finite(torch.from_numpy(ok)) \
        == jax_all_finite(jnp.asarray(ok)) is True
