"""The port's mamba block against the JAX package's ``models/mamba.py`` at
smoke width in fp32, on the same numpy inputs: the causal conv with and
without a carried history, the chunked selective scan at lengths that are
not a multiple of the chunk (with and without an initial state, the states
at chosen positions), the block with a padded length, a carried boundary
state and page-boundary snapshots, the decode step and the lane write.

The scan's doubling order differs from XLA's associative scan, so states
and outputs are held within fp32 reassociation error: STATE_TOL of 1 +
|reference| (a few ulps of fp32 over the <= 128 products of one chunk).
Everything else is elementwise in the same order and held to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import mamba as JM
from repro.models.modules import unzip
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.models import mamba as M

torch.set_num_threads(1)

STATE_TOL = 2e-5
EXACT_TOL = 1e-6


def _configs(**over):
    return (jax_smoke("falcon-mamba-7b").scaled(dtype=jnp.float32, **over),
            get_smoke("falcon-mamba-7b").scaled(dtype=torch.float32, **over))


def _params(cfg_j, seed=0):
    """The JAX package's block init as numpy, with a non-zero conv bias and
    D so every term of the block is exercised."""
    p = jax.tree.map(np.asarray,
                     unzip(JM.mamba_init(jax.random.PRNGKey(seed), cfg_j))[0])
    rng = np.random.default_rng(seed)
    p["conv_b"] = rng.normal(0, 0.3, p["conv_b"].shape).astype(np.float32)
    p["D"] = rng.normal(1, 0.3, p["D"].shape).astype(np.float32)
    return p


def _both(p):
    return jax.tree.map(jnp.asarray, p), bridge.params_from_numpy(p, "cpu")


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("with_history", [False, True])
def test_causal_conv_matches_jax(with_history):
    rng = np.random.default_rng(1)
    B, S, DI, W = 2, 11, 16, 4
    x = rng.standard_normal((B, S, DI)).astype(np.float32)
    w = rng.standard_normal((W, DI)).astype(np.float32)
    b = rng.standard_normal((DI,)).astype(np.float32)
    c0 = rng.standard_normal((B, W - 1, DI)).astype(np.float32) \
        if with_history else None
    want = JM._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           conv0=None if c0 is None else jnp.asarray(c0))
    got = M._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b),
                         conv0=None if c0 is None else torch.from_numpy(c0))
    _close(got, want, EXACT_TOL)


def test_doubling_scan_matches_the_sequential_recurrence():
    """``_scan_chunk`` at every chunk length up to 37 (powers of two and
    not) against h_t = decay_t · h_{t-1} + xbar_t in fp64."""
    rng = np.random.default_rng(2)
    for Q in (1, 2, 3, 7, 8, 16, 37):
        decay = rng.uniform(0.2, 1.0, (2, Q, 3, 4))
        xbar = rng.standard_normal((2, Q, 3, 4))
        h0 = rng.standard_normal((2, 3, 4))
        want, h = [], h0
        for t in range(Q):
            h = decay[:, t] * h + xbar[:, t]
            want.append(h)
        got = M._scan_chunk(*(torch.from_numpy(a) for a in (decay, xbar, h0)))
        np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-12,
                                   atol=1e-12)


def _scan_inputs(B, S, DI, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, DI)).astype(np.float32),
            rng.uniform(1e-3, 0.5, (B, S, DI)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, DI, N)).astype(np.float32))


@pytest.mark.parametrize("S,chunk", [(21, 8), (150, 128), (5, 128)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_ssm_matches_jax(S, chunk, with_h0):
    """y, the final state and the per-position states (at every position)
    at S not a multiple of the chunk; A up to N = 4 per dim, dt up to 0.5:
    decays down to e^-2 a step."""
    cfg_j, cfg_t = _configs()
    pj, pt = _both(_params(cfg_j))
    B, DI, N = 2, cfg_t.d_inner_, cfg_t.ssm_state
    xc, dt, Bm, Cm, h0 = _scan_inputs(B, S, DI, N, S + chunk)
    h0 = h0 if with_h0 else None
    y_j, h_j, hs_j = JM.mamba_ssm(
        cfg_j, pj, *(jnp.asarray(a) for a in (xc, dt, Bm, Cm)),
        None if h0 is None else jnp.asarray(h0), chunk=chunk, return_hs=True)
    y_t, h_t, hs_t = M.mamba_ssm(
        cfg_t, pt, *(torch.from_numpy(a) for a in (xc, dt, Bm, Cm)),
        None if h0 is None else torch.from_numpy(h0), chunk=chunk,
        hs_at=range(1, S + 1))
    _close(y_t, y_j, STATE_TOL, "y")
    _close(h_t, h_j, STATE_TOL, "h")
    _close(hs_t, hs_j, STATE_TOL, "hs")


@pytest.mark.parametrize("length,resume", [(None, False), (13, False),
                                           (13, True), (20, True)])
def test_mamba_apply_matches_jax(length, resume):
    """A block over a 20-row input: right-padded past ``length``, resumed
    from a boundary state (h0, conv0), with snapshots at positions 4, 8,
    12, 16 and 20 (past ``length`` the frozen state; their conv rows are
    garbage the callers drop, so they are not compared there). The state
    equals an unpadded run's."""
    cfg_j, cfg_t = _configs(ssm_chunk=8)
    pj, pt = _both(_params(cfg_j, 3))
    rng = np.random.default_rng(4)
    B, S, D = 2, 20, cfg_t.d_model
    DI, N, W = cfg_t.d_inner_, cfg_t.ssm_state, cfg_t.conv_width
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, DI, N)).astype(np.float32) if resume else None
    c0 = rng.standard_normal((B, W - 1, DI)).astype(np.float32) \
        if resume else None
    at = (4, 8, 12, 16, 20)
    kw_j = dict(h0=None if h0 is None else jnp.asarray(h0),
                conv0=None if c0 is None else jnp.asarray(c0),
                return_state=True, length=length, state_at=at)
    kw_t = dict(h0=None if h0 is None else torch.from_numpy(h0),
                conv0=None if c0 is None else torch.from_numpy(c0),
                return_state=True, length=length, state_at=at)
    out_j, (hj, cj), snap_j = JM.mamba_apply(cfg_j, pj, jnp.asarray(x), **kw_j)
    out_t, (ht, ct), snap_t = M.mamba_apply(cfg_t, pt, torch.from_numpy(x),
                                            **kw_t)
    n = S if length is None else length
    _close(out_t[:, :n], np.asarray(out_j)[:, :n], STATE_TOL, "out")
    _close(ht, hj, STATE_TOL, "h")
    _close(ct, cj, EXACT_TOL, "conv")
    _close(snap_t["h"], snap_j["h"], STATE_TOL, "snap h")
    live = [i for i, b in enumerate(at) if b <= n]
    _close(snap_t["conv"][:, live], np.asarray(snap_j["conv"])[:, live],
           EXACT_TOL, "snap conv")
    if length is not None:                 # the unpadded run's state
        kw_t.update(length=None, state_at=None)
        _, (hu, cu) = M.mamba_apply(cfg_t, pt, torch.from_numpy(x[:, :n]),
                                    **kw_t)
        _close(ht, hu.numpy(), STATE_TOL, "padded vs unpadded h")
        assert torch.equal(ct, cu)


def test_mamba_decode_matches_jax():
    cfg_j, cfg_t = _configs()
    pj, pt = _both(_params(cfg_j, 5))
    rng = np.random.default_rng(6)
    B, D = 3, cfg_t.d_model
    DI, N, W = cfg_t.d_inner_, cfg_t.ssm_state, cfg_t.conv_width
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    cache = {"h": rng.standard_normal((B, DI, N)).astype(np.float32),
             "conv": rng.standard_normal((B, W - 1, DI)).astype(np.float32)}
    out_j, new_j = JM.mamba_decode(cfg_j, pj, jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, cache))
    out_t, new_t = M.mamba_decode(cfg_t, pt, torch.from_numpy(x),
                                  bridge.params_from_numpy(cache, "cpu"))
    _close(out_t, out_j, STATE_TOL, "out")
    _close(new_t["h"], new_j["h"], STATE_TOL, "h")
    _close(new_t["conv"], new_j["conv"], EXACT_TOL, "conv")


def test_cache_init_and_lane_write_match_jax():
    """A zeroed lane pool (n_groups, lanes, ...) with one batch-1 state
    written into lane 2, in place; the other lanes stay as they were."""
    cfg_j, cfg_t = _configs()
    G, lanes = 2, 4
    pool_j = jax.tree.map(lambda a: jnp.broadcast_to(a, (G,) + a.shape),
                          JM.mamba_cache_init(cfg_j, lanes)[0])
    pool_t = M.mamba_cache_init(cfg_t, lanes, "cpu", lead=(G,))
    assert {k: tuple(v.shape) for k, v in pool_t.items()} \
        == {k: v.shape for k, v in pool_j.items()}
    rng = np.random.default_rng(7)
    state = {k: rng.standard_normal((G, 1) + v.shape[2:]).astype(np.float32)
             for k, v in pool_j.items()}
    pool_t["h"][:, 0] = 5.0
    pool_j = dict(pool_j, h=pool_j["h"].at[:, 0].set(5.0))
    want = JM.mamba_cache_lane_write(pool_j, jax.tree.map(jnp.asarray, state),
                                     2)
    got = M.mamba_cache_lane_write(pool_t, bridge.params_from_numpy(
        state, "cpu"), 2)
    assert got is pool_t
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
