"""The port's MoE block against the JAX package's ``models/moe.py`` at smoke
width in fp32, on the same numpy inputs and weights: the router (top-k
experts exact; renormalised gates and the load-balancing loss within
ROUTE_TOL, the libraries' softmax differing by ulps), the capacity rule,
both dispatches (GShard einsum and scatter) with and without a capacity
overflow, Boolean and FP experts, and the threshold activation on and off.

Outputs are held within OUT_TOL: the expert sums and the top-k combine
run in fp32 in another order than XLA's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import moe as JMOE
from repro.models.modules import unzip
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.models import moe as MOE

torch.set_num_threads(1)

ROUTE_TOL = 1e-6
OUT_TOL = 1e-5


def _configs(**over):
    return (jax_smoke("moonshot-v1-16b-a3b").scaled(dtype=jnp.float32, **over),
            get_smoke("moonshot-v1-16b-a3b").scaled(dtype=torch.float32,
                                                    **over))


def _params(cfg_j, seed=0):
    p = jax.tree.map(np.asarray,
                     unzip(JMOE.moe_init(jax.random.PRNGKey(seed), cfg_j))[0])
    # a non-zero threshold, so the activation's tau is exercised
    p["tau"] = np.random.default_rng(seed).normal(
        0, 0.3, p["tau"].shape).astype(np.float32)
    return p


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_route_matches_jax():
    cfg_j, cfg_t = _configs(top_k=3)
    p = _params(cfg_j)
    x = _x((40, cfg_t.d_model), 1)
    gj, ej, aj = JMOE._route(cfg_j, jax.tree.map(jnp.asarray, p),
                             jnp.asarray(x))
    gt, et, at = MOE._route(cfg_t, bridge.params_from_numpy(p, "cpu"),
                            torch.from_numpy(x))
    assert np.array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    np.testing.assert_allclose(at.item(), float(aj), rtol=ROUTE_TOL)


def test_capacity_matches_jax():
    for E, k, cf in ((8, 2, 1.25), (64, 6, 1.25), (16, 2, 0.5), (4, 2, 2.0)):
        cfg_j, cfg_t = _configs(n_experts=E, top_k=k, capacity_factor=cf)
        for T in (1, 3, 8, 17, 64, 200, 1000):
            assert MOE._capacity(cfg_t, T) == JMOE._capacity(cfg_j, T), \
                (E, k, cf, T)


def test_group_tokens_matches_jax():
    cfg_j, cfg_t = _configs(moe_groups=2)
    x = _x((4, 3, cfg_t.d_model), 2)
    assert np.array_equal(MOE._group_tokens(cfg_t, torch.from_numpy(x))
                          .numpy(), np.asarray(JMOE._group_tokens(
                              cfg_j, jnp.asarray(x))))


# (impl, capacity_factor, boolean, act_boolean, moe_groups): 64 tokens (32
# a group with 2 groups) over 8 experts at top 2 and capacity factor 0.25
# give C = 8 slots an expert for 128 (64) assignments, so experts overflow
# and drop tokens
CASES = [("einsum", 1.25, True, True, 1), ("scatter", 1.25, True, True, 1),
         ("einsum", 0.25, True, True, 1), ("scatter", 0.25, True, True, 1),
         ("einsum", 1.25, True, False, 1), ("scatter", 0.25, True, False, 2),
         ("einsum", 1.25, False, True, 1), ("scatter", 1.25, False, False, 1),
         ("einsum", 0.25, False, False, 2)]


@pytest.mark.parametrize("impl,cf,boolean,act,groups", CASES)
def test_moe_apply_matches_jax(impl, cf, boolean, act, groups):
    cfg_j, cfg_t = _configs(moe_impl=impl, capacity_factor=cf,
                            boolean=boolean, act_boolean=act,
                            moe_groups=groups)
    p = _params(cfg_j, 3)
    x = _x((4, 16, cfg_t.d_model), 4)
    yj, aj = JMOE.moe_apply(cfg_j, jax.tree.map(jnp.asarray, p),
                            jnp.asarray(x))
    yt, at = MOE.moe_apply(cfg_t, bridge.params_from_numpy(p, "cpu"),
                           torch.from_numpy(x))
    assert yt.dtype == torch.float32 and tuple(yt.shape) == x.shape
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(at.item(), float(aj), rtol=ROUTE_TOL)
    if cf < 1:                  # the overflow case drops some assignments
        T = x.shape[0] * x.shape[1] // groups
        _, experts, _ = MOE._route(cfg_t, bridge.params_from_numpy(p, "cpu"),
                                   torch.from_numpy(x.reshape(-1, x.shape[-1])
                                                    [:T]))
        load = torch.bincount(experts.reshape(-1), minlength=cfg_t.n_experts)
        assert int(load.max()) > MOE._capacity(cfg_t, T)


def test_dispatches_agree_without_overflow():
    """Einsum and scatter dispatch are one function where no expert
    overflows: the port's two against each other."""
    cfg = get_smoke("moonshot-v1-16b-a3b").scaled(dtype=torch.float32,
                                                  capacity_factor=4.0)
    p = bridge.params_from_numpy(_params(_configs()[0], 5), "cpu")
    x = torch.from_numpy(_x((2, 8, cfg.d_model), 6))
    ye, ae = MOE.moe_apply(dataclasses.replace(cfg, moe_impl="einsum"), p, x)
    ys, as_ = MOE.moe_apply(dataclasses.replace(cfg, moe_impl="scatter"), p,
                            x)
    np.testing.assert_allclose(ye.numpy(), ys.numpy(), rtol=OUT_TOL,
                               atol=OUT_TOL)
    assert ae.item() == as_.item()
