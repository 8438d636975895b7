"""The port's training core against the JAX package: the weight-backward
kernel's plain version, the ``boolean_dense`` and ``boolean_activation``
backwards, the flip-rule / Adam optimizers and the cosine schedule.

Inputs are made with numpy from fixed seeds and handed to both sides. The
JAX kernel runs as the JAX package's own tests run it, Pallas in interpret
mode; the port's wrapper takes its plain version on CPU tensors. The CUDA
kernel is held against that plain version on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import activation as JACT
from repro.core import boolean_linear as JBL
from repro.core import optimizer as JO
from repro.kernels import ops as kops
from repro_torch.core import boolean_activation, boolean_dense
from repro_torch.core import optimizer as TO
from repro_torch.kernels import (KERNELS, boolean_weight_bwd,
                                 boolean_weight_bwd_plain, ref,
                                 weight_bwd_route)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-width ops are far too small to split among threads: with
    torch's default thread count a smoke train step takes seconds on a
    busy host, with one thread tens of milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pm1(rng, shape, dtype=np.int8):
    return np.where(rng.random(shape) < 0.5, 1, -1).astype(dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# boolean_weight_bwd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,m,n,alpha,x_dtype", [
    (32, 16, 24, 0.0, np.int8),      # the JAX package's own kernel cases
    (100, 64, 32, 0.05, np.int8),
    (7, 130, 5, 0.2, np.int8),
    (50, 40, 70, 0.0, np.float32),   # real x, as the training path feeds it
    (33, 65, 17, 0.9069, np.float32),  # the FFN's fan_in-1 window
])
def test_weight_bwd_plain_matches_jax_kernel(b, m, n, alpha, x_dtype):
    """fp32 vote counts, rtol=1e-5 / atol=1e-4 (the reference kernel's own
    tolerance): the same products summed in another order."""
    rng = np.random.default_rng(b * 7 + m)
    x = _pm1(rng, (b, m)) if x_dtype == np.int8 else \
        rng.standard_normal((b, m)).astype(np.float32)
    z = rng.standard_normal((b, n)).astype(np.float32)
    d = (rng.standard_normal((b, n)) * 10).astype(np.float32)
    want = np.asarray(kops.boolean_weight_bwd(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(d), alpha=alpha,
        block_m=64, block_n=64, block_b=64))
    got = boolean_weight_bwd(_t(x), _t(z), _t(d), alpha=alpha)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), ref.boolean_weight_bwd_ref(_t(x), _t(z), _t(d),
                                                alpha=alpha).numpy(),
        rtol=1e-5, atol=1e-4)


def test_weight_bwd_equals_boolean_dense_votes():
    """The kernel at α = 0 computes the votes of ``boolean_dense``'s
    backward (Eq 5/7), as the JAX package's test pins its kernel."""
    rng = np.random.default_rng(2)
    x = _pm1(rng, (16, 32)).astype(np.float32)
    w = torch.from_numpy(_pm1(rng, (32, 8)).astype(np.float32)).requires_grad_()
    z = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    boolean_dense(_t(x), w, None, False).backward(z)
    y = boolean_weight_bwd(_t(x).to(torch.int8), z, alpha=0.0)
    np.testing.assert_allclose(y.numpy(), w.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_weight_bwd_cpu_counts_no_launch_and_refuses_bad_input():
    for k in KERNELS:
        k.launches = 0
    x, z = torch.ones((4, 3)), torch.ones((4, 5))
    boolean_weight_bwd(x, z)
    assert boolean_weight_bwd.launches == 0
    with pytest.raises(ValueError):
        boolean_weight_bwd(x, torch.ones((5, 5)))
    with pytest.raises(ValueError):
        boolean_weight_bwd(x, z, alpha=0.5)                     # no d
    with pytest.raises(TypeError):
        boolean_weight_bwd(x.to(torch.int32), z)
    with pytest.raises(TypeError):
        boolean_weight_bwd(x, z, z.to(torch.bfloat16), alpha=0.5)
    np.testing.assert_array_equal(
        boolean_weight_bwd_plain(x, z, z, alpha=0.0).numpy(), np.full((3, 5), 4.0))


_BF, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("x_dtype,z_dtype,alpha,bmn,offset,want", [
    (_BF, _BF, 0.0, (64, 2304, 4096), 0, "tensor_cores"),
    (_BF, _BF, 0.0, (1, 8, 16), 0, "tensor_cores"),
    (_BF, _BF, 0.9069, (64, 2304, 4096), 0, "cuda_cores"),  # the tanh' mask
    (_F32, _F32, 0.0, (64, 64, 128), 0, "cuda_cores"),      # fp32 operands
    (torch.int8, _BF, 0.0, (64, 64, 128), 0, "cuda_cores"),  # int8 ±1 x
    (_BF, _F32, 0.0, (64, 64, 128), 0, "cuda_cores"),
    (_BF, _BF, 0.0, (64, 2300, 1024), 0, "cuda_cores"),     # M % 8 != 0
    (_BF, _BF, 0.0, (64, 2304, 1020), 0, "cuda_cores"),     # N % 8 != 0
    (_BF, _BF, 0.0, (64, 64, 128), 1, "cuda_cores"),        # x not 16-byte aligned
    (_BF, _BF, 0.0, (0, 64, 128), 0, "cuda_cores"),         # no tokens
])
def test_weight_bwd_route_choice(x_dtype, z_dtype, alpha, bmn, offset, want):
    """The route of a CUDA launch follows from dtypes, α, shapes and the
    operands' alignment alone (TMA wants 16-byte bases and row strides)."""
    B, M, N = bmn
    x = torch.zeros(B * M + offset, dtype=x_dtype)[offset:].view(B, M)
    z = torch.zeros((B, N), dtype=z_dtype)
    assert (x.data_ptr() % 16 != 0) == (offset != 0)
    assert weight_bwd_route(x, z, alpha) == want


def test_every_training_projection_takes_the_tensor_core_route(monkeypatch):
    """Each Boolean projection of gemma2-2b at its published widths, its
    votes over one microbatch of 1,024 tokens as the training step hands
    them over (the config's bf16, α = 0), takes the tensor-core route."""
    from repro_torch.configs import get_config
    from repro_torch.core import boolean_linear
    from repro_torch.models import attention as TA
    from repro_torch.models import ffn as TF

    shapes = []
    monkeypatch.setattr(TA, "proj_init", lambda g, c, fan_in, fan_out, *a:
                        shapes.append((fan_in, fan_out)))
    monkeypatch.setattr(TF, "proj_init", lambda g, c, fan_in, fan_out, *a:
                        shapes.append((fan_in, fan_out)))
    cfg = get_config("gemma2-2b")
    TA.attention_init(torch.Generator(), cfg)
    TF.ffn_init(torch.Generator(), cfg)
    assert cfg.dtype == torch.bfloat16 and len(shapes) == 7
    for m, n in shapes:
        x = torch.empty((1024, m), dtype=cfg.dtype)
        z = torch.empty((1024, n), dtype=cfg.dtype)
        assert weight_bwd_route(x, z, 0.0) == "tensor_cores", (m, n)
    # and the backward hands the kernel bf16 operands at α = 0
    calls = []

    def spy(x, z, d=None, *, alpha=0.0):
        calls.append((x.dtype, z.dtype, alpha, weight_bwd_route(x, z, alpha)))
        return boolean_weight_bwd(x, z, d, alpha=alpha)

    monkeypatch.setattr(boolean_linear, "boolean_weight_bwd", spy)
    xt = torch.ones((2, 8, 32), dtype=torch.bfloat16, requires_grad=True)
    wt = torch.ones((32, 16), dtype=torch.bfloat16, requires_grad=True)
    boolean_dense(xt, wt).sum().backward()
    assert calls == [(torch.bfloat16, torch.bfloat16, 0.0, "tensor_cores")]


# ---------------------------------------------------------------------------
# boolean_dense backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bwd_norm,sign_backward,bias", [
    (True, False, False),
    (False, False, True),
    (True, True, True),
    (False, True, False),
])
def test_boolean_dense_backward_matches_jax_vjp(bwd_norm, sign_backward, bias):
    """gx, gw and gb against ``jax.vjp`` of the reference custom VJP on the
    same fp32 inputs: rtol=1e-5 / atol=1e-5 (fp32 sums reassociated);
    sign_backward's ±1 must agree exactly away from gx = 0."""
    rng = np.random.default_rng(int(bwd_norm) + 2 * int(sign_backward) + 4 * int(bias))
    B, S, m, n = 3, 5, 24, 40
    x = rng.standard_normal((B, S, m)).astype(np.float32)
    w = _pm1(rng, (m, n)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32) if bias else None
    z = rng.standard_normal((B, S, n)).astype(np.float32)

    def fj(x_, w_, b_):
        return JBL.boolean_dense(x_, w_, b_, bwd_norm, sign_backward)

    args_j = (jnp.asarray(x), jnp.asarray(w),
              None if b is None else jnp.asarray(b))
    y_j, pull = jax.vjp(fj, *args_j)
    gx_j, gw_j, gb_j = pull(jnp.asarray(z))

    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    bt = None if b is None else _t(b).requires_grad_()
    y_t = boolean_dense(xt, wt, bt, bwd_norm, sign_backward)
    y_t.backward(_t(z))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j),
                               rtol=1e-5, atol=1e-5)
    if bias:
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb_j),
                                   rtol=1e-5, atol=1e-5)
    if sign_backward:
        assert set(np.unique(xt.grad.numpy())) <= {-1.0, 1.0}


def test_boolean_dense_bf16_votes_round_to_the_view_dtype():
    """bf16 operands: the fp32 votes are rounded to bf16 where the reference
    rounds them; the two agree to one bf16 rounding of sums taken in
    another order (rtol 2^-7)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    w = _pm1(rng, (32, 16)).astype(np.float32)
    z = rng.standard_normal((64, 16)).astype(np.float32)
    xb, wb, zb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, z))
    _, pull = jax.vjp(lambda x_, w_: JBL.boolean_dense(x_, w_, None), xb, wb)
    gx_j, gw_j = pull(zb)
    xt = _t(x).to(torch.bfloat16).requires_grad_()
    wt = _t(w).to(torch.bfloat16).requires_grad_()
    boolean_dense(xt, wt).backward(_t(z).to(torch.bfloat16))
    assert wt.grad.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(wt.grad.float().numpy(),
                               np.asarray(gw_j, np.float32), rtol=2 ** -7,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(gx_j, np.float32), rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("bwd_norm,sign_backward", [(False, True), (True, False)])
def test_proj_apply_takes_the_config_backward_knobs(bwd_norm, sign_backward):
    """``proj_apply`` hands ``cfg.bwd_norm`` and ``cfg.sign_backward`` to the
    Boolean dense backward, as the reference's does (fp32, 1e-5)."""
    from repro.configs import get_smoke as jax_smoke
    from repro.models import modules as JM
    from repro_torch.configs import get_smoke
    from repro_torch.models import modules as TM

    cfg_j = jax_smoke("gemma2-2b").scaled(dtype=jnp.float32, bwd_norm=bwd_norm,
                                          sign_backward=sign_backward)
    cfg_t = get_smoke("gemma2-2b").scaled(dtype=torch.float32, bwd_norm=bwd_norm,
                                          sign_backward=sign_backward)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = _pm1(rng, (64, 48)).astype(np.float32)
    g = rng.standard_normal((2, 3, 48)).astype(np.float32)
    _, pull = jax.vjp(lambda x_, w_: JM.proj_apply(cfg_j, {"w": w_}, x_),
                      jnp.asarray(x), jnp.asarray(w))
    gx_j, gw_j = pull(jnp.asarray(g))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    TM.proj_apply(cfg_t, {"w": wt}, xt).backward(_t(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# boolean_activation backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tau_shape,fan_in,hard", [
    ((40,), 1, False),          # the FFN's per-channel τ, fan_in 1
    ((), 64, False),            # scalar τ
    ((1, 40), 9, False),        # size-1 axis: keep-dims reduction
    ((5, 1), 1, False),
    ((40,), 1, True),           # hard_backward: identity mask
])
def test_boolean_activation_backward_matches_jax_vjp(tau_shape, fan_in, hard):
    """Forward ±1 exactly; gs and gτ against ``jax.vjp`` of the reference,
    rtol=1e-5 / atol=1e-5 (fp32 tanh and sums in another order)."""
    rng = np.random.default_rng(len(tau_shape) * 10 + fan_in)
    s = rng.standard_normal((3, 5, 40)).astype(np.float32) * 2
    tau = rng.standard_normal(tau_shape).astype(np.float32) * 0.3
    g = rng.standard_normal((3, 5, 40)).astype(np.float32)

    y_j, pull = jax.vjp(lambda s_, t_: JACT.boolean_activation(
        s_, t_, fan_in, hard), jnp.asarray(s), jnp.asarray(tau))
    gs_j, gt_j = pull(jnp.asarray(g))

    st, tt = _t(s).requires_grad_(), _t(tau).requires_grad_()
    y_t = boolean_activation(st, tt, fan_in, hard)
    y_t.backward(_t(g))
    np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
    assert tuple(tt.grad.shape) == tau_shape
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt_j),
                               rtol=1e-5, atol=1e-5)


def test_boolean_activation_number_tau_takes_no_grad():
    s = torch.linspace(-1, 1, 8, requires_grad=True)
    boolean_activation(s, 0.25, 1).sum().backward()
    assert s.grad is not None and s.grad.shape == s.shape


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------
def _opt_trees(rng):
    params = {"blk": {"w": _pm1(rng, (6, 40)), "tau": rng.standard_normal(40)
                      .astype(np.float32)},
              "head": {"w": _pm1(rng, (3, 8, 5))},
              "norm": {"scale": np.ones(8, np.float32)}}
    return params


def _votes(rng, params, scale):
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                        .astype(np.float32), params)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("eta", [0.7, 4.0])
def test_hybrid_optimizer_bit_exact_with_jax(eta):
    """Three steps on identical votes: Boolean params, bf16 accumulators,
    β, flip counts, the Adam state and the FP params all bit-equal."""
    rng = np.random.default_rng(int(eta * 10))
    p_np = _opt_trees(rng)
    jopt = JO.hybrid_optimizer(eta=eta, fp_lr=1e-2)
    topt = TO.hybrid_optimizer(eta=eta, fp_lr=1e-2)
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = jax.tree.map(_t, p_np)
    sj, st = jopt.init(pj), topt.init(pt)
    total_flips = 0
    for _ in range(3):
        g = _votes(rng, p_np, 0.4)
        pj, sj = jopt.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pt, st = topt.update(jax.tree.map(_t, g), st, pt)
        for a, b in zip(jax.tree.leaves(pj), TO.tree_leaves(pt)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in zip(jax.tree.leaves(sj.boolean.accum),
                        TO.tree_leaves(st.boolean.accum)):
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(a), b.view(torch.int16).numpy()
                                          .view(np.uint16))
        for field in ("ratio", "flips"):
            for a, b in zip(jax.tree.leaves(getattr(sj.boolean, field)),
                            TO.tree_leaves(getattr(st.boolean, field))):
                assert np.asarray(a).tobytes() == b.numpy().tobytes(), field
        for field in ("mu", "nu"):
            for a, b in zip(jax.tree.leaves(getattr(sj.adam, field)),
                            TO.tree_leaves(getattr(st.adam, field))):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert int(sj.boolean.step) == int(st.boolean.step)
        assert int(sj.adam.step) == int(st.adam.step)
        total_flips += sum(float(f) for f in TO.tree_leaves(st.boolean.flips))
    assert total_flips > 0


def test_boolean_optimizer_fp32_accum_matches_jax():
    rng = np.random.default_rng(9)
    w = {"w": _pm1(rng, (30, 20))}
    jopt = JO.boolean_optimizer(2.0, accum_dtype=jnp.float32)
    topt = TO.boolean_optimizer(2.0, accum_dtype=torch.float32)
    pj, pt = {"w": jnp.asarray(w["w"])}, {"w": _t(w["w"])}
    sj, st = jopt.init(pj), topt.init(pt)
    for _ in range(4):
        g = rng.standard_normal((30, 20)).astype(np.float32) * 0.5
        pj, sj = jopt.update({"w": jnp.asarray(g)}, sj, pj)
        pt, st = topt.update({"w": _t(g)}, st, pt)
        np.testing.assert_array_equal(np.asarray(pj["w"]), pt["w"].numpy())
        np.testing.assert_array_equal(np.asarray(sj.accum["w"]),
                                      st.accum["w"].numpy())


def test_cosine_schedule_matches_jax_within_one_ulp():
    """η and the FP learning rate come from fp32 ops in the reference's
    order; only the cosine itself may differ by an ulp (torch's cos vs
    XLA's), which scales to at most 2 fp32 ulps of ``base``. Most steps
    agree bit for bit."""
    same = n = 0
    for base, total, warmup, floor in ((4.0, 100, 5, 0.0), (1e-3, 37, 0, 0.1)):
        fj = JO.cosine_schedule(base, total, warmup, floor)
        ft = TO.cosine_schedule(base, total, warmup, floor)
        for step in range(total + 5):
            a = np.float32(fj(jnp.asarray(step, jnp.int32)))
            b = ft(torch.tensor(step, dtype=torch.int32))
            assert b.dtype == torch.float32
            assert abs(float(b) - float(a)) <= 2 * np.spacing(np.float32(base)), \
                (step, a, b)
            same += a.tobytes() == b.numpy().tobytes()
            n += 1
    assert same >= 0.9 * n, (same, n)


def test_is_boolean_leaf_is_int8():
    assert TO.is_boolean_leaf(torch.ones(2, dtype=torch.int8))
    assert not TO.is_boolean_leaf(torch.ones(2))
    assert not TO.is_boolean_leaf(None)
