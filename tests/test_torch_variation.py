"""The port's Boolean variation calculus (paper §3.2 / Appendix A) against
the JAX package's ``core/variation.py``, function by function as
``tests/test_variation.py`` states the truth tables and identities: each
check runs on both packages, and their results agree bit for bit, dtypes
included."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import variation as J
from repro_torch.core import variation as T

B = [-1, 1]  # embedded Booleans


def _same(t, j):
    """A port result equals the reference's: values bit for bit, and the
    same dtype name (python scalars compare as values)."""
    if isinstance(t, torch.Tensor):
        jn = np.asarray(j)
        tn = t.numpy()
        assert tn.dtype == jn.dtype, (tn.dtype, jn.dtype)
        assert tn.shape == jn.shape
        assert np.array_equal(tn.reshape(-1).view(np.uint8),
                              np.ascontiguousarray(jn).reshape(-1)
                              .view(np.uint8))
    else:
        assert t == j and type(t) is type(j)


def test_constants():
    assert (T.TRUE, T.FALSE, T.ZERO) == (J.TRUE, J.FALSE, J.ZERO)
    assert T.BOOL_DTYPE == torch.int8 and J.BOOL_DTYPE == jnp.int8


def test_xnor_xor_truth_tables():
    for a in B:
        for b in B:
            assert T.xnor(a, b) == J.xnor(a, b) == (1 if a == b else -1)
            assert T.xor(a, b) == J.xor(a, b) == (-1 if a == b else 1)
    x = np.array([[1, -1], [-1, 1]], np.int8)
    _same(T.xnor(torch.from_numpy(x), torch.from_numpy(x.T.copy())),
          J.xnor(jnp.asarray(x), jnp.asarray(x.T)))
    _same(T.xor(torch.from_numpy(x), torch.from_numpy(x.T.copy())),
          J.xor(jnp.asarray(x), jnp.asarray(x.T)))


def test_three_valued_logic():
    for a in B + [0]:
        assert T.xnor(a, 0) == 0 and T.xnor(0, a) == 0
    assert T.neg(0) == J.neg(0) == 0
    _same(T.neg(torch.tensor([1, 0, -1], dtype=torch.int32)),
          J.neg(jnp.array([1, 0, -1], jnp.int32)))


def test_projection_embedding_roundtrip():
    xs = np.array([-3.5, -1.0, 0.0, 0.7, 2.0], np.float32)
    p_t, p_j = T.project(torch.from_numpy(xs)), J.project(jnp.asarray(xs))
    _same(p_t, p_j)
    assert np.array_equal(p_t.numpy(), [-1, -1, 0, 1, 1])
    _same(T.embed(p_t), J.embed(p_j))
    _same(T.embed(torch.tensor([1, 0, -1], dtype=torch.int8)),
          J.embed(jnp.array([1, 0, -1], jnp.int8)))
    _same(T.magnitude(torch.from_numpy(xs)), J.magnitude(jnp.asarray(xs)))


def _nonunderflowing():
    mag = st.one_of(st.just(0.0), st.floats(1e-3, 100.0))
    return st.builds(lambda m, s: m * (1 if s else -1), mag, st.booleans())


@settings(max_examples=50, deadline=None)
@given(_nonunderflowing(), _nonunderflowing())
def test_prop_a2_isomorphism(x, y):
    # Prop A.2(1): p(xy) = xnor(p(x), p(y)), on both packages
    xt, yt = torch.tensor(x, dtype=torch.float32), torch.tensor(
        y, dtype=torch.float32)
    lhs = T.project(xt * yt)
    _same(lhs, J.project(jnp.float32(x) * jnp.float32(y)))
    _same(T.xnor(T.project(xt), T.project(yt)),
          J.xnor(J.project(jnp.float32(x)), J.project(jnp.float32(y))))
    assert lhs.item() == T.xnor(T.project(xt), T.project(yt)).item()


def test_prop_a3_mixed_type():
    x = np.array([2.5, -1.25, 0.75], np.float32)
    for a in B:
        _same(T.xnor(a, torch.from_numpy(x)), J.xnor(a, jnp.asarray(x)))
    _same(T.xor(2.0, torch.from_numpy(x)), J.xor(2.0, jnp.asarray(x)))
    np.testing.assert_array_equal(T.xor(2.0, torch.from_numpy(x)).numpy(),
                                  -T.xnor(2.0, torch.from_numpy(x)).numpy())


def _both(fn_t, fn_j, x):
    """fn on an int32 scalar of each package; the results, equal."""
    t = fn_t(torch.tensor(x, dtype=torch.int32))
    j = fn_j(jnp.int32(x))
    _same(t, j)
    return int(t)


def test_example_3_9_xor_variation():
    for a in B:
        for x in B:
            assert _both(lambda u: T.variation_bool(lambda v: T.xor(v, a), u),
                         lambda u: J.variation_bool(lambda v: J.xor(v, a), u),
                         x) == -a


def test_example_3_14_xnor_variation():
    for a in B:
        for x in B:
            assert _both(lambda u: T.variation_bool(lambda v: T.xnor(v, a), u),
                         lambda u: J.variation_bool(lambda v: J.xnor(v, a), u),
                         x) == a


def test_table8_exhaustive():
    rows = [(1, 1, -1), (1, -1, -1), (-1, 1, 1), (-1, -1, 1)]
    for a, x, fprime in rows:
        assert _both(lambda u: T.variation_bool(lambda v: T.xor(a, v), u),
                     lambda u: J.variation_bool(lambda v: J.xor(a, v), u),
                     x) == fprime


def test_negation_rule():
    for a in B:
        for x in B:
            nf = _both(
                lambda u: T.variation_bool(lambda v: T.neg(T.xor(v, a)), u),
                lambda u: J.variation_bool(lambda v: J.neg(J.xor(v, a)), u), x)
            f = _both(lambda u: T.variation_bool(lambda v: T.xor(v, a), u),
                      lambda u: J.variation_bool(lambda v: J.xor(v, a), u), x)
            assert nf == -f


def test_linearity_rules():
    a, alpha = 1, 3.0

    def f_t(x):
        return T.xnor(x, a) * 2.0

    def g_t(x):
        return T.xnor(x, -a) * 5.0

    def f_j(x):
        return J.xnor(x, a) * 2.0

    def g_j(x):
        return J.xnor(x, -a) * 5.0

    for x in B:
        xt, xj = torch.tensor(float(x)), jnp.float32(x)
        fp, gp = T.variation_bool_num(f_t, xt), T.variation_bool_num(g_t, xt)
        _same(fp, J.variation_bool_num(f_j, xj))
        _same(gp, J.variation_bool_num(g_j, xj))
        _same(T.variation_bool_num(lambda u: alpha * f_t(u), xt),
              J.variation_bool_num(lambda u: alpha * f_j(u), xj))
        assert T.variation_bool_num(lambda u: alpha * f_t(u), xt) == alpha * fp
        s = T.variation_bool_num(lambda u: f_t(u) + g_t(u), xt)
        _same(s, J.variation_bool_num(lambda u: f_j(u) + g_j(u), xj))
        assert s == fp + gp


def test_chain_rule_bool_bool():
    for a in B:
        for b in B:
            for x in B:
                lhs = _both(
                    lambda u: T.variation_bool(
                        lambda v: T.xnor(T.xor(v, a), b), u),
                    lambda u: J.variation_bool(
                        lambda v: J.xnor(J.xor(v, a), b), u), x)
                fx = int(T.xor(torch.tensor(x, dtype=torch.int32), a))
                gp = _both(lambda u: T.variation_bool(lambda v: T.xnor(v, b), u),
                           lambda u: J.variation_bool(lambda v: J.xnor(v, b), u),
                           fx)
                fp = _both(lambda u: T.variation_bool(lambda v: T.xor(v, a), u),
                           lambda u: J.variation_bool(lambda v: J.xor(v, a), u),
                           x)
                assert lhs == T.xnor(gp, fp)


def test_example_3_15_neuron_atomic_variation():
    # Eq 4: δs/δw_i = x_i for s = Σ xnor(w_i, x_i); the same ±1 vectors on
    # both sides
    w = np.asarray(J.random_boolean(jax.random.PRNGKey(0), (8,)))
    x = np.asarray(J.random_boolean(jax.random.PRNGKey(1), (8,)))
    for i in range(8):
        xi = int(x[i])
        var = _both(lambda u: T.variation_bool(lambda v: T.xnor(v, xi), u),
                    lambda u: J.variation_bool(lambda v: J.xnor(v, xi), u),
                    int(w[i]))
        assert var == xi


def test_partial_variation_multivariate():
    for x0 in B:
        for x1 in B:
            x = np.array([x0, x1], np.int32)
            for i, want in ((0, x1), (1, x0)):
                t = T.partial_variation(
                    lambda v: T.xnor(v[..., 0], v[..., 1]),
                    torch.from_numpy(x), i)
                j = J.partial_variation(
                    lambda v: J.xnor(v[..., 0], v[..., 1]), jnp.asarray(x), i)
                _same(t, j)
                assert int(t) == want


def test_variation_int():
    assert _both(lambda u: T.variation_int(lambda v: v * v, u),
                 lambda u: J.variation_int(lambda v: v * v, u), 3) == 7


def test_aggregate_vote_counting():
    q = np.array([[1, -1, 1], [1, 1, -1]], np.int32)
    for axis in (0, 1):
        _same(T.aggregate(torch.from_numpy(q), axis=axis),
              J.aggregate(jnp.asarray(q), axis=axis))
    assert np.array_equal(T.aggregate(torch.from_numpy(q), 0).numpy(), [2, 0, 0])


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 64))
def test_random_boolean_is_boolean(n):
    x = T.random_boolean((n,), torch.Generator().manual_seed(n))
    assert T.is_boolean(x) and J.is_boolean(x.numpy())
    assert x.dtype == torch.int8


def test_booleanize_and_is_boolean():
    x = np.array([-0.5, 0.0, 3.0], np.float32)
    out = T.booleanize(torch.from_numpy(x))
    _same(out, J.booleanize(jnp.asarray(x)))
    assert np.array_equal(out.numpy(), [-1, 1, 1])
    for arr in (np.array([1, -1, 1]), np.array([1, 0, -1]),
                np.array([2, -1])):
        assert T.is_boolean(arr) == J.is_boolean(arr)
        assert T.is_boolean(torch.from_numpy(arr)) == J.is_boolean(arr)
