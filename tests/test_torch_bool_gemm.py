"""The port's ±1 GEMMs (plain versions, on the CPU) against the JAX package:
``boolean_matmul`` (int8 ±1 counts, or the fused threshold) and
``packed_xnor_matmul`` (XNOR-popcount over packed words), and the int8
routes of ``boolean_dense_inference``.

Every input is made with numpy from a fixed seed and handed to both sides.
The JAX kernels run as the JAX package's own tests run them, Pallas in
interpret mode, with small blocks so that ragged shapes cross several
blocks. Every comparison is bit-exact: the outputs are integer counts or ±1.
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PackedBool as JPackedBool
from repro.core import boolean_dense_inference as jax_dense_inference
from repro.kernels import ops as kops
from repro.kernels import pack_bits as jax_pack_bits
from repro_torch.core import boolean_dense_inference, pack_boolean_weight
from repro_torch.kernels import (KERNELS, boolean_matmul, boolean_matmul_operands,
                                 boolean_matmul_plain, pack_bits,
                                 packed_xnor_matmul, packed_xnor_matmul_plain,
                                 ref)


def _pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1, -1).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _words(a):
    """The reference's uint32 words as the port's int32 words."""
    return torch.from_numpy(np.array(a).view(np.int32))


# the JAX package's own kernel shapes (tests/test_kernels.py) and ragged ones
GEMM_SHAPES = [(8, 16, 8), (128, 128, 128), (256, 512, 384), (100, 130, 70),
               (1, 256, 8), (37, 100, 61), (130, 33, 129)]


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_boolean_matmul_counts_match_jax_kernel(m, k, n):
    rng = np.random.default_rng(m * 31 + k * 7 + n)
    x, w = _pm1(rng, (m, k)), _pm1(rng, (k, n))
    want = np.asarray(kops.boolean_matmul(jnp.asarray(x), jnp.asarray(w),
                                          block_m=32, block_n=32, block_k=32))
    got = boolean_matmul(_t(x), _t(w))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.boolean_matmul_ref(_t(x), _t(w)).numpy())
    # counts lie in [-K, K] with the parity of K
    assert np.all(np.abs(want) <= k) and np.all((want - k) % 2 == 0)


@pytest.mark.parametrize("tau", [0.0, 3.0, -5.0, 0.5, -0.5, 2.0])
@pytest.mark.parametrize("m,k,n", [(64, 96, 48), (37, 100, 61)])
def test_boolean_matmul_fused_threshold_matches_jax_kernel(m, k, n, tau):
    """τ on a count (even K: counts are even, so τ = 2 sits on one) and
    between counts; ±1 int8 out."""
    rng = np.random.default_rng(int(10 * tau) + 100 + m)
    x, w = _pm1(rng, (m, k)), _pm1(rng, (k, n))
    want = np.asarray(kops.boolean_matmul(
        jnp.asarray(x), jnp.asarray(w), fuse_threshold=True, tau=tau,
        block_m=32, block_n=32, block_k=32))
    got = boolean_matmul(_t(x), _t(w), fuse_threshold=True, tau=tau)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    counts = boolean_matmul(_t(x), _t(w)).numpy()
    np.testing.assert_array_equal(got.numpy(), np.where(counts >= tau, 1, -1))
    if tau == 2.0 and k % 2 == 0:
        assert (counts == 2).any()           # the threshold sits on a count


def test_boolean_matmul_zero_entries_add_nothing():
    """im2col pads with 0: a zero column of x, or zero rows of w, add
    nothing, as the JAX kernel's zero K padding."""
    rng = np.random.default_rng(5)
    x, w = _pm1(rng, (20, 50)), _pm1(rng, (50, 9))
    x[:, 10:17] = 0
    w[30:40] = 0
    want = np.asarray(kops.boolean_matmul(jnp.asarray(x), jnp.asarray(w),
                                          block_m=16, block_n=16, block_k=16))
    np.testing.assert_array_equal(boolean_matmul(_t(x), _t(w)).numpy(), want)


@pytest.mark.parametrize("m,k,n,tau", [
    (37, 100, 70, 0.0), (130, 405, 70, 3.0), (200, 100, 129, -5.0),
    (5, 16, 3, 0.0), (129, 1152, 64, 0.5)])
def test_boolean_matmul_operands_then_plain_match_jax_kernel(m, k, n, tau):
    """The kernel's operands (wᵀ, K zero-padded to a multiple of 16)
    through the plain version equal the JAX kernel in interpret mode, bit
    for bit, counts and the fused threshold, at ragged shapes."""
    rng = np.random.default_rng(m * 13 + k * 3 + n)
    x, w = _pm1(rng, (m, k)), _pm1(rng, (k, n))
    xk, wt = boolean_matmul_operands(_t(x), _t(w))
    kp = -(-k // 16) * 16
    assert tuple(xk.shape) == (m, kp) and tuple(wt.shape) == (n, kp)
    assert xk.is_contiguous() and wt.is_contiguous() and wt.dtype == torch.int8
    assert not xk[:, k:].any() and not wt[:, k:].any()
    np.testing.assert_array_equal(wt[:, :k].numpy(), w.T)
    for fuse in (False, True):
        want = np.asarray(kops.boolean_matmul(
            jnp.asarray(x), jnp.asarray(w), fuse_threshold=fuse, tau=tau,
            block_m=32, block_n=32, block_k=32))
        got = boolean_matmul_plain(xk, wt.t(), fuse_threshold=fuse, tau=tau)
        np.testing.assert_array_equal(got.numpy(), want)


def test_boolean_matmul_operands_align_x():
    """TMA reads x from a 16-byte-aligned base: an unaligned view is copied,
    an aligned one with K a multiple of 16 is passed through."""
    rng = np.random.default_rng(4)
    flat = _t(_pm1(rng, (1 + 8 * 32,)))
    w = _t(_pm1(rng, (32, 5)))
    x_off = flat[1:].view(8, 32)
    xk, _ = boolean_matmul_operands(x_off, w)
    assert x_off.data_ptr() % 16 != 0 and xk.data_ptr() % 16 == 0
    assert torch.equal(xk, x_off)
    x_al = flat[:-1].view(8, 32)
    assert boolean_matmul_operands(x_al, w)[0] is x_al


@pytest.mark.parametrize("m,k,n", [(16, 32, 16), (64, 256, 64), (33, 70, 9),
                                   (1, 512, 128), (40, 100, 33), (7, 33, 5)])
def test_packed_xnor_matmul_matches_jax_kernel(m, k, n):
    rng = np.random.default_rng(m + 3 * k + 11 * n)
    x, w = _pm1(rng, (m, k)), _pm1(rng, (k, n))
    xp = jax_pack_bits(jnp.asarray(x), axis=-1)
    wp = jax_pack_bits(jnp.asarray(w), axis=0)
    want = np.asarray(kops.packed_xnor_matmul(xp, wp, k_valid=k, block_m=32,
                                              block_n=32, block_kw=2))
    got = packed_xnor_matmul(_words(xp), _words(wp), k_valid=k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), ref.packed_xnor_matmul_ref(_t(x), _t(w)).numpy())
    # the port's packing gives the same words
    np.testing.assert_array_equal(
        packed_xnor_matmul(pack_bits(_t(x), -1), pack_bits(_t(w), 0),
                           k_valid=k).numpy(), want)


def test_packed_xnor_matmul_is_the_popcount_formula_for_any_pad_bits():
    """k_valid − 2·popcount(x XOR w) over every word, whatever the pad bits
    hold (here T on x, so the ±1 product is not what comes out)."""
    rng = np.random.default_rng(9)
    m, kw, n, k_valid = 6, 3, 5, 70
    x = rng.integers(0, 2 ** 32, (m, kw), dtype=np.uint64).astype(np.uint32)
    w = rng.integers(0, 2 ** 32, (kw, n), dtype=np.uint64).astype(np.uint32)
    xor = x[:, :, None] ^ w[None, :, :]
    pop = np.unpackbits(xor.view(np.uint8).reshape(m, kw, n, 4), axis=-1) \
        .sum(axis=(1, 3))
    want = k_valid - 2 * pop.astype(np.int64)
    got = packed_xnor_matmul_plain(_words(x), _words(w), k_valid=k_valid)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(kops.packed_xnor_matmul(
        jnp.asarray(x), jnp.asarray(w), k_valid=k_valid, block_m=8,
        block_n=8, block_kw=1)), want)


@pytest.mark.parametrize("m,k,n", [(24, 100, 20), (5, 64, 7), (50, 31, 40)])
def test_packed_equals_int8_kernel(m, k, n):
    """The two kernel families compute the same Boolean algebra (the JAX
    package's test_packed_equals_int8_kernel)."""
    rng = np.random.default_rng(m * k)
    x, w = _t(_pm1(rng, (m, k))), _t(_pm1(rng, (k, n)))
    y8 = boolean_matmul(x, w)
    yp = packed_xnor_matmul(pack_bits(x, -1), pack_bits(w, 0), k_valid=k)
    np.testing.assert_array_equal(y8.numpy(), yp.numpy())


@pytest.mark.parametrize("lead", [(7,), (2, 5), (300,)])
@pytest.mark.parametrize("bias", [False, True])
def test_dense_inference_int8_routes_match_jax(lead, bias):
    """int8 ±1 x against an int8 weight: int32 counts (the reference's
    plain route and, for 2-D x, its kernel route); against a PackedBool weight: fp32 counts, as both of the
    reference's branches (its GEMV at ≤ 256 rows, the unpacked product
    above) return them."""
    rng = np.random.default_rng(sum(lead) + bias)
    m, n = 45, 19
    x, w = _pm1(rng, (*lead, m)), _pm1(rng, (m, n))
    b = rng.standard_normal((n,)).astype(np.float32) if bias else None
    bj = None if b is None else jnp.asarray(b)
    bt = None if b is None else _t(b)
    want8 = np.asarray(jax_dense_inference(jnp.asarray(x), jnp.asarray(w), bj))
    got = boolean_dense_inference(_t(x), _t(w), bt)
    assert got.dtype == torch.int32 and got.numpy().dtype == want8.dtype
    np.testing.assert_array_equal(got.numpy(), want8)
    if len(lead) == 1:      # the reference's kernel route takes 2-D x only
        np.testing.assert_array_equal(np.asarray(jax_dense_inference(
            jnp.asarray(x), jnp.asarray(w), bj, use_kernel=True)), want8)
    jw = JPackedBool(jax_pack_bits(jnp.asarray(w), axis=-2), m)
    wantp = np.asarray(jax_dense_inference(jnp.asarray(x), jw, bj))
    got = boolean_dense_inference(_t(x), pack_boolean_weight(_t(w)), bt)
    assert got.dtype == torch.float32 and wantp.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), wantp)


def test_cpu_tensors_count_no_launches_and_bad_input_raises():
    for k in KERNELS:
        k.launches = 0
    rng = np.random.default_rng(2)
    x, w = _t(_pm1(rng, (9, 40))), _t(_pm1(rng, (40, 6)))
    boolean_matmul(x, w, fuse_threshold=True)
    packed_xnor_matmul(pack_bits(x, -1), pack_bits(w, 0), k_valid=40)
    assert boolean_matmul.launches == 0 and packed_xnor_matmul.launches == 0
    with pytest.raises(TypeError):
        boolean_matmul(x.to(torch.int32), w)
    with pytest.raises(ValueError):
        boolean_matmul(x, w[:39])
    with pytest.raises(ValueError):
        boolean_matmul(x[None], w)
    with pytest.raises(TypeError):
        packed_xnor_matmul(pack_bits(x, -1).to(torch.int64), pack_bits(w, 0),
                           k_valid=40)
    with pytest.raises(ValueError):
        packed_xnor_matmul(pack_bits(x, -1), pack_bits(w, 0), k_valid=65)
    with pytest.raises(ValueError):
        boolean_matmul_plain(torch.zeros((1, 1 << 24), dtype=torch.int8),
                             torch.zeros((1 << 24, 1), dtype=torch.int8))
