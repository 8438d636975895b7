"""The port's kernels (plain versions, on the CPU) against the JAX package.

Every input is made with numpy from a fixed seed and handed to both sides.
The JAX kernels run as the JAX package's own tests run them: Pallas in
interpret mode. The port's wrappers dispatch by tensor device, so CPU
tensors take the plain versions and the launch counters stay at 0. The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as kops
from repro.kernels import pack_bits as jax_pack_bits
from repro.kernels import unpack_bits as jax_unpack_bits
from repro.kernels.paged_attention import paged_flash_decode as jax_paged_decode
from repro.models import attention as JA
from repro_torch.kernels import (KERNELS, boolean_weight_bwd,
                                 flash_attention_fwd, pack_bits,
                                 packed_xnor_gemv, paged_flash_decode,
                                 paged_prefix_attention, ref, unpack_bits)


def _pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1, -1).astype(np.int8)


@pytest.mark.parametrize("shape,axis", [
    ((100, 7), 0),          # ragged K along the contraction axis (weights)
    ((3, 300, 5), -2),      # stacked groups, ragged K
    ((4, 64), -1),          # K a multiple of 32, packed along the last axis
    ((2, 33, 6), 1),
])
def test_pack_unpack_bit_exact(shape, axis):
    """Words are bitwise equal to the reference's uint32 words (pad bits
    F), and unpacking returns the ±1 input exactly."""
    x = _pm1(np.random.default_rng(0), shape)
    ref_words = np.asarray(jax_pack_bits(jnp.asarray(x), axis=axis))
    words = pack_bits(torch.from_numpy(x), axis=axis)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), ref_words.view(np.int32))
    k = shape[axis]
    back = unpack_bits(words, k, axis=axis).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(jax_unpack_bits(jnp.asarray(ref_words), k, axis=axis)))


@pytest.mark.parametrize("M", [1, 5, 9])
@pytest.mark.parametrize("K", [32, 100, 300])
def test_packed_gemv_plain_matches_jax_kernel(M, K):
    """fp32, rtol=1e-5 / atol=1e-4: the same ±1-weighted sums in another
    association order (|y| stays below ~60 at these K)."""
    rng = np.random.default_rng(M * 1000 + K)
    N = 40
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = _pm1(rng, (K, N))
    wp = np.array(jax_pack_bits(jnp.asarray(w), axis=0))
    want = np.asarray(kops.packed_xnor_gemv(jnp.asarray(x), jnp.asarray(wp),
                                            k_valid=K))
    got = packed_xnor_gemv(torch.from_numpy(x),
                           torch.from_numpy(wp.view(np.int32)), k_valid=K)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), ref.packed_xnor_gemv_ref(torch.from_numpy(x),
                                              torch.from_numpy(w)).numpy(),
        rtol=1e-5, atol=1e-4)


def _decode_inputs(seed, L=4, C=5, page=4, KV=2, R=8, hd=16, n_pages=12):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((L, KV, R, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, KV, hd)).astype(np.float32)
    bt = np.asarray([[3, 1, 7, 0, 0],
                     [2, 5, 9, 11, 4],      # a lane at the table's end
                     [0, 0, 0, 0, 0],       # idle lane: garbage page only
                     [6, 8, 0, 0, 0]], np.int32)
    pos = np.asarray([6, 19, 0, 35], np.int32)   # 35 overruns the table
    return q, kp, vp, bt, pos


def _gather_ref(q, kp, vp, bt, pos, window, softcap, chunk):
    """The JAX package's gather fallback: block-table gather +
    ``_flash_decode_local`` with the given chunk."""
    cfg = types.SimpleNamespace(decode_chunk=chunk, attn_logit_softcap=softcap,
                                sliding_window=window)
    L, C = bt.shape
    page, KV, hd = kp.shape[1:]
    k = jnp.asarray(kp)[bt].reshape(L, C * page, KV, hd)
    v = jnp.asarray(vp)[bt].reshape(L, C * page, KV, hd)
    m, l, acc = JA._flash_decode_local(cfg, jnp.asarray(q), k, v,
                                       jnp.asarray(pos), 0, local=window > 0)
    return np.asarray(acc / jnp.maximum(l[..., None], 1e-30))


@pytest.mark.parametrize("window,softcap,chunk", [
    (0, 0.0, 2048),      # global, no softcap, one chunk
    (0, 50.0, 8),        # softcap, chunk smaller than the window of rows
    (9, 0.0, 2048),      # sliding window
    (7, 30.0, 4),        # window + softcap, chunk smaller than the window
])
def test_paged_decode_plain_matches_jax_kernel(window, softcap, chunk):
    """Mixed lane positions (pos 0, a lane at the table's end, an overrun
    lane), garbage-page rows, window and softcap on/off. fp32, atol=1e-5:
    the plain version takes one softmax over the window where the JAX
    kernel takes ``chunk``-row online steps."""
    q, kp, vp, bt, pos = _decode_inputs(window * 100 + int(softcap) + chunk)
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), window=window, softcap_val=softcap, chunk=chunk,
        interpret=True))
    gather = _gather_ref(q, kp, vp, bt, pos, window, softcap, chunk)
    got = paged_flash_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(pos), window=window,
        softcap_val=softcap)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), gather, rtol=0, atol=1e-5)


def test_window_masks_every_row_of_a_far_overrun_lane():
    """A lane far past its table under a small window has no valid row: the
    reference then averages every row of its table (all weigh exp(0)), and
    so must the port."""
    q, kp, vp, bt, _ = _decode_inputs(7)
    pos = np.asarray([6, 19, 0, 90], np.int32)
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), window=5, softcap_val=0.0, chunk=2048,
        interpret=True))
    got = paged_flash_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(pos), window=5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    lane3 = vp[bt[3]].reshape(-1, *vp.shape[2:]).mean(axis=0)   # (KV, hd)
    np.testing.assert_allclose(got.numpy()[3], np.broadcast_to(
        lane3[:, None], got.shape[1:]), rtol=0, atol=1e-5)


def test_cpu_tensors_never_count_launches():
    for k in KERNELS:
        k.launches = 0
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    w = pack_bits(torch.from_numpy(_pm1(rng, (64, 8))), axis=0)
    packed_xnor_gemv(x, w, k_valid=64)
    q, kp, vp, bt, pos = (torch.from_numpy(a) for a in _decode_inputs(2))
    paged_flash_decode(q, kp, vp, bt, pos)
    boolean_weight_bwd(x, torch.ones((3, 8)))
    qa = torch.from_numpy(rng.standard_normal((4, 10, 16)).astype(np.float32))
    kt = torch.from_numpy(rng.standard_normal((10, 2, 16)).astype(np.float32))
    flash_attention_fwd(qa, qa[:2], qa[:2], n_rep=2)
    paged_prefix_attention(qa, kt, kt, kp, vp, bt[0], 5, 5, 10, n_rep=2)
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS) \
        and len(KERNELS) == 5


def test_wrappers_refuse_what_the_kernels_do_not_take():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 40)).astype(np.float32))
    w = pack_bits(torch.from_numpy(_pm1(rng, (40, 8))), axis=0)
    with pytest.raises(ValueError):
        packed_xnor_gemv(x, w, k_valid=39)
    with pytest.raises(TypeError):
        packed_xnor_gemv(x, w.to(torch.int64), k_valid=40)
    q, kp, vp, bt, pos = (torch.from_numpy(a) for a in _decode_inputs(4))
    with pytest.raises(TypeError):
        paged_flash_decode(q, kp, vp, bt.long(), pos)
    with pytest.raises(ValueError):      # int8 pools need their scales
        paged_flash_decode(q, kp.to(torch.int8), vp.to(torch.int8), bt, pos)
