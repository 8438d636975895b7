"""The decode kernel's tensor-core route, as far as the CPU reaches it: its
route choice, its shares of the live window (``decode_shares``), and its
reduction -- the plain version's math over each share's rows alone, merged
share by share in split order -- against the JAX kernel.

Inputs are made with numpy from fixed seeds and handed to both sides. The
JAX kernel runs as its own tests run it: Pallas in interpret mode. The
kernel itself is held against the plain version on the card by
``chip_smoke.py`` (phase 2, with exact cases where a wrong page, row, share
or window edge moves an output by whole units).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.paged_attention import paged_flash_decode as jax_paged_decode
from repro_torch.kernels import decode_route, paged_flash_decode
from repro_torch.kernels.paged_attention import (decode_shares, decode_split,
                                                 decode_window)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# (a) the route
# ---------------------------------------------------------------------------
_BF, _I8, _F32 = torch.bfloat16, torch.int8, torch.float32


@pytest.mark.parametrize("q_dtype,pool,hd,R,page,want", [
    (_BF, _BF, 256, 4, 16, "tensor_cores"),    # phase 3: gemma2-2b, bf16 pool
    (_BF, _I8, 256, 4, 16, "tensor_cores"),    # kv-quant
    (_BF, _BF, 64, 1, 8, "tensor_cores"),
    (_BF, _I8, 128, 8, 32, "tensor_cores"),
    (_BF, _BF, 128, 2, 256, "tensor_cores"),
    (_BF, _BF, 128, 6, 16, "tensor_cores"),    # qwen2.5-14b: 48 q / 8 KV heads
    (_BF, _I8, 128, 6, 16, "tensor_cores"),
    (_BF, _BF, 256, 4, 4, "cuda_cores"),       # below a swizzle period
    (_BF, _I8, 256, 4, 12, "cuda_cores"),      # not a power of two
    (_F32, _F32, 256, 4, 16, "cuda_cores"),    # the small fp32 models
    (_F32, _I8, 64, 4, 16, "cuda_cores"),
    (_BF, _BF, 96, 4, 16, "cuda_cores"),       # a head dim neither is built for
    (_BF, _BF, 256, 16, 16, "cuda_cores"),     # a group size neither is built for
    (_BF, _BF, 16, 8, 8, "cuda_cores"),        # the smoke configs' head dim:
    (_BF, _I8, 16, 4, 8, "cuda_cores"),        # the CUDA-core kernel only
])
def test_decode_route(q_dtype, pool, hd, R, page, want):
    """bf16 q over bf16 or int8 pools whose pages TMA boxes whole (a power
    of two of at least 8 rows) at a built head dim and group size takes
    the tensor cores; the rest the CUDA-core kernel (whose wrapper checks
    refuse what neither route is built for)."""
    q = torch.zeros((2, 3, R, hd), dtype=q_dtype)
    assert decode_route(q, torch.zeros((5, page, 3, hd), dtype=pool)) == want


def test_cpu_tensors_count_no_decode_launch():
    """CPU tensors take the plain version on either route's dtypes."""
    rng = np.random.default_rng(0)
    paged_flash_decode.launches = 0
    paged_flash_decode.tc_launches = paged_flash_decode.cc_launches = 0
    bt = _t(np.asarray([[1, 2], [3, 0]], np.int32))
    pos = _t(np.asarray([9, 3], np.int32))
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.from_numpy(rng.standard_normal((2, 1, 2, 64))
                             .astype(np.float32)).to(dtype)
        kp = torch.from_numpy(rng.standard_normal((4, 8, 1, 64))
                              .astype(np.float32)).to(dtype)
        out = paged_flash_decode(q, kp, kp, bt, pos)
        assert out.dtype == torch.float32 and tuple(out.shape) == (2, 1, 2, 64)
    assert (paged_flash_decode.launches, paged_flash_decode.tc_launches,
            paged_flash_decode.cc_launches) == (0, 0, 0)


# ---------------------------------------------------------------------------
# (b) the shares of the live window
# ---------------------------------------------------------------------------
def _valid_rows(pos, page, C, window):
    """Rows the reference weighs: live (in the first min(C, (pos + page) //
    page) pages), at or before pos, inside the window."""
    n_live = max(0, min(C, (pos + page) // page))
    return [k for k in range(n_live * page)
            if k <= pos and (window <= 0 or k > pos - window)], n_live


@settings(max_examples=300, deadline=None)
@given(page=st.sampled_from([4, 8, 12, 16, 32]), C=st.integers(1, 40),
       pos=st.integers(0, 2500), window=st.one_of(st.just(0),
                                                   st.integers(1, 300)),
       nsplit=st.integers(1, 20))
def test_decode_shares_cover_the_valid_rows(page, C, pos, window, nsplit):
    """Every row valid under the reference mask lies in exactly one share;
    the shares are disjoint, contiguous and in split order; none holds a
    page at or past n_live; a lane with no valid row gets all its live
    pages (it averages them, as the reference does); and the shares'
    sizes differ by at most one page."""
    shares = decode_shares(pos, page, C, window, nsplit)
    rows, n_live = _valid_rows(pos, page, C, window)
    assert len(shares) == nsplit
    assert all(c0 <= c1 for c0, c1 in shares)
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    assert shares[-1][1] == n_live and shares[0][0] >= 0
    sizes = [c1 - c0 for c0, c1 in shares]
    assert max(sizes) - min(sizes) <= 1
    for k in rows:
        assert sum(c0 <= k // page < c1 for c0, c1 in shares) == 1
    if not rows:
        assert shares[0][0] == 0
    else:                       # the window's first page starts the range
        assert shares[0][0] == rows[0] // page


@settings(max_examples=300, deadline=None)
@given(page=st.sampled_from([4, 8, 12, 16, 32]), C=st.integers(1, 40),
       pos=st.integers(0, 2500), window=st.one_of(st.just(0),
                                                   st.integers(1, 300)))
def test_decode_window_is_the_reference_mask(page, C, pos, window):
    """decode_window's [lo, hi] is exactly the set of rows the reference
    weighs (what chip_smoke's bound counts), and its n_live the live pages;
    lo > hi only when no row is valid."""
    n_live, lo, hi = decode_window(pos, page, C, window)
    rows, want_live = _valid_rows(pos, page, C, window)
    assert n_live == want_live
    assert list(range(lo, hi + 1)) == rows


# ---------------------------------------------------------------------------
# (c) the route's reduction over the shares, against the JAX kernel
# ---------------------------------------------------------------------------
def _decode_inputs(seed, *, quant=False, L=5, C=5, page=4, KV=2, R=4, hd=16,
                   n_pages=14):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((L, KV, R, hd)).astype(np.float32)
    if quant:
        kp = rng.integers(-127, 128, (n_pages, page, KV, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (n_pages, page, KV, hd)).astype(np.int8)
        ks = rng.uniform(1e-3, 0.05, (n_pages, page, KV)).astype(np.float32)
        vs = rng.uniform(1e-3, 0.05, (n_pages, page, KV)).astype(np.float32)
    else:
        kp = rng.standard_normal((n_pages, page, KV, hd)).astype(np.float32)
        vp = rng.standard_normal((n_pages, page, KV, hd)).astype(np.float32)
        ks = vs = None
    bt = np.asarray([[3, 1, 7, 0, 0],
                     [2, 5, 9, 11, 4],      # a lane at the table's end
                     [0, 0, 0, 0, 0],       # idle lane: garbage page only
                     [6, 8, 10, 12, 13],    # overruns its table
                     [13, 12, 1, 2, 3]],    # far past it: no valid row under
                    np.int32)[:, :C]        # a small window
    rows = C * page
    pos = np.asarray([6, rows - 1, 0, rows + 3, rows + 70], np.int32)
    return q, kp, vp, ks, vs, bt, pos


def _shares_plain(q, kp, vp, ks, vs, bt, pos, *, window, softcap, nsplit):
    """The tensor-core route's reduction with the plain version's math:
    for each lane, each share of ``decode_shares`` alone (its pages'
    rows, dequantised to fp32; scores scaled, softcapped, masked to -1e30;
    its own max m_z, sum l_z and unnormalised acc_z), then the shares
    merged in split order: sum_z w_z acc_z / max(sum_z w_z l_z, 1e-30),
    w_z = exp(m_z - M) over the shares that saw a row."""
    q, kp, vp = (torch.from_numpy(a).double() for a in (q, kp, vp))
    if ks is not None:
        kp = kp * torch.from_numpy(ks).double()[..., None]
        vp = vp * torch.from_numpy(vs).double()[..., None]
    L, KV, R, hd = q.shape
    page, C = kp.shape[1], bt.shape[1]
    out = torch.zeros((L, KV, R, hd), dtype=torch.float64)
    for ln in range(L):
        parts = []
        for c0, c1 in decode_shares(int(pos[ln]), page, C, window, nsplit):
            if c1 == c0:
                continue
            ids = torch.from_numpy(bt[ln, c0:c1].astype(np.int64))
            k = kp[ids].reshape(-1, KV, hd)
            v = vp[ids].reshape(-1, KV, hd)
            s = torch.einsum("grd,cgd->grc", q[ln], k) / math.sqrt(hd)
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            kpos = torch.arange(c0 * page, c1 * page)
            valid = kpos <= int(pos[ln])
            if window > 0:
                valid &= kpos > int(pos[ln]) - window
            s = torch.where(valid, s, torch.full_like(s, -1e30))
            m = s.amax(-1)
            e = torch.exp(s - m[..., None])
            parts.append((m, e.sum(-1), torch.einsum("grc,cgd->grd", e, v)))
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        acc = sum(torch.exp(m - M)[..., None] * a for m, _, a in parts)
        l = sum(torch.exp(m - M) * s for m, s, _ in parts)
        out[ln] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.float()


@pytest.mark.parametrize("window,softcap,nsplit,page,quant", [
    (0, 0.0, 1, 4, False),      # one share: the plain softmax
    (0, 50.0, 3, 4, False),     # softcap, shares of uneven size
    (9, 0.0, 2, 4, False),      # a window: shares start at its first page
    (5, 30.0, 4, 4, False),     # window + softcap, more shares than some
                                # lanes have pages (empty shares)
    (7, 0.0, 6, 8, False),      # 8-row pages
    (0, 50.0, 16, 8, False),    # more shares than any lane has pages
    (6, 50.0, 3, 4, True),      # int8 pools with per-row scales
])
def test_shares_merged_in_order_match_jax_kernel(window, softcap, nsplit,
                                                 page, quant):
    """Lanes at pos 0 (garbage page), mid-table, at the table's end, past
    it, and far past it (no valid row under the window: every live row
    averaged). fp32 pools: atol=1e-5, a split softmax against the JAX
    kernel's single chunk; int8 pools (|v| <= 6.35): atol=1e-4, as the
    int8 plain-version test. The port's plain version agrees with both."""
    q, kp, vp, ks, vs, bt, pos = _decode_inputs(
        window * 100 + nsplit + page, quant=quant, page=page)
    scales = () if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), *scales, window=window, softcap_val=softcap,
        interpret=True))
    got = _shares_plain(q, kp, vp, ks, vs, bt, pos, window=window,
                        softcap=softcap, nsplit=nsplit)
    atol = 1e-4 if quant else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    plain = paged_flash_decode(
        _t(q), _t(kp), _t(vp), _t(bt), _t(pos),
        *(() if ks is None else (_t(ks), _t(vs))), window=window,
        softcap_val=softcap)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# (d) shares from the SM count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L,KV,C,sms,want", [
    (8, 4, 64, 132, 8),       # phase 3: 32 (lane, KV head) pairs, H100 SXM
    (8, 4, 64, 114, 7),       # fewer SMs, fewer shares
    (1, 4, 256, 132, 66),     # one long lane spreads over the card
    (8, 4, 3, 132, 3),        # at most a page a share
    (64, 8, 64, 132, 1),      # 512 pairs already fill the card
])
def test_decode_split_from_sm_count(L, KV, C, sms, want):
    """One wave of at most two blocks an SM: nsplit * L * KV <= 2 * sms,
    nsplit in [1, C]."""
    got = decode_split(L, KV, C, sms)
    assert got == want
    assert 1 <= got <= C
    assert got == 1 or got * L * KV <= 2 * sms
