"""The port's prefill kernels and its int8 KV cache (plain versions, on the
CPU) against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both sides. The
JAX kernels run as its own tests run them: Pallas in interpret mode. The
port's wrappers dispatch by tensor device, so CPU tensors take the plain
versions and the launch counters stay at 0; ``chip_smoke.py`` holds the
CUDA kernels against these plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.kernels import ops as kops
from repro.kernels import ref as jax_ref
from repro.kernels.paged_attention import paged_flash_decode as jax_paged_decode
from repro.models import attention as JA
from repro.models import lm_init as jax_lm_init
from repro.models import lm_prefill as jax_prefill
from repro.serve import commit_prefill as jax_commit
from repro.serve import paged_pool_init as jax_pool_init
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.kernels import (flash_attention_fwd, flash_attention_plain,
                                 flash_route, paged_flash_decode,
                                 paged_prefix_attention, prefix_route, ref)
from repro_torch.kernels.paged_attention import prefix_split
from repro_torch.models import attention as TA
from repro_torch.models import lm_prefill
from repro_torch.serve import commit_prefill, paged_pool_init


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# kernel #4: flash prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,hd,causal,window,softcap", [
    (128, 64, True, 0, 0.0),
    (256, 64, True, 0, 50.0),       # gemma2 softcap
    (256, 64, True, 64, 0.0),       # sliding window: the block skip binds
    (96, 32, False, 0, 0.0),        # ragged, non-causal
    (64, 16, True, 32, 50.0),       # the smoke configs' head dim and window
])
def test_flash_plain_matches_jax_kernel(s, hd, causal, window, softcap):
    """fp32, rtol = atol = 2e-4 (the JAX package's own kernel-vs-oracle
    tolerance): the same online softmax over other block sizes."""
    rng = np.random.default_rng(s + hd)
    q, k, v = (rng.standard_normal((2, s, hd)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(kops.flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, softcap=softcap, block_q=64, block_k=64))
    got = flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal,
                              window=window, softcap=softcap)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    oracle = np.asarray(jax_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, softcap=softcap))
    np.testing.assert_allclose(
        ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                window=window, softcap=softcap).numpy(),
        oracle, rtol=2e-4, atol=2e-4)


def test_flash_plain_matches_model_flash_with_gqa():
    """The kernel's plain version with the q rows (batch, head) reading KV
    row ``bh // n_rep`` equals the JAX model's chunked ``flash_attention``
    over repeated KV heads (the cold-prefill path). fp32, 2e-4."""
    B, S, H, KV, hd = 2, 128, 4, 2, 32
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    want = np.asarray(JA.flash_attention(
        jnp.asarray(q), JA._repeat_kv(jnp.asarray(k), H // KV),
        JA._repeat_kv(jnp.asarray(v), H // KV), causal=True, window=40,
        softcap_val=50.0, chunk=64))

    def rows(x):
        return _t(x).transpose(1, 2).reshape(-1, S, hd).contiguous()

    got = flash_attention_plain(rows(q), rows(k), rows(v), window=40,
                                softcap=50.0, n_rep=H // KV)
    got = got.reshape(B, H, S, hd).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,window", [(100, 40), (128, 0)])
def test_flash_plain_bf16_matches_model_flash(s, window):
    """The function of the tensor-core route (bf16 k and v) against the
    JAX model's chunked ``flash_attention``, the reference's cold prefill,
    with GQA (4 q over 2 KV heads), gemma2's softcap and a window. q holds
    bf16 values in fp32, so both sides take the dot in fp32 and return fp32
    (hd 64: the scale is a power of two, before or after the dot alike);
    both round p to bf16 before P V, each against its own running max
    (64-key chunks there, 32-key blocks here), so a p_j may be one bf16
    rounding apart (2^-8 of it): atol 2^-8 * max|v| bounds sum |dp| |v| /
    l."""
    B, H, KV, hd = 1, 4, 2, 64
    rng = np.random.default_rng(s + window)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    q = bf(8 * rng.standard_normal((B, s, H, hd)))    # the softcap binds
    k = bf(rng.standard_normal((B, s, KV, hd)))
    v = bf(rng.standard_normal((B, s, KV, hd)))
    want = np.asarray(JA.flash_attention(
        jnp.asarray(q), JA._repeat_kv(jnp.asarray(k, jnp.bfloat16), H // KV),
        JA._repeat_kv(jnp.asarray(v, jnp.bfloat16), H // KV), causal=True,
        window=window, softcap_val=50.0, chunk=64))

    def rows(x):
        return _t(x).transpose(1, 2).reshape(-1, s, hd).contiguous()

    got = flash_attention_plain(rows(q), rows(k).to(torch.bfloat16),
                                rows(v).to(torch.bfloat16), window=window,
                                softcap=50.0, n_rep=H // KV)
    assert got.dtype == torch.float32
    got = got.reshape(B, H, s, hd).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -8 * np.abs(v).max())


def test_flash_plain_rounds_p_only_for_bf16():
    """p is cast to v's dtype before the value product: a no-op for fp32
    (the TPU kernel's fp32 p), bf16 rounding for bf16 v."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.standard_normal((2, 40, 32)).astype(np.float32))
               for _ in range(3))
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    fp = flash_attention_plain(q, kb.float(), vb.float(), softcap=30.0)
    mixed = flash_attention_plain(q, kb, vb, softcap=30.0)
    assert not torch.equal(fp, mixed)
    np.testing.assert_allclose(mixed.numpy(), fp.numpy(), rtol=0,
                               atol=2.0 ** -8 * float(vb.abs().max()))


# ---------------------------------------------------------------------------
# kernel #5: paged prefix attention
# ---------------------------------------------------------------------------
def _prefix_inputs(quant, dtype):
    """The JAX package's parity case: 4 prefix pages of 4 rows bucketed
    with garbage-page padding, a partly live last page, a tail shorter than
    its bucket; H = 2 KV heads x 8."""
    npp, page, KV, n_rep, hd, S, n_pages = 4, 4, 2, 8, 16, 8, 10
    rng = np.random.default_rng(int(quant))
    rnd = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    cast = lambda a: np.asarray(jnp.asarray(a, dtype).astype(jnp.float32))
    q, kt, vt = cast(rnd(KV * n_rep, S, hd)), cast(rnd(S, KV, hd)), \
        cast(rnd(S, KV, hd))
    if quant:
        kp = rng.integers(-127, 128, (n_pages, page, KV, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (n_pages, page, KV, hd)).astype(np.int8)
        ks = rng.uniform(1e-3, 0.1, (n_pages, page, KV)).astype(np.float32)
        vs = rng.uniform(1e-3, 0.1, (n_pages, page, KV)).astype(np.float32)
    else:
        kp, vp = cast(rnd(n_pages, page, KV, hd)), cast(rnd(n_pages, page, KV, hd))
        ks = vs = None
    page_ids = np.asarray([3, 7, 0, 0], np.int32)
    return q, kt, vt, kp, vp, ks, vs, page_ids, n_rep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant,window,softcap,chunk", [
    (False, 0, 0.0, 1024),
    (False, 11, 50.0, 16),      # window + softcap, multi-chunk
    (True, 0, 30.0, 1024),
    (True, 13, 0.0, 8),
])
def test_prefix_plain_matches_jax_kernel(quant, window, softcap, chunk, dtype):
    """Tail queries over [pool prefix pages ; tail K/V] with offset 7,
    prefix_len 7 and a tail of 5 in an 8-row bucket. fp32 inputs: atol
    1e-5 (reassociation only). bf16 inputs: both sides cast p to bf16
    before the value product, and a score that differs by an fp32 ulp can
    round p one bf16 ulp the other way: atol 2^-8 * max|v|."""
    q, kt, vt, kp, vp, ks, vs, page_ids, n_rep = _prefix_inputs(quant, dtype)
    jd = getattr(jnp, dtype)
    sc = lambda a: None if a is None else jnp.asarray(a)
    pool = (lambda a: jnp.asarray(a) if quant else jnp.asarray(a, jd))
    want = np.asarray(kops.paged_prefix_attention(
        jnp.asarray(q, jd), jnp.asarray(kt, jd), jnp.asarray(vt, jd),
        pool(kp), pool(vp), jnp.asarray(page_ids), jnp.asarray(7, jnp.int32),
        jnp.asarray(7, jnp.int32), jnp.asarray(5, jnp.int32), sc(ks), sc(vs),
        n_rep=n_rep, window=window, softcap_val=softcap, chunk=chunk))
    td = getattr(torch, dtype)
    tp = (lambda a: _t(a) if quant else _t(a).to(td))
    tsc = lambda a: None if a is None else _t(a)
    got = paged_prefix_attention(
        _t(q).to(td), _t(kt).to(td), _t(vt).to(td), tp(kp), tp(vp),
        _t(page_ids), 7, 7, 5, tsc(ks), tsc(vs), n_rep=n_rep, window=window,
        softcap_val=softcap, chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    vmax = np.abs(vt).max()
    if quant:
        vmax = max(vmax, float(np.abs(vp.astype(np.float32)
                                      * vs[..., None]).max()))
    atol = 1e-5 if dtype == "float32" else 2.0 ** -8 * vmax
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("quant", [False, True])
def test_gather_prefix_kv_matches_jax(quant):
    """The plain version's gather over a stacked-groups pool block, with
    garbage-page padding: the same fp32 rows as the JAX package, bit for
    bit (int8 rows times their scale is one fp32 product)."""
    q, kt, vt, kp, vp, ks, vs, page_ids, n_rep = _prefix_inputs(quant,
                                                                "float32")
    stack = lambda a: np.stack([a, a[::-1]])            # 2 groups
    block = {"k": stack(kp), "v": stack(vp)}
    if quant:
        block.update(k_scale=stack(ks), v_scale=stack(vs))
    want = JA.gather_prefix_kv(jax_smoke("gemma2-2b").scaled(
        kv_cache_quant=quant), {n: jnp.asarray(a) for n, a in block.items()},
        jnp.asarray(page_ids))
    got = TA.gather_prefix_kv(get_smoke("gemma2-2b").scaled(
        kv_cache_quant=quant), {n: _t(a) for n, a in block.items()},
        _t(page_ids))
    for name in ("k", "v"):
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


# ---------------------------------------------------------------------------
# kernel #2's int8 branch and kv-quant
# ---------------------------------------------------------------------------
def _quant_decode_inputs(seed, L=4, C=5, page=4, KV=2, R=8, hd=16, n_pages=12):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((L, KV, R, hd)).astype(np.float32)
    kp = rng.integers(-127, 128, (n_pages, page, KV, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (n_pages, page, KV, hd)).astype(np.int8)
    ks = rng.uniform(1e-3, 0.1, (n_pages, page, KV)).astype(np.float32)
    vs = rng.uniform(1e-3, 0.1, (n_pages, page, KV)).astype(np.float32)
    bt = np.asarray([[3, 1, 7, 0, 0], [2, 5, 9, 11, 4], [0, 0, 0, 0, 0],
                     [6, 8, 0, 0, 0]], np.int32)
    pos = np.asarray([6, 19, 0, 35], np.int32)      # 35 overruns the table
    return q, kp, vp, ks, vs, bt, pos


@pytest.mark.parametrize("window,softcap,chunk", [
    (0, 0.0, 2048), (0, 50.0, 8), (9, 30.0, 4)])
def test_int8_decode_plain_matches_jax_kernel(window, softcap, chunk):
    """int8 pools dequantised to fp32 (no cast) on both sides; |v| <= 12.7,
    fp32: atol 1e-4 (one softmax against chunked online steps)."""
    q, kp, vp, ks, vs, bt, pos = _quant_decode_inputs(window + chunk)
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), jnp.asarray(ks), jnp.asarray(vs), window=window,
        softcap_val=softcap, chunk=chunk, interpret=True))
    got = paged_flash_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(pos), _t(ks),
                             _t(vs), window=window, softcap_val=softcap)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_bit_exact(dtype):
    """int8 codes and fp32 scales equal the JAX package's bit for bit: rows
    of mixed scale, an all-zero row (the 1e-6 floor), and values exactly
    half-way between codes (round half to even)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 7, 4, 64)).astype(np.float32)
    x *= rng.uniform(1e-3, 50.0, (3, 7, 4, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 3] = np.arange(64, dtype=np.float32) - 31.5   # .5 steps
    x[1, 2, 3, 0] = 127.0                                  # scale exactly 1
    xj = jnp.asarray(x, getattr(jnp, dtype))
    qj, sj = JA.kv_quant(xj)
    qt, st = TA.kv_quant(_t(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype)))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))
    np.testing.assert_array_equal(
        TA.kv_dequant(qt, st).numpy(), np.asarray(JA.kv_dequant(qj, sj)))


# ---------------------------------------------------------------------------
# the models: cold prefill through kernel #4, tail prefill through #5
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke():
    cfg_j = jax_smoke("gemma2-2b").scaled(dtype=jnp.float32)
    cfg_t = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    params_t = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                        "cpu")
    return cfg_j, cfg_t, params_j, params_t


@pytest.mark.parametrize("quant", [False, True])
def test_tail_prefill_logits_and_rows_match_jax(smoke, quant):
    """A 12-token prefix committed to scrambled pages, then an 8-token tail
    (5 real) prefilled at offset 12 over it: logits (fp32, atol 1e-4, as
    the port's model tests) and the tail's cache rows (int8 codes equal
    except where a row's fp32 value sits within an ulp of a rounding
    boundary, counted; scales and fp rows atol 1e-5)."""
    cfg_j, cfg_t, params_j, params_t = smoke
    cfg_j = cfg_j.scaled(kv_cache_quant=quant)
    cfg_t = cfg_t.scaled(kv_cache_quant=quant)
    rng = np.random.default_rng(8)
    page, n_pages, P, T, bucket = 4, 12, 12, 5, 8
    prefix = rng.integers(0, cfg_t.vocab_size, (1, P)).astype(np.int32)
    tail = np.zeros((1, bucket), np.int32)
    tail[0, :T] = rng.integers(0, cfg_t.vocab_size, T)
    ids = np.asarray([9, 2, 5], np.int32)
    _, cj = jax_prefill(cfg_j, params_j, {"tokens": jnp.asarray(prefix)})
    pool_j = jax_commit(cfg_j, jax_pool_init(cfg_j, 1, n_pages, page),
                        cj["blocks"], jnp.asarray(0), jnp.asarray(ids), page)
    _, ct = lm_prefill(cfg_t, params_t, {"tokens": _t(prefix)})
    pool_t = commit_prefill(cfg_t, paged_pool_init(cfg_t, n_pages, page, "cpu"),
                            ct["blocks"], _t(ids), page)
    prefix_ids = np.asarray([9, 2, 5, 0], np.int32)   # pow-2 bucket, garbage pad
    with JA.paged_kernel_override(False):
        lj, tj = jax_prefill(
            cfg_j, params_j, {"tokens": jnp.asarray(tail)}, length=T,
            offset=P, prefix_len=P,
            prefix={"b0": JA.gather_prefix_kv(cfg_j, pool_j["b0"],
                                              jnp.asarray(prefix_ids)),
                    "b1": JA.gather_prefix_kv(cfg_j, pool_j["b1"],
                                              jnp.asarray(prefix_ids))})
    lt, tt = lm_prefill(cfg_t, params_t, {"tokens": _t(tail)}, length=T,
                        offset=P, prefix_len=P, prefix_pages=pool_t,
                        prefix_ids=_t(prefix_ids))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4)
    assert tt["pos"] == int(tj["pos"]) == P + T
    for name, leaf in tt["blocks"]["b1"].items():
        got = leaf[:, :, :T].numpy()
        want = np.asarray(tj["blocks"]["b1"][name])[:, :, :T]
        if leaf.dtype == torch.int8:
            # codes may differ by one only where round() saw a value an ulp
            # from x.5; the rows are otherwise the same
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# wrappers: routes, counters and refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "tensor_cores"), (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 256, "tensor_cores"), (torch.float32, 64, "cuda_cores"),
    (torch.float32, 256, "cuda_cores"),
    (torch.bfloat16, 16, "cuda_cores"),
    (torch.bfloat16, 32, "cuda_cores")])     # a head dim neither is built for
def test_flash_route(dtype, hd, want):
    """bf16 takes the tensor cores at every head dim they are built for
    (64-256), the CUDA-core kernel at the smoke configs' 16 (and at a head
    dim neither is built for, where the wrapper then refuses); fp32 (which
    the tensor cores would round) the CUDA-core kernel."""
    assert flash_route(torch.zeros((4, 8, hd), dtype=dtype)) == want


@pytest.mark.parametrize("dtype,pool,hd,page,want", [
    (torch.bfloat16, torch.bfloat16, 256, 16, "tensor_cores"),
    (torch.bfloat16, torch.int8, 256, 16, "tensor_cores"),
    (torch.bfloat16, torch.bfloat16, 64, 8, "tensor_cores"),
    (torch.bfloat16, torch.int8, 128, 256, "tensor_cores"),
    (torch.bfloat16, torch.bfloat16, 256, 4, "cuda_cores"),    # below a swizzle period
    (torch.bfloat16, torch.int8, 256, 24, "cuda_cores"),       # not a power of two
    (torch.float32, torch.float32, 256, 16, "cuda_cores"),
    (torch.float32, torch.int8, 64, 16, "cuda_cores"),
    (torch.bfloat16, torch.bfloat16, 16, 8, "cuda_cores"),    # smoke head dim
    (torch.bfloat16, torch.int8, 16, 8, "cuda_cores")])
def test_prefix_route(dtype, pool, hd, page, want):
    """bf16 q over bf16 or int8 pools whose pages TMA boxes whole (a power
    of two of at least 8 rows) takes the tensor cores; the rest the
    CUDA-core kernel."""
    q = torch.zeros((4, 8, hd), dtype=dtype)
    assert prefix_route(q, torch.zeros((3, page, 2, hd), dtype=pool)) == want


@pytest.mark.parametrize("H,T,KV,n_tiles,want", [
    (16, 256, 4, 12, 4),      # phase 7: 32 blocks -> 128
    (16, 128, 4, 10, 5),      # 16 blocks, at least two tiles a share
    (16, 32, 4, 9, 4),
    (16, 1024, 4, 24, 1),     # 128 blocks already fill the card
    (8, 16, 8, 1, 1)])        # one tile: no share
def test_prefix_split(H, T, KV, n_tiles, want):
    """Shares of the key window at the H100's 132 SMs and 128-row query
    tiles: one wave of 132 blocks at most, two key tiles a share at
    least."""
    got = prefix_split(H, T, KV, n_tiles, 128, 132)
    blocks = -(-(H // KV) * T // 128) * KV
    assert got == want
    assert got == 1 or (got * blocks <= 132 and 2 * got <= n_tiles)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-14b", "qwen1.5-32b",
                                  "moonshot-v1-16b-a3b",
                                  "arctic-480b", "jamba-1.5-large-398b",
                                  "musicgen-medium", "internvl2-26b",
                                  "bold-bert"])
def test_every_config_has_a_kernel_head_dim(arch):
    """The three attention kernels take every head dim the registry serves:
    the published configs' on both routes, the smoke configs' (16, which
    the examples serve on the card) on the CUDA-core kernels (lanes past
    hd idle; ``csrc/flash_attention.cu``, ``paged_flash_decode.cu``,
    ``paged_prefix_attention.cu``), which every route picks there.
    qwen1.5-110b's smoke config (head dim 8, below one 16-byte int8 pool
    load) has no kernel instance: it is served on the CPU only."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_route
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA

    assert FA._CC_HEAD_DIMS == PA._CC_HEAD_DIMS
    smoke = get_smoke(arch)
    assert smoke.head_dim_ in PA._CC_HEAD_DIMS, smoke.head_dim_
    if arch != "bold-bert":     # fails in the reference too at full width
        assert get_config(arch).head_dim_ in PA._HEAD_DIMS
    hd = smoke.head_dim_
    q = torch.zeros((4, 8, hd), dtype=torch.bfloat16)
    pool = torch.zeros((3, 8, 2, hd), dtype=torch.bfloat16)
    if hd not in PA._HEAD_DIMS:
        assert flash_route(q) == prefix_route(q, pool) == "cuda_cores"
        assert decode_route(q[None, :2, :4], pool) == "cuda_cores"


def test_cpu_tensors_never_count_launches():
    for k in (flash_attention_fwd, paged_prefix_attention, paged_flash_decode):
        k.launches = 0
    for k in (flash_attention_fwd, paged_prefix_attention):
        k.tc_launches = k.cc_launches = 0
    q, kt, vt, kp, vp, ks, vs, page_ids, n_rep = _prefix_inputs(True, "float32")
    paged_prefix_attention(_t(q), _t(kt), _t(vt), _t(kp), _t(vp),
                           _t(page_ids), 7, 7, 5, _t(ks), _t(vs), n_rep=n_rep)
    x = _t(q)
    flash_attention_fwd(x, x[::2].contiguous(), x[::2].contiguous(), n_rep=2)
    qd, kpd, vpd, ksd, vsd, bt, pos = _quant_decode_inputs(1)
    paged_flash_decode(_t(qd), _t(kpd), _t(vpd), _t(bt), _t(pos), _t(ksd),
                       _t(vsd))
    assert (flash_attention_fwd.launches, paged_prefix_attention.launches,
            paged_flash_decode.launches) == (0, 0, 0)
    assert all(k.tc_launches == k.cc_launches == 0
               for k in (flash_attention_fwd, paged_prefix_attention))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(4, 16, 16)
    with pytest.raises(ValueError, match="grad"):       # no backward
        flash_attention_fwd(x.clone().requires_grad_(True), x, x)
    with pytest.raises(ValueError):                     # KV rows != BH/n_rep
        flash_attention_fwd(x, x, x, n_rep=2)
    with pytest.raises(TypeError):
        flash_attention_fwd(x, x.to(torch.bfloat16), x)
    with pytest.raises(TypeError):                      # neither route's dtype
        flash_attention_fwd(*(x.to(torch.float16),) * 3)
    q, kt, vt, kp, vp, ks, vs, page_ids, n_rep = _prefix_inputs(True, "float32")
    args = (_t(q), _t(kt), _t(vt), _t(kp), _t(vp))
    with pytest.raises(ValueError, match="scale"):     # int8 without scales
        paged_prefix_attention(*args, _t(page_ids), 7, 7, 5, n_rep=n_rep)
    with pytest.raises(ValueError, match="scale"):     # scales on a fp pool
        paged_prefix_attention(*args[:3], _t(kt).new_zeros(10, 4, 2, 16),
                               _t(kt).new_zeros(10, 4, 2, 16), _t(page_ids), 7,
                               7, 5, _t(ks), _t(vs), n_rep=n_rep)
    with pytest.raises(TypeError):
        paged_prefix_attention(*args, _t(page_ids).long(), 7, 7, 5, _t(ks),
                               _t(vs), n_rep=n_rep)
    with pytest.raises(ValueError, match="bounds"):     # past the prefix pages
        paged_prefix_attention(*args, _t(page_ids), 7, 17, 5, _t(ks), _t(vs),
                               n_rep=n_rep)
    with pytest.raises(ValueError):                     # H != KV * n_rep
        paged_prefix_attention(*args, _t(page_ids), 7, 7, 5, _t(ks), _t(vs),
                               n_rep=4)
    qd, kpd, vpd, ksd, vsd, bt, pos = _quant_decode_inputs(2)
    with pytest.raises(ValueError, match="scale"):
        paged_flash_decode(_t(qd), _t(kpd), _t(vpd), _t(bt), _t(pos),
                           _t(ksd)[..., :1], _t(vsd))
