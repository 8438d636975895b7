"""The port's model modules against the JAX package, at gemma2-2b smoke width
in fp32, on the same bridged weights.

Weights come from the JAX package's ``lm_init`` and cross leaf by leaf as
numpy (``repro_torch.bridge``); activations are made with numpy from fixed
seeds. Both sides sum in fp32 in different orders, so float results agree
to a stated tolerance; packed words agree bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import attention as JA
from repro.models import ffn as JF
from repro.models import lm_decode_step_paged as jax_decode_paged
from repro.models import lm_init as jax_lm_init
from repro.models import lm_prefill as jax_prefill
from repro.models import modules as JM
from repro.serve import commit_prefill as jax_commit
from repro.serve import pack_weights as jax_pack_weights
from repro.serve import paged_pool_init as jax_pool_init
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core import PackedBool
from repro_torch.models import attention as TA
from repro_torch.models import ffn as TF
from repro_torch.models import lm_decode_step_paged, lm_prefill
from repro_torch.models.lm import index_tree
from repro_torch.models import modules as TM
from repro_torch.serve import commit_prefill, pack_weights, paged_pool_init

# fp32 at smoke width: differences are reassociation ulps amplified through
# at most 4 layers of unit-scale activations
ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_smoke("gemma2-2b").scaled(dtype=jnp.float32)
    cfg_t = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    params_np = jax.tree.map(np.asarray, params_j)
    params_t = bridge.params_from_numpy(params_np, "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_config_derived_sizes_match():
    for arch_cfg in ("SMOKE", "CONFIG"):
        import repro.configs.gemma2_2b as jmod
        import repro_torch.configs.gemma2_2b as tmod
        cj, ct = getattr(jmod, arch_cfg), getattr(tmod, arch_cfg)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "sliding_window", "attn_logit_softcap",
                  "final_logit_softcap", "group_size", "attn_chunk",
                  "rope_theta"):
            assert getattr(cj, f) == getattr(ct, f), f
        assert (cj.head_dim_, cj.heads_padded(), cj.kv_heads_padded(),
                cj.vocab_padded, cj.n_groups) == \
            (ct.head_dim_, ct.heads_padded(), ct.kv_heads_padded(),
             ct.vocab_padded, ct.n_groups)
    assert ct.dtype == torch.bfloat16


def test_bridge_keeps_tree_dtypes_and_stacking(setup):
    _, cfg_t, params_j, params_t = setup
    wq = params_t["blocks"]["b0"]["attn"]["wq"]["w"]
    assert wq.dtype == torch.int8
    assert tuple(wq.shape) == (cfg_t.n_groups, cfg_t.d_model,
                               cfg_t.heads_padded() * cfg_t.head_dim_)
    np.testing.assert_array_equal(
        wq.numpy(), np.asarray(params_j["blocks"]["b0"]["attn"]["wq"]["w"]))
    assert params_t["head"]["w"].dtype == torch.float32
    bf = bridge.params_from_numpy(
        {"x": np.asarray(jnp.arange(4, dtype=jnp.bfloat16))}, "cpu")["x"]
    assert bf.dtype == torch.bfloat16 and bf.tolist() == [0, 1, 2, 3]


def test_pack_weights_bit_equal(setup):
    _, _, params_j, params_t = setup
    pj = jax_pack_weights(params_j)
    pt = pack_weights(params_t)
    for bi in ("b0", "b1"):
        for sub, name in (("attn", "wqkv"), ("attn", "wo"), ("ffn", "wgu"),
                          ("ffn", "wd")):
            wj, wt = pj["blocks"][bi][sub][name]["w"], \
                pt["blocks"][bi][sub][name]["w"]
            assert isinstance(wt, PackedBool) and wt.k == wj.k
            np.testing.assert_array_equal(
                wt.bits.numpy(), np.asarray(wj.bits).view(np.int32))
        assert set(pt["blocks"][bi]["attn"]) == {"wqkv", "wo"}


def test_rmsnorm_and_rope(setup):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal((64,)).astype(np.float32)
    np.testing.assert_allclose(
        TM.rmsnorm_apply({"scale": _t(scale)}, _t(x)).numpy(),
        _np(JM.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        rtol=0, atol=1e-5)
    xr = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    positions = rng.integers(0, 500, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        TM.rope(_t(xr), _t(positions), 10_000.0).numpy(),
        _np(JM.rope(jnp.asarray(xr), jnp.asarray(positions), 10_000.0)),
        rtol=0, atol=1e-4)   # |angle| up to ~500 rad: cos/sin argument ulps


@pytest.mark.parametrize("rows", [3, 300])   # GEMV and the unpacked matmul
def test_packed_proj_apply(setup, rows):
    cfg_j, cfg_t, params_j, params_t = setup
    pj = jax_pack_weights(params_j)["blocks"]["b0"]["ffn"]["wd"]
    pt = pack_weights(params_t)["blocks"]["b0"]["ffn"]["wd"]
    x = np.random.default_rng(1).standard_normal((rows, 128)).astype(np.float32)
    want = JM.proj_apply(cfg_j, {"w": jax.tree.map(lambda a: a[0], pj["w"])},
                         jnp.asarray(x))
    got = TM.proj_apply(cfg_t, index_tree(pt, 0), _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("packed", [False, True])
def test_ffn_apply(setup, packed):
    cfg_j, cfg_t, params_j, params_t = setup
    if packed:
        params_j, params_t = jax_pack_weights(params_j), pack_weights(params_t)
    pj = jax.tree.map(lambda a: a[1], params_j["blocks"]["b1"]["ffn"])
    pt = index_tree(params_t["blocks"]["b1"]["ffn"], 1)
    x = np.random.default_rng(2).standard_normal((2, 3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        TF.ffn_apply(cfg_t, pt, _t(x)).numpy(),
        _np(JF.ffn_apply(cfg_j, pj, jnp.asarray(x))), rtol=0, atol=ATOL)


def _paged_case(cfg_t, seed):
    rng = np.random.default_rng(seed)
    L, C, page, n_pages = 4, 3, 4, 10
    kvp, hd = cfg_t.kv_heads_padded(), cfg_t.head_dim_
    kp = rng.standard_normal((n_pages, page, kvp, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, kvp, hd)).astype(np.float32)
    bt = np.asarray([[1, 2, 0], [3, 4, 5], [0, 0, 0], [6, 0, 0]], np.int32)
    pos = np.asarray([5, 11, 0, 13], np.int32)      # lane 3 overruns its pages
    x = rng.standard_normal((L, 1, cfg_t.d_model)).astype(np.float32)
    return x, kp, vp, bt, pos


@pytest.mark.parametrize("local", [False, True])
def test_attention_decode_paged(setup, local):
    """The new token's row lands in its (page, offset) cell — the overrun
    lane's on garbage page 0 — and the attention output agrees."""
    cfg_j, cfg_t, params_j, params_t = setup
    pj = jax.tree.map(lambda a: a[0],
                      jax_pack_weights(params_j)["blocks"]["b0"]["attn"])
    pt = index_tree(pack_weights(params_t)["blocks"]["b0"]["attn"], 0)
    x, kp, vp, bt, pos = _paged_case(cfg_t, 3 + local)
    with JA.paged_kernel_override(False):
        out_j, cache_j = JA.attention_decode_paged(
            cfg_j, pj, jnp.asarray(x), {"k": jnp.asarray(kp),
                                        "v": jnp.asarray(vp)},
            jnp.asarray(bt), jnp.asarray(pos), local=local)
    cache_t = {"k": _t(kp), "v": _t(vp)}
    out_t, _ = TA.attention_decode_paged(cfg_t, pt, _t(x), cache_t, _t(bt),
                                         _t(pos), local=local)
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), rtol=0, atol=ATOL)
    for name in ("k", "v"):
        written = np.asarray(cache_j[name])
        np.testing.assert_allclose(cache_t[name].numpy(), written, rtol=0,
                                   atol=1e-5)
    assert not np.array_equal(cache_t["k"].numpy()[0], kp[0])   # overrun row


def test_prefill_and_decode_step_logits(setup):
    """Bucket-padded prefill (length 11 in a 16 bucket) -> last-position
    logits; commit into scrambled pool pages; one paged decode step over
    three lanes (one idle) -> logits. Packed weights on both sides."""
    cfg_j, cfg_t, params_j, params_t = setup
    pj, pt = jax_pack_weights(params_j), pack_weights(params_t)
    rng = np.random.default_rng(5)
    S, bucket, page, n_pages = 11, 16, 4, 12
    prompt = np.zeros((1, bucket), np.int32)
    prompt[0, :S] = rng.integers(0, cfg_t.vocab_size, S)
    lj, cj = jax_prefill(cfg_j, pj, {"tokens": jnp.asarray(prompt)}, length=S)
    lt, ct = lm_prefill(cfg_t, pt, {"tokens": _t(prompt)}, length=S)
    np.testing.assert_allclose(lt.numpy(), _np(lj), rtol=0, atol=ATOL)
    assert ct["pos"] == S

    page_ids = np.asarray([7, 2, 9, 0], np.int32)    # 3 real pages + garbage
    pool_j = jax_commit(cfg_j, jax_pool_init(cfg_j, 3, n_pages, page),
                        cj["blocks"], jnp.asarray(0), jnp.asarray(page_ids),
                        page, length=S)
    pool_t = commit_prefill(cfg_t, paged_pool_init(cfg_t, n_pages, page, "cpu"),
                            ct["blocks"], _t(page_ids), page, length=S)
    for name in ("k", "v"):
        np.testing.assert_allclose(pool_t["b0"][name].numpy(),
                                   _np(pool_j["b0"][name]), rtol=0, atol=1e-5)

    bt = np.asarray([[7, 2, 9, 0], [0, 0, 0, 0], [3, 0, 0, 0]], np.int32)
    pos = np.asarray([S, 0, 2], np.int32)
    tok = np.asarray([[5], [0], [17]], np.int32)
    with JA.paged_kernel_override(False):
        dj, _ = jax_decode_paged(cfg_j, pj, {"blocks": pool_j,
                                             "block_table": jnp.asarray(bt),
                                             "pos": jnp.asarray(pos)},
                                 jnp.asarray(tok))
    dt, nc = lm_decode_step_paged(cfg_t, pt, {"blocks": pool_t,
                                              "block_table": _t(bt),
                                              "pos": _t(pos)}, _t(tok))
    assert tuple(dt.shape) == (3, 1, cfg_t.vocab_padded)
    np.testing.assert_allclose(dt.numpy(), _np(dj), rtol=0, atol=ATOL)
    assert nc["pos"].tolist() == (pos + 1).tolist()
