"""The other model families through the port against the JAX package at
smoke width in fp32: the six new registry ids' ``CONFIG`` and ``SMOKE``
fields by name, their derived sizes and total and active parameter counts
(the published bounds of the JAX package's config tests), the parameter
tree's leaves by path, shape and dtype; ``lm_forward`` and ``lm_loss``
(MoE aux included) for every new smoke arch, the embeddings frontends too;
prefill then decode against the forward for the ssm and hybrid families;
``pack_weights`` leaving expert tensors and in_x/in_z as the JAX package
does; and the serve launcher on the new ids.

Logits are held within LOGIT_TOL: fp32 sums reassociated through two to
eight blocks (the selective scan's doubling order among them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.launch.hlo_analysis import active_params, total_params
from repro.models import cache_init as jax_cache_init
from repro.models import lm_decode_step as jax_decode
from repro.models import lm_forward as jax_forward
from repro.models import lm_init as jax_lm_init
from repro.models import lm_loss as jax_loss
from repro.models import lm_prefill as jax_prefill
from repro.serve import pack_weights as jax_pack_weights
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import PackedBool
from repro_torch.launch import serve as launcher
from repro_torch.models import (block_roles, cache_init, lm_decode_step,
                                lm_forward, lm_init, lm_loss, lm_prefill)
from repro_torch.serve import pack_weights

torch.set_num_threads(1)

NEW_IDS = ("falcon-mamba-7b", "moonshot-v1-16b-a3b", "arctic-480b",
           "jamba-1.5-large-398b", "musicgen-medium", "internvl2-26b")
LOGIT_TOL = 1e-4


def _same(a, b) -> bool:
    """Field values equal; dtypes by name (jnp.bfloat16 vs torch.bfloat16)."""
    if isinstance(b, torch.dtype):
        return jnp.dtype(a).name == str(b).removeprefix("torch.")
    return a == b


def test_registry_holds_every_id():
    for arch in ARCH_IDS:
        assert get_config(arch).name == jax_config(arch).name
        assert get_smoke(arch).name == jax_smoke(arch).name


@pytest.mark.parametrize("arch", NEW_IDS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_fields_and_sizes_equal_the_reference(arch, which):
    """Every field of the port's config is the reference's with the same
    value; the reference's other fields are its mesh and serve-sharding
    knobs, at their defaults; the derived sizes agree."""
    get_j, get_t = ((jax_config, get_config) if which == "CONFIG"
                    else (jax_smoke, get_smoke))
    cj, ct = get_j(arch), get_t(arch)
    ref = {f.name: getattr(cj, f.name) for f in dataclasses.fields(cj)}
    port = {f.name for f in dataclasses.fields(ct)}
    for name in port:
        assert name in ref, f"{arch}: field {name} the reference lacks"
        assert _same(ref[name], getattr(ct, name)), \
            (arch, name, ref[name], getattr(ct, name))
    defaults = {f.name: f.default for f in dataclasses.fields(cj)}
    for name in set(ref) - port:
        assert ref[name] == defaults[name], (arch, name)
    for prop in ("head_dim_", "vocab_padded", "n_groups", "d_inner_",
                 "dt_rank_", "dense_ff_"):
        assert getattr(ct, prop) == getattr(cj, prop), (arch, prop)
    assert ct.heads_padded() == cj.heads_padded()
    assert ct.kv_heads_padded() == cj.kv_heads_padded()


def test_param_counts_equal_the_reference():
    """The JAX package's analytic counts on the port's configs equal them
    on its own, within the published bounds of its config tests."""
    for arch in NEW_IDS:
        for fn in (total_params, active_params):
            assert fn(get_config(arch)) == fn(jax_config(arch)), (arch, fn)
    bounds = {"arctic-480b": (4.2e11, 5.5e11, None),
              "moonshot-v1-16b-a3b": (2.0e10, 3.5e10, (2e9, 5e9)),
              "jamba-1.5-large-398b": (3.8e11, 4.2e11, (8.5e10, 1.0e11)),
              "falcon-mamba-7b": (5e9, 9e9, None)}
    for arch, (lo, hi, active) in bounds.items():
        assert lo < total_params(get_config(arch)) < hi, arch
        if active:
            assert active[0] < active_params(get_config(arch)) < active[1]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", NEW_IDS)
def test_init_tree_matches_the_reference(arch):
    """The port's ``lm_init`` tree has the reference's leaves: same paths,
    shapes and dtypes (int8 Boolean projections and experts, fp32 router,
    SSM parameters and thresholds)."""
    cj = jax_smoke(arch).scaled(dtype=jnp.float32)
    ct = get_smoke(arch).scaled(dtype=torch.float32)
    want = {p: (tuple(v.shape), np.dtype(v.dtype).name)
            for p, v in _leaves(jax.tree.map(
                np.asarray, jax_lm_init(jax.random.PRNGKey(0), cj)[0]))}
    got = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for p, v in _leaves(lm_init(ct, torch.Generator().manual_seed(0)))}
    assert got == want


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "arctic-480b"])
def test_bridge_carries_the_new_leaves(arch):
    """``params_from_numpy`` carries the mamba and MoE leaves (A_log, D,
    conv_w, conv_b, dt_bias, router, the stacked (G, E, D, F) expert
    tensors) unchanged: values, shapes and dtypes."""
    cj = jax_smoke(arch).scaled(dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jax_lm_init(jax.random.PRNGKey(0),
                                                  cj)[0])
    got = dict(_leaves(bridge.params_from_numpy(params, "cpu")))
    names = set()
    for path, want in _leaves(params):
        t = got[path]
        assert tuple(t.shape) == want.shape, path
        assert str(t.dtype).removeprefix("torch.") == want.dtype.name, path
        assert np.array_equal(t.float().numpy(), want.astype(np.float32)), path
        names.add(path[-1])
    wanted = {"router", "wg", "wu", "wd"} | (
        {"A_log", "D", "conv_w", "conv_b", "dt_bias"}
        if arch.startswith("jamba") else set())
    assert wanted <= names
    G, E, D, F = cj.n_groups, cj.n_experts, cj.d_model, cj.d_ff
    assert tuple(got[("blocks", "b1" if arch.startswith("jamba") else "b0",
                      "moe", "wg")].shape) == (G, E, D, F)


def _models(arch, **over):
    cj = jax_smoke(arch).scaled(dtype=jnp.float32, **over)
    ct = get_smoke(arch).scaled(dtype=torch.float32, **over)
    params = jax.tree.map(np.asarray,
                          jax_lm_init(jax.random.PRNGKey(0), cj)[0])
    return cj, ct, params


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "embeddings":
        b["embeddings"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return b


@pytest.mark.parametrize("arch", NEW_IDS)
def test_forward_and_loss_match_jax(arch):
    """Logits, the MoE aux loss and the loss (+ 0.01 aux) on bridged
    weights, over 2 x 20 inputs (tokens, or embeddings for the audio and
    vlm stubs)."""
    cj, ct, params = _models(arch)
    b = _batch(ct, 2, 20)
    lj, aj = jax_forward(cj, jax.tree.map(jnp.asarray, params),
                         jax.tree.map(jnp.asarray, b))
    pt = bridge.params_from_numpy(params, "cpu")
    bt = bridge.params_from_numpy(b, "cpu")
    lt, at = lm_forward(ct, pt, bt)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(at.item(), float(aj), rtol=1e-5, atol=1e-6)
    assert (at.item() > 0) == (ct.n_experts > 0)
    loss_j, mj = jax_loss(cj, jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, b))
    loss_t, mt = lm_loss(ct, pt, bt)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(mt["nll"].item(), float(mj["nll"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_prefill_then_decode_matches_forward(arch):
    """Prefill (S tokens) into a cache preallocated at S + 3, then decode
    tokens S..S+2: each step's logits equal the forward's over the longer
    prefix (the port's own), and the JAX package's prefill and decode
    logits; the cache's mamba state is the JAX package's (LOGIT_TOL: its
    conv rows are a deep block's inputs)."""
    cj, ct, params = _models(arch)
    pj, pt = jax.tree.map(jnp.asarray, params), \
        bridge.params_from_numpy(params, "cpu")
    B, S = 2, 13
    toks = np.random.default_rng(2).integers(0, ct.vocab_size,
                                             (B, S + 3)).astype(np.int32)
    cache_j = jax_cache_init(cj, B, S + 3)[0]
    lj, cache_j = jax_prefill(cj, pj, {"tokens": jnp.asarray(toks[:, :S])},
                              cache=cache_j)
    lt, cache_t = lm_prefill(ct, pt, {"tokens": torch.from_numpy(toks[:, :S])},
                             cache=cache_init(ct, B, S + 3, "cpu"))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_TOL)
    for t in range(S, S + 3):
        tok = toks[:, t:t + 1]
        lj, cache_j = jax_decode(cj, pj, cache_j, jnp.asarray(tok))
        lt, cache_t = lm_decode_step(ct, pt, cache_t, torch.from_numpy(tok))
        full, _ = lm_forward(ct, pt, {"tokens": torch.from_numpy(
            toks[:, :t + 1])})
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, -1].numpy(),
                                   rtol=0, atol=LOGIT_TOL)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGIT_TOL)
    n = 0
    for path, leaf in _leaves(cache_t["blocks"]):
        if path[-1] in ("h", "conv"):
            ref = cache_j["blocks"]
            for k in path:
                ref = ref[k]
            np.testing.assert_allclose(leaf.numpy(), np.asarray(ref),
                                       rtol=0, atol=LOGIT_TOL,
                                       err_msg=str(path))
            n += 1
    assert n == 2 * sum(r["mixer"] == "mamba" for r in block_roles(ct))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b",
                                  "arctic-480b"])
def test_pack_weights_matches_jax(arch):
    """Packed leaves at the same paths with the reference's words: in_x and
    in_z apart, every other Boolean projection packed (jamba's and
    arctic's dense FFNs fused as wgu), and the stacked int8 expert tensors,
    router, thresholds and SSM parameters passed through unchanged."""
    _, _, params = _models(arch)
    want = dict(_leaves(jax_pack_weights(jax.tree.map(jnp.asarray, params))))
    got = dict(_leaves(pack_weights(bridge.params_from_numpy(params, "cpu"))))
    assert set(want) == set(got)
    n_packed = 0
    for path, leaf in got.items():
        ref = want[path]
        if isinstance(leaf, PackedBool):
            n_packed += 1
            assert leaf.k == ref.k and np.array_equal(
                leaf.bits.numpy(), np.asarray(ref.bits).view(np.int32)), path
        else:
            assert not hasattr(ref, "bits"), path
            assert np.array_equal(leaf.numpy(), np.asarray(ref)), path
            if path[-2] == "moe" and path[-1] in ("wg", "wu", "wd"):
                assert leaf.dtype == torch.int8 and leaf.dim() == 4
    paths = {"/".join(p) for p in got}
    if arch != "arctic-480b":
        assert any(p.endswith("mamba/in_x/w") for p in paths)
        assert any(p.endswith("mamba/in_z/w") for p in paths)
    assert n_packed > 0


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "musicgen-medium",
                                  "moonshot-v1-16b-a3b"])
def test_launcher_serves_the_new_ids(arch, capsys):
    out = launcher.main(["--arch", arch, "--smoke", "--batch", "2",
                         "--prompt-len", "12", "--gen", "4", "--device", "cpu",
                         "--packed"])
    assert tuple(out.shape) == (2, 4)
    notice = "embeddings frontend stub" in capsys.readouterr().out
    assert notice == (arch == "musicgen-medium")
