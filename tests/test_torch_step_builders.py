"""``make_prefill_step`` and ``make_decode_step`` against the JAX
package's, at smoke width in fp32 on one set of bridged weights: the
prefill step's last-position logits and emitted K/V rows, then greedy
decode steps over a contiguous ``cache_init`` cache (prefilled by
``lm_prefill``), their logits within ``ATOL`` (the tolerance of
``tests/test_torch_dense_archs.py``) and every greedy token identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import cache_init as jax_cache_init
from repro.models import lm_init as jax_lm_init
from repro.models import lm_prefill as jax_prefill
from repro.train import make_decode_step as jax_decode_step
from repro.train import make_prefill_step as jax_prefill_step
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.models import cache_init, lm_prefill
from repro_torch.train import make_decode_step, make_prefill_step

ATOL = 1e-4
MAX_LEN, PROMPT, STEPS = 32, 10, 6


def _setup(arch):
    cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32)
    cfg_t = get_smoke(arch).scaled(dtype=torch.float32)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    params_np = jax.tree.map(np.asarray, params_j)
    tokens = np.random.default_rng(3).integers(
        0, cfg_t.vocab_size, (2, PROMPT)).astype(np.int32)
    return cfg_j, cfg_t, params_j, bridge.params_from_numpy(params_np, "cpu"), \
        tokens


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-14b",
                                  "falcon-mamba-7b"])
def test_prefill_step_matches_jax(arch):
    cfg_j, cfg_t, params_j, params_t, tokens = _setup(arch)
    lj, cj = jax_prefill_step(cfg_j)(params_j, {"tokens": jnp.asarray(tokens)})
    lt, ct = make_prefill_step(cfg_t)(params_t,
                                      {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
    assert ct["pos"] == int(cj["pos"]) == PROMPT
    for bi, leaves in cj["blocks"].items():
        for name, want in leaves.items():
            got = ct["blocks"][bi][name].numpy()
            assert got.shape == want.shape, (bi, name)
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=ATOL, err_msg=f"{bi}.{name}")


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-14b",
                                  "falcon-mamba-7b"])
def test_decode_step_matches_jax(arch):
    cfg_j, cfg_t, params_j, params_t, tokens = _setup(arch)
    cj = jax_cache_init(cfg_j, 2, MAX_LEN)[0]
    ct = cache_init(cfg_t, 2, MAX_LEN, "cpu")
    lj, cj = jax_prefill(cfg_j, params_j, {"tokens": jnp.asarray(tokens)},
                         cache=cj)
    lt, ct = lm_prefill(cfg_t, params_t, {"tokens": torch.from_numpy(tokens)},
                        cache=ct)
    step_j, step_t = jax_decode_step(cfg_j), make_decode_step(cfg_t)
    for i in range(STEPS):
        tok_j = np.asarray(jnp.argmax(lj[:, -1, :cfg_j.vocab_size], -1),
                           np.int32)[:, None]
        tok_t = lt[:, -1, :cfg_t.vocab_size].argmax(-1).to(torch.int32)[:, None]
        assert np.array_equal(tok_t.numpy(), tok_j), (arch, i)
        # the batch dict and the bare tokens are both accepted
        batch_t = {"tokens": tok_t} if i % 2 else tok_t
        lj, cj = step_j(params_j, cj, {"tokens": jnp.asarray(tok_j)})
        lt, ct = step_t(params_t, ct, batch_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=ATOL, err_msg=f"{arch} step {i}")
        assert ct["pos"] == int(cj["pos"]) == PROMPT + i + 1
