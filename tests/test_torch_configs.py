"""The port's dense registry ids against the JAX package's: every field of
each ``CONFIG`` and ``SMOKE`` by name, the derived sizes, and bold-bert's
full-width head grouping, which neither package can serve."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.models import lm_forward as jax_forward
from repro.models import lm_init as jax_lm_init
from repro_torch.configs import PAPER_IDS, get_config, get_smoke
from repro_torch.models import lm_forward, lm_init

DENSE_IDS = ("gemma2-2b", "qwen1.5-32b", "qwen2.5-14b", "qwen1.5-110b",
             "bold-bert")


def _same(a, b) -> bool:
    """Field values equal; dtypes by name (jnp.bfloat16 vs torch.bfloat16)."""
    if isinstance(b, torch.dtype):
        return jnp.dtype(a).name == str(b).removeprefix("torch.")
    return a == b


@pytest.mark.parametrize("arch", DENSE_IDS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_fields_equal_the_reference(arch, which):
    """Every field of the port's config is a field of the reference's with
    the same value; the reference's extra fields are its mesh, MoE and SSM
    knobs, which no dense id sets away from its default."""
    get_j, get_t = ((jax_config, get_config) if which == "CONFIG"
                    else (jax_smoke, get_smoke))
    cj, ct = get_j(arch), get_t(arch)
    ref = {f.name: getattr(cj, f.name) for f in dataclasses.fields(cj)}
    for f in dataclasses.fields(ct):
        assert f.name in ref, f"{arch}: field {f.name} the reference lacks"
        assert _same(ref[f.name], getattr(ct, f.name)), \
            (arch, f.name, ref[f.name], getattr(ct, f.name))
    defaults = {f.name: f.default for f in dataclasses.fields(cj)}
    port = {f.name for f in dataclasses.fields(ct)}
    for name in ("n_experts", "top_k", "ssm_state", "d_inner", "long_context"):
        assert name in port or ref[name] == defaults[name], (arch, name)


@pytest.mark.parametrize("arch", DENSE_IDS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_derived_sizes_equal_the_reference(arch, which):
    get_j, get_t = ((jax_config, get_config) if which == "CONFIG"
                    else (jax_smoke, get_smoke))
    cj, ct = get_j(arch), get_t(arch)
    assert ct.head_dim_ == cj.head_dim_
    assert ct.heads_padded() == cj.heads_padded()
    assert ct.kv_heads_padded() == cj.kv_heads_padded()
    assert ct.vocab_padded == cj.vocab_padded
    assert ct.n_groups == cj.n_groups
    assert ct.heads_padded() // ct.kv_heads_padded() \
        == cj.heads_padded() // cj.kv_heads_padded()


def test_published_groups():
    """The decode kernel's group sizes at the dense ids' published widths:
    qwen2.5-14b's 40 q heads pad to 48 over 8 KV heads (R = 6), qwen1.5-
    32b's 48 over 48 (1), qwen1.5-110b's 64 over 8 (8), gemma2-2b's 16 over
    4 (4); bold-bert's 16 over 12 is no whole group."""
    groups = {a: (get_config(a).heads_padded(), get_config(a).kv_heads_padded())
              for a in DENSE_IDS}
    assert groups == {"gemma2-2b": (16, 4), "qwen1.5-32b": (48, 48),
                      "qwen2.5-14b": (48, 8), "qwen1.5-110b": (64, 8),
                      "bold-bert": (16, 12)}
    assert "bold-bert" in PAPER_IDS


def test_bold_bert_full_width_grouping_refused_as_the_reference():
    """bold-bert's 12 KV heads under 16 padded q heads (at its published
    head counts, shrunk elsewhere): the reference's attention fails on the
    partial group, and the port refuses it with a ValueError."""
    cj = jax_config("bold-bert").scaled(n_layers=1, d_model=32, head_dim=4,
                                        d_ff=32, vocab_size=64,
                                        dtype=jnp.float32, remat=False)
    ct = get_config("bold-bert").scaled(n_layers=1, d_model=32, head_dim=4,
                                        d_ff=32, vocab_size=64,
                                        dtype=torch.float32, remat=False)
    tokens = np.zeros((1, 8), np.int32)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cj)
    with pytest.raises(Exception):
        jax_forward(cj, params_j, {"tokens": jnp.asarray(tokens)})
    params_t = lm_init(ct, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="whole groups"):
        lm_forward(ct, params_t, {"tokens": torch.from_numpy(tokens)})
