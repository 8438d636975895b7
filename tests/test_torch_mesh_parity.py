"""Tensor-parallel serving's token identity, in gloo worlds of 1, 2 and 4
processes: the JAX package's ``tests/test_mesh_serve.py`` parity sweep,
run through the port's serve mesh.

Dense, packed, kv-quant, ssm and hybrid smoke models (fp32, their weights
the JAX package's ``lm_init``, bridged; ``n_kv_heads`` scaled to 4 where
attention shards, so every world divides it, as the JAX sweep scales it
where the mesh exceeds it) serve two prompts through ``generate_batch`` on
a serve mesh. On rank 0 the greedy streams must equal the port's
unsharded engine's and the JAX package's unsharded ``generate_batch``'s,
a sampled batch (one lane at T = 0.8, one greedy) the unsharded port
engine's token for token, and the prefill logits of each prompt (through
``prefill_commit``, head gathers and all) the unsharded engine's: with
``torch.equal`` in every world — the plain versions' matmuls and einsums
sum each column and each head in the same order at any shard count here —
which at world 1 is the JAX test's bitwise contract.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke as jax_smoke
from repro.models import attention as JA
from repro.models import lm_init as jax_lm_init
from repro.serve.engine import ServeEngine as JEngine

from test_torch_mesh_serve import run_world, save_params

CASES = [("dense", "gemma2-2b", {}, {}),
         ("packed", "gemma2-2b", {}, {"packed": True}),
         ("kvq", "gemma2-2b", {"kv_cache_quant": True}, {}),
         ("ssm", "falcon-mamba-7b", {}, {}),
         ("hybrid", "jamba-1.5-large-398b", {}, {})]
PROMPTS = [[i % 128 for i in range(5)], [(3 * i + 1) % 128 for i in range(9)]]
KW = dict(lanes=2, page_size=4, segment=2)


def _cfg_kw(name, cfg_kw):
    return dict(cfg_kw) if name == "ssm" else dict(cfg_kw, n_kv_heads=4)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Each case's weights (saved for the worlds) and the JAX package's
    unsharded greedy streams (its gather path)."""
    d = tmp_path_factory.mktemp("mesh_parity")
    cases, streams = [], {}
    for name, arch, cfg_kw, eng_kw in CASES:
        kw = _cfg_kw(name, cfg_kw)
        cfg = jax_smoke(arch).scaled(dtype=jnp.float32, **kw)
        params, _ = jax_lm_init(jax.random.PRNGKey(0), cfg)
        path = save_params(jax.tree.map(np.asarray, params), d / f"{name}.npz")
        cases.append([name, arch, kw, eng_kw, path])
        prompts = [np.asarray(p, np.int32) for p in PROMPTS]
        with JA.paged_kernel_override(False):
            out = JEngine(cfg, params, max_len=32, **eng_kw).generate_batch(
                prompts, 6, **KW)
        streams[name] = [np.asarray(t).tolist() for t in out]
    return cases, streams


_SWEEP = """
import torch
from repro_torch.configs import get_smoke
from repro_torch.serve import PRNGKey, ServeEngine

CASES, PROMPTS, KW = json.loads(sys.argv[4])
prompts = [np.asarray(p, np.int32) for p in PROMPTS]
out = {}
for name, arch, cfg_kw, eng_kw, path in CASES:
    cfg = get_smoke(arch).scaled(dtype=torch.float32, **cfg_kw)
    params = load_params(path)
    em = ServeEngine(cfg, params, max_len=32, device="cpu", mesh=MESH,
                     **eng_kw)

    def body(em):
        ref = ServeEngine(cfg, params, max_len=32, device="cpu", **eng_kw)
        greedy = [t.tolist() for t in em.generate_batch(prompts, 6, **KW)]
        assert greedy == [t.tolist()
                          for t in ref.generate_batch(prompts, 6, **KW)], name
        sampled = [em.generate_batch(prompts, 6, [0.8, 0.0], PRNGKey(3),
                                     **KW),
                   ref.generate_batch(prompts, 6, [0.8, 0.0], PRNGKey(3),
                                      **KW)]
        assert [t.tolist() for t in sampled[0]] == \\
            [t.tolist() for t in sampled[1]], name
        for p in prompts:
            got = [e.prefill_commit(e.init_pool(4, 4, 1), p, len(p),
                                    np.arange(1, 4, dtype=np.int32), 4)[0]
                   for e in (em, ref)]
            assert torch.equal(got[0], got[1]), (name, (got[0] - got[1])
                                                 .abs().max())
        out[name] = greedy

    served(em, body)
if RANK == 0:
    print("STREAMS " + json.dumps(out))
    print("GATHERS " + json.dumps(MESH.counts))
"""


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_token_identity_all_archetypes(world, reference, tmp_path):
    cases, want = reference
    out = run_world(world, _SWEEP, tmp_path, json.dumps([cases, PROMPTS, KW]))
    line = next(ln for ln in out.splitlines() if ln.startswith("STREAMS "))
    got = json.loads(line[len("STREAMS "):])
    assert got == want, (got, want)
    counts = json.loads(next(ln for ln in out.splitlines()
                             if ln.startswith("GATHERS "))[len("GATHERS "):])
    # the attention blocks gathered their heads at more than one shard (a
    # mesh of one is the unsharded path); every segment checked its tokens
    assert (counts["head_gathers"] > 0) == (world > 1), counts
    assert counts["token_gathers"] > 0, counts
