"""Serving the ssm, hybrid and moe families through the port against the
JAX package, at smoke width in fp32, on one set of bridged weights: for
falcon-mamba-7b, jamba-1.5-large-398b and moonshot-v1-16b-a3b, packed and
unpacked, session streams (greedy, sampled with seeds, sampled on the
session key) and ``generate`` / ``generate_eager`` token for token, and a
jamba kv-quant session against the JAX package's kv-quant session. Their
prefix-cached sessions are ``test_torch_ssm_prefix.py``'s.

A token may differ only at a near-tie, held to fixed bounds (the rule of
``test_torch_dense_archs.py``): at the context where the streams part the
two packages' logits agree within ATOL over the vocab, and the port's token
scores (logits / T + the Gumbel noise of its draw; greedy: the logits)
within twice ATOL / T + 2^-20 of 1 + |g| + |z| of the JAX model's winner;
each later token is held to the JAX model's draw at the port's own context
by the same rule. The JAX
sessions run their gather path (``paged_kernel_override(False)``), which
the JAX package pins bitwise to its Pallas kernels; its packed GEMV runs in
interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import attention as JA
from repro.models import lm_init as jax_lm_init
from repro.models import lm_prefill as jax_prefill
from repro.serve import SamplingParams as JParams
from repro.serve import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.models import lm_prefill
from repro_torch.serve import PRNGKey, SamplingParams, ServeEngine

torch.set_num_threads(1)

ARCHS = ("falcon-mamba-7b", "jamba-1.5-large-398b", "moonshot-v1-16b-a3b")
MAX_LEN = 48
LENS, NTOK = (5, 12, 9, 17, 3), (6, 8, 5, 7, 4)
ATOL = 1e-4


def _engines(arch, packed, **over):
    cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32, **over)
    cfg_t = get_smoke(arch).scaled(dtype=torch.float32, **over)
    params = jax.tree.map(np.asarray,
                          jax_lm_init(jax.random.PRNGKey(0), cfg_j)[0])
    return (JEngine(cfg_j, jax.tree.map(jnp.asarray, params), max_len=MAX_LEN,
                    packed=packed),
            ServeEngine(cfg_t, bridge.params_from_numpy(params, "cpu"),
                        max_len=MAX_LEN, packed=packed, device="cpu"))


@pytest.fixture(scope="module", params=[(a, p) for a in ARCHS
                                        for p in (False, True)],
                ids=lambda ap: f"{ap[0]}-{'packed' if ap[1] else 'int8'}")
def engines(request):
    return _engines(*request.param)


def _prompts(vocab, lens=LENS, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _sampling(i):
    """Request i: greedy, T = 0.8 with its own seed, or T = 1.3 on the
    session key, in turn."""
    return [dict(temperature=0.0), dict(temperature=0.8, seed=100 + i),
            dict(temperature=1.3)][i % 3]


def _lane_key(i, session_key):
    s = _sampling(i)
    if "seed" in s:
        return np.asarray(jax.random.PRNGKey(s["seed"]), np.uint32)
    return np.asarray(jax.random.fold_in(jnp.asarray(session_key), i),
                      np.uint32)


def _drive(sess, prompts, make):
    """Three requests up front, two submitted after a decode segment."""
    hs = [sess.submit(p, make(i, n)) for i, (p, n) in
          enumerate(zip(prompts[:3], NTOK[:3]))]
    sess.step()
    sess.step()
    hs += [sess.submit(p, make(i + 3, n)) for i, (p, n) in
           enumerate(zip(prompts[3:], NTOK[3:]))]
    sess.run_until_idle()
    return [list(map(int, h.result())) for h in hs]


def _draw_scores(jeng, teng, ctx, temp, key, step, row=0, rows=1):
    """(JAX's scores, the bound on a score's noise) of the draw of
    ``ctx``'s next token; the port's logits there are first held to the
    JAX package's within ATOL."""
    V = teng.cfg.vocab_size
    lj = np.asarray(jax_prefill(jeng.cfg, jeng.params,
                                {"tokens": jnp.asarray(ctx[None])})[0])[0, -1]
    lt = lm_prefill(teng.cfg, teng.params,
                    {"tokens": torch.from_numpy(ctx[None])})[0].numpy()[0, -1]
    zj = lj[:V].astype(np.float32)
    np.testing.assert_allclose(lt[:V], zj, rtol=0, atol=ATOL)
    if temp <= 0:
        return zj, ATOL + 2.0 ** -20 * (1 + np.abs(zj).max())
    g = np.asarray(jax.random.gumbel(
        jax.random.fold_in(jnp.asarray(key), step), (rows, V)))[row]
    z = zj / np.float32(temp) + g
    return z, ATOL / temp + 2.0 ** -20 * (1 + np.abs(g).max()
                                          + np.abs(z).max())


def _agree(jeng, teng, got, want, contexts, draw):
    """Streams identical, or the port's differing from a near-tie on and
    each later token the JAX model's draw at the port's own context or a
    near-tie there; returns the near-tie count."""
    ties = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (i, g, w)
        if g == w:
            continue
        t0 = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        for t in range(t0, len(g)):
            ctx = np.concatenate([contexts[i], np.asarray(g[:t], np.int32)])
            z, eps = _draw_scores(jeng, teng, ctx, *draw(i, t))
            if t > t0 and g[t] == int(np.argmax(z)):
                continue
            assert z.max() - z[g[t]] <= 2 * eps, \
                (f"stream {i} token {t}: port {g[t]} scores "
                 f"{z.max() - z[g[t]]:.3g} under the JAX model's winner "
                 f"{int(np.argmax(z))}, past the near-tie bound {2 * eps:.3g}")
            ties += 1
    return ties


def _session_parity(jeng, teng, segment=3):
    prompts = _prompts(teng.cfg.vocab_size)
    skey = PRNGKey(11)
    with JA.paged_kernel_override(False):
        with jeng.session(lanes=3, page_size=8, segment=segment,
                          key=jax.random.PRNGKey(11)) as s:
            want = _drive(s, prompts, lambda i, n: JParams(max_tokens=n,
                                                           **_sampling(i)))
    with teng.session(lanes=3, page_size=8, segment=segment, key=skey) as s:
        got = _drive(s, prompts, lambda i, n: SamplingParams(max_tokens=n,
                                                             **_sampling(i)))
    assert [len(g) for g in got] == list(NTOK)
    ties = _agree(jeng, teng, got, want, prompts,
                  lambda i, t: (_sampling(i)["temperature"],
                                _lane_key(i, skey), t, 0, 1))
    return got, ties


def test_session_streams_match_jax(engines):
    jeng, teng = engines
    got, ties = _session_parity(jeng, teng)
    print(f"{teng.cfg.name}: session streams {got}, {ties} near-ties")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_and_eager_match_jax(arch):
    """Packed engines (the sessions hold both leaf forms)."""
    jeng, teng = _engines(arch, True)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, teng.cfg.vocab_size, (2, 10)).astype(np.int32)
    key = PRNGKey(21)
    ties = 0
    for name in ("generate", "generate_eager"):
        for temp, k in ((0.0, None), (0.9, key)):
            want = np.asarray(getattr(jeng, name)(
                jnp.asarray(prompts), 6, temperature=temp,
                key=None if k is None else jnp.asarray(k)))
            got = getattr(teng, name)(prompts, 6, temperature=temp, key=k)
            assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
            ties += _agree(jeng, teng, got.tolist(), want.tolist(),
                           list(prompts),
                           lambda i, t: (temp, k, t, i, len(prompts)))
    # generate reuses its pooled cache (SSM state included): a second call
    # is the same as a fresh one
    again = teng.generate(prompts, 6, temperature=0.9, key=key)
    assert torch.equal(again, teng.generate_eager(prompts, 6, temperature=0.9,
                                                  key=key))
    print(f"{teng.cfg.name}: generate / generate_eager, {ties} near-ties")


def test_jamba_kv_quant_session_matches_jax():
    """A kv-quant jamba session (int8 K/V pages for its attention layers,
    fp32 SSM state) against the JAX package's kv-quant session."""
    jeng, teng = _engines("jamba-1.5-large-398b", True, kv_cache_quant=True)
    got, ties = _session_parity(jeng, teng, segment=2)
    print(f"jamba kv-quant session: {got}, {ties} near-ties")
