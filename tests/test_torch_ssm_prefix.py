"""Prefix-cached serving of the ssm and hybrid families through the port,
at smoke width in fp32, on bridged weights: exact hits bit-identical to the
cold run (the stored SSM end state written into another lane), partial hits
resuming the recurrence from the page-boundary snapshot of the hit against
the cold run, and — both packages serving the same prefix traffic — the
nodes, snapshots and exact records' end states the index stores against
the JAX package's, and a tail's snapshot against the cold prefill's state.

Stored SSM states are held within STATE_TOL: fp32 states after up to eight
blocks whose scans associate in another order. The JAX sessions run their
gather path (``paged_kernel_override(False)``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import attention as JA
from repro.models import lm_init as jax_lm_init
from repro.serve import SamplingParams as JParams
from repro.serve import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.models import lm_prefill
from repro_torch.serve import SamplingParams, ServeEngine

torch.set_num_threads(1)

MAX_LEN = 48
STATE_TOL = 1e-4


def _engines(arch, packed):
    cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32)
    cfg_t = get_smoke(arch).scaled(dtype=torch.float32)
    params = jax.tree.map(np.asarray,
                          jax_lm_init(jax.random.PRNGKey(0), cfg_j)[0])
    return (JEngine(cfg_j, jax.tree.map(jnp.asarray, params), max_len=MAX_LEN,
                    packed=packed),
            ServeEngine(cfg_t, bridge.params_from_numpy(params, "cpu"),
                        max_len=MAX_LEN, packed=packed, device="cpu"))


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _cold(teng, prompt, n):
    with teng.session(lanes=2, page_size=8, prefix_cache=False) as s:
        return s.submit(prompt, SamplingParams(max_tokens=n)).result()


def _conserved(sess):
    alloc = sess.sched.alloc
    assert not sess.sched.active
    assert sess.prefix.owned_pages + alloc.n_free == alloc.n_pages - 1
    sess.audit()


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_exact_hit_bit_identical(arch):
    """A repeat of a finished prompt admits with no prefill: the stored end
    logits, the record's boundary page forked, the stored SSM end state
    written into its lane (the repeat lands on another lane than the first
    run) — and its stream is the cold run's bit for bit, beside a co-tenant
    that keeps the first lane busy."""
    _, teng = _engines(arch, True)
    p, other = _prompts(teng.cfg.vocab_size, (13, 9), seed=5)
    ref = _cold(teng, p, 5)
    with teng.session(lanes=2, page_size=8, prefix_cache=True) as sess:
        sess.submit(p, SamplingParams(max_tokens=5)).result()
        busy = sess.submit(other, SamplingParams(max_tokens=12))
        sess.step()
        hit = sess.submit(p, SamplingParams(max_tokens=5))
        out = hit.result()
        assert hit._req.lane == 1 or busy._req.lane == 1
        busy.result()
        assert sess.work["exact_admits"] == 1
        assert sess.prefix.stats["cow_forks"] == 1
        _conserved(sess)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_partial_hit_matches_cold(arch):
    """Two prompts sharing their first two pages: the second prefills only
    its tail, its recurrence resumed from the snapshot at the hit boundary
    (and jamba's attention over the prefix pages read in place); its
    stream is the cold run's (the JAX package's test of the same)."""
    _, teng = _engines(arch, False)
    p1 = _prompts(teng.cfg.vocab_size, (21,), seed=7)[0]
    p2 = p1.copy()
    p2[-2:] = (p2[-2:] + 1) % teng.cfg.vocab_size
    ref2 = _cold(teng, p2, 5)
    with teng.session(lanes=2, page_size=8, segment=2,
                      prefix_cache=True) as sess:
        sess.submit(p1, SamplingParams(max_tokens=5)).result()
        out2 = sess.submit(p2, SamplingParams(max_tokens=5)).result()
        assert sess.prefix.stats["partial_hits"] == 1
        assert sess.prefix.stats["hit_tokens"] == 16
        assert sess.work["tail_prefills"]
        _conserved(sess)
    np.testing.assert_array_equal(out2, ref2)


def _nodes(cache):
    """Every node root-first in key order."""
    out, stack = [], [cache.root]
    while stack:
        node = stack.pop()
        if node is not cache.root:
            out.append(node)
        for kb in sorted(node.children, reverse=True):
            stack.append(node.children[kb])
    return out


def _state_close(got, want, what):
    for bi in want:
        for name in ("h", "conv"):
            np.testing.assert_allclose(
                got[bi][name].numpy(), np.asarray(want[bi][name]), rtol=0,
                atol=STATE_TOL, err_msg=f"{what} {bi} {name}")
    assert set(got) == set(want)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_stored_states_match_jax(arch):
    """Both packages serve the same prefix traffic: a cold prompt, two
    prompts sharing its first two pages (partial hits, one of them
    splitting the first node), an exact repeat. The indexes hold the same
    nodes and records, every node's page-boundary snapshots and every
    record's end state agree within STATE_TOL, the snapshots at pages a
    partial hit donated equal the cold prefill's state there, and the
    streams agree."""
    jeng, teng = _engines(arch, False)
    base = _prompts(teng.cfg.vocab_size, (29,), seed=9)[0]
    p2 = base.copy()
    p2[20:] = (p2[20:] + 3) % teng.cfg.vocab_size       # shares 2 pages
    p3 = np.concatenate([base[:12], base[:11] + 1]) % teng.cfg.vocab_size
    prompts = [base, p2, p3, base]

    def serve(eng, params):
        with eng.session(lanes=2, page_size=8, segment=2,
                         prefix_cache=True) as s:
            outs = [list(map(int, s.submit(p, params(max_tokens=4))
                             .result())) for p in prompts]
            return outs, s.prefix, getattr(s, "work", None)

    with JA.paged_kernel_override(False):
        want, jidx, _ = serve(jeng, JParams)
    got, tidx, stats = serve(teng, SamplingParams)
    assert got == want
    assert stats["exact_admits"] == 1 and stats["tail_prefills"]
    jn, tn = _nodes(jidx), _nodes(tidx)
    assert [(n.key.tobytes(), n.pages) for n in tn] \
        == [(n.key.tobytes(), n.pages) for n in jn]
    n_snaps = 0
    for a, b in zip(tn, jn):
        assert len(a.snaps) == len(b.snaps) == len(a.pages)
        for sa, sb in zip(a.snaps, b.snaps):
            _state_close(sa, sb, "snapshot")
            n_snaps += 1
    # base's 3 pages, p2's third (its tail) and p3's second (its tail, after
    # p3's hit at 8 split base's node)
    assert n_snaps == 5
    assert sorted(tidx.records) == sorted(jidx.records)
    for kb, rec in tidx.records.items():
        _state_close(rec.end_ssm, jidx.records[kb].end_ssm, "end state")
    # p2's third page came from its tail prefill: the cold state there
    node = next(n for n in tn if n.key[:8].tobytes()
                == p2[16:24].tobytes())
    _, _, cold = lm_prefill(teng.cfg, teng.params,
                            {"tokens": torch.from_numpy(p2[None])},
                            state_at=(24,))
    _state_close(node.snaps[0], {bi: {k: v[:, :, 0] for k, v in s.items()}
                                 for bi, s in cold.items()}, "tail snapshot")
