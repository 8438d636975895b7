"""The rest of the dense family through the port against the JAX package, at
smoke width in fp32, on one set of bridged weights (q/k/v biases set
non-zero): for each qwen id and bold-bert, packed and unpacked, session
streams (greedy, sampled with seeds, sampled on the session key, mixed
temperatures), ``generate`` and ``generate_eager`` (greedy and on the
batch-level stream) token for token, and the contiguous ``lm_decode_step``'s
logits; a config whose group is 6 (40 q heads padded to 48 over 8 KV heads,
qwen2.5-14b's grouping) through the decode plain version against the JAX
kernel in interpret mode and through a session; ``pack_weights`` packing a
group slice at a time, bit for bit; and the serve launcher's modes.

A token may differ only at a near-tie, held to fixed bounds, as
``test_torch_train.py`` holds its ties to a fixed TIE: at the context
where the streams part, the two packages' logits agree within ATOL over
the vocab, and the port's token scores (logits / T + the Gumbel noise of
its draw; greedy: the logits) within twice ATOL / T + 2^-20 of 1 + |g| +
|z| (the libraries' log in the Gumbel, the fp32 sum) of the JAX model's
winner. From there on the port's stream follows its own context, so each
of its later tokens is held to the JAX model's draw at that context by
the same rule. Near-ties are counted. The JAX sessions run
their gather path (``paged_kernel_override(False)``), which the JAX package
pins bitwise to its Pallas kernel; its packed GEMV runs in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.kernels.paged_attention import paged_flash_decode as jax_paged_decode
from repro.models import attention as JA
from repro.models import cache_init as jax_cache_init
from repro.models import lm_decode_step as jax_decode
from repro.models import lm_init as jax_lm_init
from repro.models import lm_prefill as jax_prefill
from repro.serve import SamplingParams as JParams
from repro.serve import ServeEngine as JEngine
from repro.serve import pack_weights as jax_pack_weights
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core import PackedBool, pack_boolean_weight
from repro_torch.kernels import paged_flash_decode
from repro_torch.launch import serve as launcher
from repro_torch.models import cache_init, lm_decode_step, lm_prefill
from repro_torch.serve import (PRNGKey, SamplingParams, ServeEngine,
                               pack_weights)

torch.set_num_threads(1)

ARCHS = ("qwen2.5-14b", "qwen1.5-32b", "qwen1.5-110b", "bold-bert")
MAX_LEN = 48
LENS, NTOK = (5, 12, 9, 17, 3), (6, 8, 5, 7, 4)
# fp32 at smoke width: reassociation ulps through 2 layers
ATOL = 1e-4
# qwen2.5-14b's grouping at smoke sizes: 40 q heads (48 padded) over 8 KV
R6 = dict(n_heads=40, n_kv_heads=8, head_dim=8)


def _configs(arch, **over):
    return (jax_smoke(arch).scaled(dtype=jnp.float32, **over),
            get_smoke(arch).scaled(dtype=torch.float32, **over))


def _weights(cfg_j):
    """JAX init, every bias leaf set to N(0, 0.5) values, as numpy."""
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(1)

    def walk(node):
        return {k: (rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
                    if k == "b" else walk(v) if isinstance(v, dict)
                    else np.asarray(v)) for k, v in node.items()}

    return walk(params_j)


def _engines(arch, packed, **over):
    cfg_j, cfg_t = _configs(arch, **over)
    params = _weights(cfg_j)
    return (JEngine(cfg_j, jax.tree.map(jnp.asarray, params), max_len=MAX_LEN,
                    packed=packed),
            ServeEngine(cfg_t, bridge.params_from_numpy(params, "cpu"),
                        max_len=MAX_LEN, packed=packed, device="cpu"))


@pytest.fixture(scope="module", params=[(a, p) for a in ARCHS
                                        for p in (False, True)],
                ids=lambda ap: f"{ap[0]}-{'packed' if ap[1] else 'int8'}")
def engines(request):
    return _engines(*request.param)


def _prompts(vocab, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in LENS]


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
    ``ctx``'s next token: the last-position logits / T plus the Gumbel
    noise of row ``row`` of a (rows, V) draw from ``key`` folded with
    ``step`` (greedy, temp <= 0: the logits). The port's logits at the
    context are first held to the JAX package's within ATOL."""
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
    each of its later tokens the JAX model's draw at the port's own
    context or a near-tie there; returns the near-tie count. ``draw(i,
    t)``: (temperature, key, step, row, rows) of stream i's token t."""
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
                 f"{int(np.argmax(z))} (jax stream {w[t] if t == t0 else '-'}),"
                 f" past the near-tie bound {2 * eps:.3g}")
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


def test_generate_and_eager_match_jax(engines):
    jeng, teng = engines
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
    # generate reuses its pooled cache: a second call is the same
    again = teng.generate(prompts, 6, temperature=0.9, key=key)
    assert torch.equal(again, teng.generate_eager(prompts, 6, temperature=0.9,
                                                  key=key))
    print(f"{teng.cfg.name}: generate / generate_eager, {ties} near-ties")


def test_contiguous_decode_logits_match_jax(engines):
    """Prefill into a max_len contiguous cache, then three decode steps on
    the same tokens; the logits of each agree with the JAX package's."""
    jeng, teng = engines
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, teng.cfg.vocab_size, (2, 10)).astype(np.int32)
    cj = jax_cache_init(jeng.cfg, 2, MAX_LEN)[0]
    ct = cache_init(teng.cfg, 2, MAX_LEN, "cpu")
    lj, cj = jax_prefill(jeng.cfg, jeng.params,
                         {"tokens": jnp.asarray(tokens)}, cache=cj)
    lt, ct = lm_prefill(teng.cfg, teng.params,
                        {"tokens": torch.from_numpy(tokens)}, cache=ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
    n0 = paged_flash_decode.launches
    for _ in range(3):
        tok = np.asarray(jnp.argmax(lj[:, -1, :jeng.cfg.vocab_size], -1),
                         np.int32)[:, None]
        lj, cj = jax_decode(jeng.cfg, jeng.params, cj, jnp.asarray(tok))
        lt, ct = lm_decode_step(teng.cfg, teng.params, ct,
                                torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=ATOL)
        assert ct["pos"] == int(cj["pos"])
    assert paged_flash_decode.launches == n0      # no paged kernel reached


# ---------------------------------------------------------------------------
# group size 6 (qwen2.5-14b's grouping)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant,window", [(False, 0), (True, 0), (False, 9)])
def test_r6_decode_plain_matches_jax_kernel(quant, window):
    """The decode plain version at R = 6 (8 KV heads) against the JAX
    Pallas kernel in interpret mode: lanes at pos 0, mid-table, at the
    table's end and past it. fp32 pools atol 1e-5; int8 pools (codes times
    per-row scales, |v| <= 6.35) atol 1e-4."""
    rng = np.random.default_rng(6 + quant + window)
    L, KV, R, hd, page, C = 4, 8, 6, 8, 4, 5
    n_pages = L * C + 1
    q = rng.standard_normal((L, KV, R, hd)).astype(np.float32)
    shape = (n_pages, page, KV, hd)
    if quant:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.05, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.005, 0.05, shape[:3]).astype(np.float32)
        scales = (ks, vs)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        scales = ()
    bt = (rng.permutation(n_pages - 1)[:L * C] + 1).astype(np.int32) \
        .reshape(L, C)
    pos = np.asarray([0, 9, C * page - 1, C * page + 2], np.int32)
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), *map(jnp.asarray, scales), window=window,
        softcap_val=0.0, interpret=True))
    got = paged_flash_decode(*(torch.from_numpy(a) for a in
                               (q, kp, vp, bt, pos, *scales)),
                             window=window, softcap_val=0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 if quant else 1e-5)


def test_r6_session_matches_jax():
    """A packed session at R = 6 (qwen2.5-14b smoke widths with 40 q heads
    over 8 KV heads, head dim 8), greedy and sampled lanes, against the JAX
    session; its decode attention runs at R = 6."""
    jeng, teng = _engines("qwen2.5-14b", True, **R6)
    assert teng.cfg.heads_padded() // teng.cfg.kv_heads_padded() == 6
    import repro_torch.kernels.paged_attention as PA
    plain, groups = PA.paged_flash_decode_plain, []

    def seen(q, *a, **kw):
        groups.append(q.shape[2])
        return plain(q, *a, **kw)

    PA.paged_flash_decode_plain = seen
    try:
        got, ties = _session_parity(jeng, teng, segment=2)
    finally:
        PA.paged_flash_decode_plain = plain
    assert groups and set(groups) == {6}
    print(f"R = 6 session: {got}, {ties} near-ties")


# ---------------------------------------------------------------------------
# packing a group slice at a time
# ---------------------------------------------------------------------------
def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma2-2b"])
def test_pack_weights_by_slice_bit_identical(arch):
    """The words equal the JAX package's ``pack_weights`` and packing each
    whole (fused) leaf at once; with ``consume=True`` every int8 leaf has
    left the tree handed over, and the words are the same. The qwens'
    q/k/v biases keep wq, wk, wv apart; gemma2-2b fuses them."""
    cfg_j, _ = _configs(arch)
    params = _weights(cfg_j)
    want = jax_pack_weights(jax.tree.map(jnp.asarray, params))
    tree = bridge.params_from_numpy(params, "cpu")
    got = pack_weights(tree)
    consumed = bridge.params_from_numpy(params, "cpu")
    got2 = pack_weights(consumed, consume=True)
    jl = {p: v for p, v in _leaves(want, ())}
    n = 0
    for path, leaf in _leaves(got):
        other = dict(_leaves(got2))[path]
        if not isinstance(leaf, PackedBool):
            assert torch.equal(leaf, other), path
            continue
        n += 1
        ref = jl[path + ("bits",)] if path + ("bits",) in jl else jl[path]
        ref_bits = np.asarray(getattr(ref, "bits", ref)).view(np.int32)
        assert np.array_equal(leaf.bits.numpy(), ref_bits), path
        assert torch.equal(leaf.bits, other.bits) and leaf.k == other.k
        blk = tree
        for k in path[:-2]:
            blk = blk[k]
        parts = {"wqkv": ("wq", "wk", "wv"), "wgu": ("wg", "wu")}.get(
            path[-2], (path[-2],))
        whole = pack_boolean_weight(torch.cat([blk[p]["w"] for p in parts], -1))
        assert torch.equal(leaf.bits, whole.bits) and leaf.k == whole.k, path
    assert n == (6 if arch.startswith("qwen") else 2 * 4)   # gemma: 2 roles
    assert not any(isinstance(v, torch.Tensor) and v.dtype == torch.int8
                   for _, v in _leaves(consumed))


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", [[], ["--eager"], ["--continuous", "--packed"],
                                  ["--stream", "--prefix-cache", "--kv-quant"]])
def test_launcher_modes_on_cpu(mode):
    out = launcher.main(["--arch", "qwen2.5-14b", "--smoke", "--batch", "2",
                         "--prompt-len", "12", "--gen", "4", "--requests", "3",
                         "--lanes", "2", "--device", "cpu", *mode])
    if mode[:1] in (["--continuous"], ["--stream"]):
        assert len(out) == 3 and all(len(o) >= 2 for o in out)
    else:
        assert tuple(out.shape) == (2, 4)


def test_launcher_refuses_later_slices_flags():
    """No flag of the JAX launcher is refused as a later slice's any more:
    ``--shards`` is served (tests/test_torch_mesh_overload.py) and, as in
    the JAX launcher, refused only without ``--stream``/``--continuous``;
    the gateway's flags parse with the JAX launcher's defaults (``--http``
    is served in tests/test_torch_gateway_protocol.py)."""
    with pytest.raises(SystemExit, match="--shards requires --stream"):
        launcher.main(["--arch", "qwen2.5-14b", "--smoke", "--device",
                       "cpu", "--shards", "2"])
    assert launcher._parser().parse_args(["--arch", "x"]).shards == 0
    args = launcher._parser().parse_args(
        ["--arch", "qwen2.5-14b", "--http", "8080", "--metrics-tenants", "4",
         "--watchdog-timeout", "5", "--host", "0.0.0.0"])
    assert (args.http, args.metrics_tenants, args.watchdog_timeout,
            args.host) == (8080, 4, 5.0, "0.0.0.0")
    args = launcher._parser().parse_args(["--arch", "qwen2.5-14b"])
    assert (args.http, args.metrics_tenants, args.watchdog_timeout,
            args.host) == (None, None, 300.0, "127.0.0.1")
