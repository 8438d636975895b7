"""One lane-vectorised sampling helper for every serve path, on the JAX
package's random stream.

``sample_tokens(cfg, logits, temperature, key, step)`` takes the three key
schemes of the JAX package's ``serve/sampling.py``:

  * key is None            — greedy argmax for every row;
  * key (2,) + scalar step — ONE batch-level stream: fold the step into the
    key and draw all rows from it (``generate`` / ``generate_eager``);
  * keys (L, 2) + (L,) steps — per-lane streams: each lane folds its own
    per-request step into its own per-request key, so a request's stream
    is independent of its lane and its co-tenants (sessions). Lanes with
    temperature <= 0 take the argmax.

The stream is ``jax.random``'s, as jax 0.9 computes it with
``jax_threefry_partitionable=True``: threefry2x32 (5 x 4 rounds), keys
``PRNGKey(seed) = [0, seed mod 2^32]``, ``fold_in(k, d) = threefry(k, [0,
d])``, the bits of a shape from the 64-bit flat index split into (hi, lo)
counts as ``bits1 ^ bits2``, bits -> uniform in [tiny, 1) through the top
23 bits as a mantissa, Gumbel ``-log(-log(u))`` (the "low" mode that
``categorical`` uses by default), and the sample the argmax of logits / T +
Gumbel. torch has no full uint32 arithmetic, so the words ride in int64
tensors masked to 32 bits; the bits and the uniforms are bit-exact, the
Gumbels within the ulps of the two libraries' ``log``.

Keys are (2,) or (L, 2) uint32 numpy arrays, as the session's lane mirrors
store them: they stay on the host and move to the logits' device as a
step's inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import ModelConfig

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def PRNGKey(seed) -> np.ndarray:
    """The raw (2,) uint32 key of an integer seed, as ``jax.random.PRNGKey``
    makes it with 64-bit types off: [0, seed mod 2^32], for any seed an
    int64 holds (negative ones too); larger seeds raise OverflowError."""
    s = int(np.int64(int(seed)))
    return np.array([0, s & MASK32], np.uint32)


def _words(x, device) -> torch.Tensor:
    """uint32 values (numpy, python ints or an int tensor) as an int64
    tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & MASK32
    return torch.as_tensor(np.asarray(x).astype(np.int64) & MASK32,
                           device=device)


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of counts (x1, x2) under key (k1, k2): int64
    tensors (or ints) of uint32 values, broadcast together -> (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK32
    b = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = (((b << r) & MASK32) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def fold_in(key, data, device="cpu") -> torch.Tensor:
    """``jax.random.fold_in``: keys (..., 2) and data broadcast to (...,)
    -> (..., 2) int64 words on ``device``."""
    k = _words(key, device)
    d = _words(data, device)
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """32 random bits for each element of ``shape`` (int64 in [0, 2^32)),
    as ``jax.random.bits``. ``key`` (2,) draws the whole shape from one
    stream; keys (L, 2) draw each row of a (L, ...) shape from its own, as
    ``vmap`` over the rows does."""
    k = _words(key, device)
    if k.dim() == 1:
        n = int(np.prod(shape))
        idx = torch.arange(n, dtype=torch.int64, device=device)
        y1, y2 = threefry2x32(k[0], k[1], idx >> 32, idx & MASK32)
        return (y1 ^ y2).reshape(tuple(shape))
    rows = int(np.prod(shape[1:]))
    idx = torch.arange(rows, dtype=torch.int64, device=device)
    y1, y2 = threefry2x32(k[:, :1], k[:, 1:], idx >> 32, idx & MASK32)
    return (y1 ^ y2).reshape(tuple(shape))


def uniform(key, shape, device="cpu", minval: float = 0.0) -> torch.Tensor:
    """fp32 uniforms in [minval, 1) from ``random_bits``, as ``jax.random.
    uniform``: the top 23 bits as the mantissa of a float in [1, 2), less
    1, scaled by (1 - minval) (1.0 in fp32 for minval = tiny), shifted by
    minval and clamped to it."""
    bits = random_bits(key, shape, device)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    span = torch.tensor(1.0, dtype=torch.float32, device=device) - lo
    return torch.maximum(lo, f * span + lo)


def gumbel(key, shape, device="cpu") -> torch.Tensor:
    """fp32 Gumbel noise -log(-log(u)), u uniform in [tiny, 1) ("low"
    mode of ``jax.random.gumbel``)."""
    return -torch.log(-torch.log(uniform(key, shape, device, minval=_TINY)))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis of fp32 logits + Gumbel noise of their
    shape, as ``jax.random.categorical(key, logits, axis=-1)``; keys (L, 2)
    draw row l's noise from key l, as ``vmap`` over the rows does."""
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=-1)


def logits_all_finite(logits) -> bool:
    """Host-side guard: True iff every logit is finite (one reduction and
    one wait on the device)."""
    return bool(torch.isfinite(torch.as_tensor(logits)).all())


def sample_tokens(cfg: ModelConfig, logits: torch.Tensor, temperature=0.0,
                  key=None, step=0) -> torch.Tensor:
    """logits: (B, Vp) last-position logits -> (B, 1) int32 tokens. The
    padded vocab tail is sliced off first; the argmax takes the lowest id
    of a tie, as the JAX package's does. ``temperature`` is a number or a
    (B,) vector; ``key``/``step`` pick the scheme of the module docstring."""
    lg = logits[..., :cfg.vocab_size]
    greedy = torch.argmax(lg, dim=-1)
    if key is None or (isinstance(temperature, (int, float))
                       and temperature <= 0.0):
        return greedy[:, None].to(torch.int32)
    dev = lg.device
    B = lg.shape[0]
    temps = temperature if isinstance(temperature, torch.Tensor) \
        else torch.tensor(temperature, dtype=torch.float32)
    temps = torch.broadcast_to(temps.to(dev, torch.float32), (B,))
    scaled = lg.to(torch.float32) \
        / torch.clamp(temps, min=1e-6)[:, None]
    k = _words(key, dev)
    if k.dim() == 2:                   # (L, 2): per-lane request keys
        steps = torch.broadcast_to(_words(step, dev), (B,))
        samp = categorical(fold_in(k, steps, dev), scaled)
    else:                              # (2,): one batch-level stream
        samp = categorical(fold_in(k, _words(step, dev), dev), scaled)
    return torch.where(temps > 0, samp, greedy)[:, None].to(torch.int32)
