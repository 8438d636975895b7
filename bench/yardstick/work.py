"""Operations and bytes of the work a cell asks for, from the
configuration and the traffic's own bookkeeping, never from the calls a
program happens to make: a later change that fuses or replaces a kernel
leaves these numbers as they are.

The work counts the published widths: the q heads the port pads to a
multiple of 16 and masks are not the layer's problem, so the projections,
``params`` and the attention's group size count ``n_heads``; only
``padded=True`` (the port's layout, which the tests hold the weight trees
to) counts the heads the port holds. The vocabulary is counted padded to
a multiple of 256, as the port's ``ModelConfig`` holds it. ``params`` is
``hlo_analysis._params`` and ``model_flops`` its ``model_flops``
(6·N·tokens a training step, 2·N a served token, N counting the
embedding and the head) less the padded heads; the kernels' work is
``chip_smoke.py`` phase 2's.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Sizes:
    family: str
    n_layers: int
    d_model: int
    n_heads: int = 1
    n_kv_heads: int = 1
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0
    ssm_state: int = 0
    d_inner: int = 0
    dt_rank: int = 0
    conv_width: int = 4

    @classmethod
    def of(cls, model: dict) -> "Sizes":
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in model.items() if k in keys})

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def hp(self) -> int:                # q heads padded to 16
        return -(-self.n_heads // 16) * 16

    @property
    def kvp(self) -> int:
        if self.n_kv_heads >= 16:
            return -(-self.n_kv_heads // 16) * 16
        return self.n_kv_heads

    @property
    def vp(self) -> int:
        return -(-self.vocab_size // 256) * 256

    @property
    def di(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def r(self) -> int:
        return self.dt_rank or max(self.d_model // 16, 1)

    @property
    def group(self) -> int:             # published q heads a KV head
        return self.n_heads // self.kvp

    def projections(self, padded: bool = False):
        """Every Boolean projection of one layer as (name, K, N): the
        published q heads, or with ``padded`` the port's held ones."""
        D = self.d_model
        if self.family == "ssm":
            N = self.ssm_state
            return [("in_x", D, self.di), ("in_z", D, self.di),
                    ("x_proj", self.di, self.r + 2 * N),
                    ("dt_proj", self.r, self.di), ("out_proj", self.di, D)]
        hd, h = self.hd, self.hp if padded else self.n_heads
        return [("wq", D, h * hd), ("wk", D, self.kvp * hd),
                ("wv", D, self.kvp * hd), ("wo", h * hd, D),
                ("wg", D, self.d_ff), ("wu", D, self.d_ff),
                ("wd", self.d_ff, D)]

    def boolean_params(self, padded: bool = False) -> int:
        return self.n_layers * sum(k * n for _, k, n in
                                   self.projections(padded))


def params(s: Sizes, padded: bool = False) -> float:
    """``hlo_analysis._params`` of a dense or ssm model (active = total),
    the q heads published, or with ``padded`` as the port holds them."""
    D, hd = s.d_model, s.hd
    if s.family == "ssm":
        DI, N, R = s.di, s.ssm_state, s.r
        per_group = D * DI * 2 + DI * (R + 2 * N) + R * DI + DI * D \
            + DI * (N + s.conv_width + 2)
    else:
        h = s.hp if padded else s.n_heads
        per_group = D * h * hd + 2 * D * s.kvp * hd + h * hd * D \
            + 3 * D * s.d_ff
    return per_group * s.n_layers + 2 * s.vp * D


def model_flops(s: Sizes, kind: str, tokens: int,
                padded: bool = False) -> float:
    """``hlo_analysis.model_flops``: 6·N·tokens for training, 2·N·tokens
    for serving."""
    return (6.0 if kind == "train" else 2.0) * params(s, padded) * tokens


def live_pairs(S: int, window: int = 0) -> int:
    """Query-key pairs a causal (optionally windowed) attention over S
    positions computes (``chip_smoke._live_pairs``)."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


# ---- kernels (chip_smoke.py phase 2's bytes and operations) --------------
def gemv_work(M: int, K: int, N: int):
    """Row 1, ``packed_xnor_gemv``: bf16 x (M, K), packed words (K/32, N),
    fp32 y (M, N); 2·M·K·N operations."""
    return M * K * 2 + (-(-K // 32)) * N * 4 + M * N * 4, 2.0 * M * K * N


def decode_work(rows: int, kv: int, R: int, hd: int, lanes: int):
    """Row 2, ``paged_flash_decode``: bf16 q and fp32 output of ``lanes``
    lanes, ``rows`` valid KV rows (summed over the lanes) of ``kv`` heads
    of bf16 k and v; 4·rows·kv·R·hd operations."""
    q = lanes * kv * R * hd
    return (q * 2 + rows * kv * hd * 2 * 2 + q * 4,
            4.0 * rows * kv * R * hd)


def flash_work(S: int, heads: int, kv: int, hd: int, window: int = 0):
    """Row 4, ``flash_attention``: bf16 q and output (heads, S, hd), k and
    v (kv, S, hd); 4·hd operations a live pair of each head."""
    return ((heads * S * hd * 2 + kv * S * hd * 2) * 2,
            4.0 * hd * heads * live_pairs(S, window))


def weight_bwd_work(B: int, M: int, N: int):
    """Row 3, ``boolean_weight_bwd``: bf16 x (B, M) and z (B, N), fp32
    votes (M, N); 2·B·M·N operations."""
    return B * M * 2 + B * N * 2 + M * N * 4, 2.0 * B * M * N


# ---- steps (compulsory bytes: each input read once, each output written
# once) ---------------------------------------------------------------------
def _weight_bytes_packed(s: Sizes) -> float:
    """The packed Boolean words plus the bf16 head (the served weights a
    step reads); the embedding gives only its rows."""
    return s.boolean_params() / 8 + s.d_model * s.vp * 2


def decode_step_work(s: Sizes, lanes: int, kv_rows: int):
    """One decode step over ``lanes`` live lanes whose attention reads
    ``kv_rows`` valid rows (summed over lanes): (bytes, operations)."""
    flops = model_flops(s, "decode", lanes)
    nbytes = _weight_bytes_packed(s) + lanes * s.d_model * 2
    if s.family != "ssm":
        kv_b, kv_f = decode_work(kv_rows, s.kvp, s.group, s.hd, lanes)
        nbytes += kv_b * s.n_layers
        flops += kv_f * s.n_layers
        nbytes += lanes * s.kvp * s.hd * 2 * 2 * s.n_layers   # rows written
    return nbytes, flops


def prefill_work(s: Sizes, S: int):
    """One cold prefill of an S-token prompt: the projections of every
    token (the head of the last only), the causal attention and the K/V
    rows written: (bytes, operations)."""
    body = params(s) - 2 * s.vp * s.d_model
    flops = 2.0 * body * S + 2.0 * s.d_model * s.vp
    nbytes = _weight_bytes_packed(s) + S * s.d_model * 2
    if s.family != "ssm":
        fb, ff = flash_work(S, s.n_heads, s.kvp, s.hd)
        flops += ff * s.n_layers
        nbytes += S * s.kvp * s.hd * 2 * 2 * s.n_layers
    return nbytes, flops


def train_step_work(s: Sizes, tokens: int):
    """One training step of ``tokens`` tokens: 6·N·tokens operations; the
    bytes read once: the int8 Boolean weights, the FP leaves and their
    Adam state (fp32 m, v), the flip accumulators (bf16) read and written."""
    n_bool = s.boolean_params()
    n_fp = params(s) - n_bool
    nbytes = n_bool * (1 + 2 * 2) + n_fp * (2 + 4 * 2) * 2
    return nbytes, model_flops(s, "train", tokens)
