"""Boolean gated FFN, the paper's MLP recipe inside transformer blocks.

The gate path goes through the Boolean threshold activation and its ±1
output sign-modulates the up path; all three projections carry Boolean
weights. ``act_boolean=False`` falls back to SiLU on the scaled counts.
"""
from __future__ import annotations

import torch

from repro_torch.core import boolean_activation

from .modules import ModelConfig, proj_apply, proj_init


def ffn_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int = 0, lead=()):
    d_ff = d_ff or cfg.d_ff
    return {
        "wg": proj_init(gen, cfg, cfg.d_model, d_ff, False, lead),
        "wu": proj_init(gen, cfg, cfg.d_model, d_ff, False, lead),
        "wd": proj_init(gen, cfg, d_ff, cfg.d_model, False, lead),
        "tau": torch.zeros((*lead, d_ff), device=gen.device),
    }


def ffn_apply(cfg: ModelConfig, p, x):
    if "wgu" in p:
        # packed serving layout (pack_weights): gate+up fused into one GEMV
        gu = proj_apply(cfg, p["wgu"], x)
        g, u = torch.chunk(gu, 2, dim=-1)
    else:
        g = proj_apply(cfg, p["wg"], x)  # scaled counts, Var≈1
        u = proj_apply(cfg, p["wu"], x)
    if cfg.boolean and cfg.act_boolean:
        # s is pre-normalised to unit variance by proj_apply: fan_in=1
        h = boolean_activation(g, p["tau"].to(g.dtype), 1) * u
    else:
        h = torch.nn.functional.silu(g.to(torch.float32)).to(u.dtype) * u
    return proj_apply(cfg, p["wd"], h)
