"""Assigned input shapes and their input specs (the JAX package's
``launch/shapes.py``).

LM transformer shapes are seq_len × global_batch. decode_*/long_* run the
decode step (one new token against a seq_len KV cache), not the train
step; prefill runs ``lm_prefill``. ``input_specs`` gives each model input
as a tensor on the ``meta`` device: the JAX package's dtype and shape, no
storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeDef] = {
    "train_4k": ShapeDef("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeDef("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeDef("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeDef("long_500k", 524_288, 1, "decode"),
}


def input_specs(cfg, shape: ShapeDef):
    """Meta-device stand-ins for every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len

    def tok(*sh):
        return torch.empty(sh, dtype=torch.int32, device="meta")

    def emb():
        return torch.empty((B, S, cfg.d_model), dtype=cfg.dtype,
                           device="meta")

    if shape.kind == "train":
        specs = {"labels": tok(B, S)}
        if cfg.frontend == "embeddings":
            # modality frontend stub: precomputed frame/patch embeddings
            specs["embeddings"] = emb()
        else:
            specs["tokens"] = tok(B, S)
        return specs
    if shape.kind == "prefill":
        if cfg.frontend == "embeddings":
            return {"embeddings": emb()}
        return {"tokens": tok(B, S)}
    # decode: one new token; the cache (sized S) is part of the step state.
    return {"tokens": tok(B, 1)}


def applicable(cfg, shape: ShapeDef) -> bool:
    """Shape-skip rules: long_500k needs sub-quadratic attention — SSM and
    hybrid only."""
    if shape.name == "long_500k":
        return cfg.long_context
    return True
