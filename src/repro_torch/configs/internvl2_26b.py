"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 [arXiv:2404.16821].

The InternLM2-20B transformer backbone only; the InternViT vision frontend
is a stub: a prefill takes precomputed patch embeddings (B, S, d_model).
Vocab padded 92553 -> 92672 (padded logits masked in the loss). The same
values as the JAX package's ``configs/internvl2_26b.py``.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92_553,
    frontend="embeddings",
)

SMOKE = CONFIG.scaled(
    name="internvl2-26b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=130, attn_chunk=64, remat=False,
)
