"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.

Decoder-only transformer over EnCodec tokens [arXiv:2306.05284]. The EnCodec
frontend is a stub: a prefill takes precomputed frame embeddings (B, S,
d_model); the head maps to the 2048-entry codebook. RoPE replaces
MusicGen's sinusoidal positions. The same values as the JAX package's
``configs/musicgen_medium.py``.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    frontend="embeddings",
)

SMOKE = CONFIG.scaled(
    name="musicgen-medium-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=128, attn_chunk=64, remat=False,
)
