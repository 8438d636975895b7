"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.

GQA + QKV bias, 1M rope theta [hf:Qwen/Qwen2.5 family]. The same values as
the JAX package's ``configs/qwen2_5_14b.py``.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.scaled(
    name="qwen2.5-14b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=128, attn_chunk=64, remat=False,
)
