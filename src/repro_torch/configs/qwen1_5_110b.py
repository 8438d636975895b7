"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.

QKV bias [hf:Qwen/Qwen1.5 family]. The same values as the JAX package's
``configs/qwen1_5_110b.py``.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152_064,
    qkv_bias=True,
)

SMOKE = CONFIG.scaled(
    name="qwen1.5-110b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192,
    vocab_size=128, attn_chunk=64, remat=False,
)
