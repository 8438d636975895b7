"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064.

QKV bias [hf:Qwen/Qwen1.5 family]. The same values as the JAX package's
``configs/qwen1_5_32b.py``.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152_064,
    qkv_bias=True,
)

SMOKE = CONFIG.scaled(
    name="qwen1.5-32b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab_size=128, attn_chunk=64, remat=False,
)
