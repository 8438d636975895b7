"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) expert d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual FFN
[hf:Snowflake/snowflake-arctic-base].

Boolean (int8) expert weights; the router stays FP. The same values as the
JAX package's ``configs/arctic_480b.py``.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    dense_ff=4864,
)

SMOKE = CONFIG.scaled(
    name="arctic-480b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, dense_ff=64,
    vocab_size=128, n_experts=8, top_k=2, attn_chunk=64, remat=False,
)
