"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=163840, MoE 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B].

Boolean (int8) expert weights; the router stays FP. The same values as the
JAX package's ``configs/moonshot_v1_16b_a3b.py`` (its einsum dispatch by
default; ``moe_impl="scatter"`` selects the scatter dispatch).
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    n_experts=64,
    top_k=6,
)

SMOKE = CONFIG.scaled(
    name="moonshot-v1-16b-a3b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
    vocab_size=128, n_experts=8, top_k=2, attn_chunk=64, remat=False,
)
