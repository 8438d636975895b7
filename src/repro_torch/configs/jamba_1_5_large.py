"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2 — Mamba+attention 1:7 interleave
[arXiv:2403.19887].

9 groups of 8 blocks: in-group index 4 is attention (jamba's
attn_layer_offset), the rest Mamba; MoE FFN on odd in-group indices, dense
FFN on even ones. The same values as the JAX package's
``configs/jamba_1_5_large.py``.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65_536,
    n_experts=16,
    top_k=2,
    dense_ff=24576,
    ssm_state=16,
    d_inner=16384,
    dt_rank=512,
    conv_width=4,
    group_size=8,
    attn_index=4,
    long_context=True,
)

SMOKE = CONFIG.scaled(
    name="jamba-1.5-large-398b-smoke",
    n_layers=8, group_size=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, dense_ff=128, vocab_size=128, n_experts=4, top_k=2,
    d_inner=128, dt_rank=8, ssm_state=4, attn_index=4, attn_chunk=64,
    remat=False,
)
