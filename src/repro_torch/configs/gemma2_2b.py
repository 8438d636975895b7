"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local (4096-window) + global alternating attention, attn/final logit
softcapping (50/30), head_dim 256 [arXiv:2408.00118]. Stacked as 13 groups
of (local, global) pairs. The same values as the JAX package's
``configs/gemma2_2b.py``.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    alt_local_global=True,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    group_size=2,
)

SMOKE = CONFIG.scaled(
    name="gemma2-2b-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=128, sliding_window=32, attn_chunk=64, remat=False,
)
