"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
state 16.

Mamba-1 architecture [arXiv:2410.05355]: d_inner = 2·d_model = 8192,
dt_rank = d_model/16 = 256, conv width 4. The in/x/dt/out projections carry
Boolean weights; the selective-scan recurrence stays FP. The same values as
the JAX package's ``configs/falcon_mamba_7b.py``.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,          # unused (attn-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    ssm_state=16,
    d_inner=8192,
    dt_rank=256,
    conv_width=4,
    long_context=True,
)

SMOKE = CONFIG.scaled(
    name="falcon-mamba-7b-smoke",
    n_layers=2, d_model=64, d_inner=128, dt_rank=8, ssm_state=4,
    vocab_size=128, remat=False,
)
