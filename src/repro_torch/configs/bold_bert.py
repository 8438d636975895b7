"""The paper's own Boolean BERT-base (§4.3 BERT fine-tuning / Table 7).

BERT-base geometry (12L, 768, 12H, 3072, vocab 30522) on the unified
causal-decoder LM, so the paper's own transformer is an ``--arch``
selection; the bidirectional pooling head of the GLUE-analog harness comes
with that harness. The same values as the JAX package's
``configs/bold_bert.py``.
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="bold-bert",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=30_522,
)

SMOKE = CONFIG.scaled(
    name="bold-bert-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=128, attn_chunk=64, remat=False,
)
