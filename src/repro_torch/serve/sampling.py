"""Token sampling for every serve path. Greedy only in this slice: the JAX
package's sampled streams draw with threefry ``fold_in``/``categorical``,
which the port has not reproduced yet (sessions refuse temperature > 0 at
submit)."""
from __future__ import annotations

import torch

from repro_torch.models import ModelConfig


def sample_tokens(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """logits: (B, Vp) last-position logits -> (B, 1) int32 greedy tokens.
    The padded vocab tail is sliced off before the argmax (ties go to the
    lowest id, as in the JAX package)."""
    lg = logits[..., :cfg.vocab_size]
    return torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
