"""Boolean tensors on the ±1 embedding (paper §3.2, Appendix A).

Under e(T) = +1, e(F) = -1 a Boolean tensor is an int8 ±1 tensor and xnor is
a product; the serving path needs only the random initialiser here.
"""
from __future__ import annotations

import torch

BOOL_DTYPE = torch.int8  # storage dtype for Boolean weights


def random_boolean(shape, generator: torch.Generator, device=None,
                   dtype=BOOL_DTYPE) -> torch.Tensor:
    """iid uniform ±1 Boolean tensor (paper's randint init, Alg 4), drawn
    from ``generator`` on its device unless ``device`` says otherwise."""
    device = generator.device if device is None else device
    x = torch.randint(0, 2, tuple(shape), generator=generator, device=device,
                      dtype=dtype)
    return x.mul_(2).sub_(1)
