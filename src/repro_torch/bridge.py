"""Weight bridge: a parameter tree of numpy arrays -> the port's parameters.

The JAX package's ``lm_init``, ``vgg_init`` or ``edsr_init`` tree, with every
leaf converted to numpy by the caller, crosses leaf by leaf, so the port
never re-derives ``jax.random`` initialisation. The tree keeps its
structure, the stacked ``(n_groups, ...)`` leading axis of block leaves and
0-d leaves (EDSR's ``_meta``); int8 ±1 Boolean leaves stay int8
(``pack_weights`` or ``pack_boolean_weight`` packs them), float leaves keep
their dtype, bfloat16 included.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, as JAX emits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device):
    """Nested dict of numpy arrays -> same dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _leaf(tree, device)
