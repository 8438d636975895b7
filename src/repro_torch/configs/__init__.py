"""Architecture registry of the port.

Each ported arch module exposes ``CONFIG`` (the published configuration)
and ``SMOKE`` (a reduced same-family config for CPU tests). Ported: the
dense gemma2-2b and the paper's VGG-SMALL; the other ids of the JAX
package's registry raise until their families are.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

ARCH_IDS: List[str] = [
    "musicgen-medium",
    "gemma2-2b",
    "qwen1.5-32b",
    "qwen2.5-14b",
    "qwen1.5-110b",
    "falcon-mamba-7b",
    "moonshot-v1-16b-a3b",
    "arctic-480b",
    "jamba-1.5-large-398b",
    "internvl2-26b",
]

PAPER_IDS: List[str] = ["bold-bert", "bold-vgg-small"]

_MODULES: Dict[str, str] = {
    "gemma2-2b": "gemma2_2b",
    "bold-vgg-small": "bold_vgg_small",
}


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        if arch_id in ARCH_IDS or arch_id in PAPER_IDS:
            raise NotImplementedError(f"arch '{arch_id}' is not ported yet; "
                                      f"ported: {sorted(_MODULES)}")
        raise KeyError(f"unknown arch '{arch_id}'; known: "
                       f"{sorted(ARCH_IDS + PAPER_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _mod(arch_id).CONFIG


def get_smoke(arch_id: str):
    return _mod(arch_id).SMOKE
