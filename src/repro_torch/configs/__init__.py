"""Architecture registry of the port: the JAX package's ten assigned archs
and the paper's own models.

Each arch module exposes ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests).
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
    "musicgen-medium": "musicgen_medium",
    "gemma2-2b": "gemma2_2b",
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen1.5-110b": "qwen1_5_110b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "arctic-480b": "arctic_480b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "internvl2-26b": "internvl2_26b",
    "bold-bert": "bold_bert",
    "bold-vgg-small": "bold_vgg_small",
}


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _mod(arch_id).CONFIG


def get_smoke(arch_id: str):
    return _mod(arch_id).SMOKE
