"""The paper's own VGG-SMALL on CIFAR10 (§4.1, Tables 2/6/9): the same
values as the JAX package's ``configs/bold_vgg_small.py``.

A CNN, not an LM: the vision path (``repro_torch.vision.vgg``) reads it.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    name: str = "bold-vgg-small"
    # (channels, n_convs) per stage, 2x2 maxpool after each stage
    stages: Tuple[Tuple[int, int], ...] = ((128, 2), (256, 2), (512, 2))
    input_hw: int = 32
    in_channels: int = 3
    n_classes: int = 10
    fc_dim: int = 1024
    boolean: bool = True
    with_bn: bool = False       # the paper evaluates both (Table 2)

    def scaled(self, **kw):
        return dataclasses.replace(self, **kw)


CONFIG = VGGConfig()

SMOKE = CONFIG.scaled(name="bold-vgg-small-smoke",
                      stages=((16, 1), (32, 1)), input_hw=16, fc_dim=64)
