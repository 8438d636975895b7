"""The paper's analytic energy model (Appendix E)."""
from .model import (ASCEND, V100, TPU_V5E, ConvShape, LinearShape,
                    layer_energy, network_energy, training_energy)
