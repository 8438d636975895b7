from .lm import (block_roles, cache_init, lm_decode_step, lm_decode_step_paged,
                 lm_forward, lm_init, lm_loss, lm_prefill)
from .modules import ModelConfig
