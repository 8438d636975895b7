"""Hand-written Hopper kernels of the port, each beside its plain version.

packed_xnor      -- bit-packed Boolean weights and the thin-M serving GEMV
                    (csrc/packed_xnor_gemv.cu)
boolean_bwd      -- the Boolean-variation weight backward (vote counts) of
                    every Boolean projection in training
                    (csrc/boolean_weight_bwd.cu)
paged_attention  -- serve-decode flash attention that walks the block table
                    and reads K/V pool pages (bf16/fp32, or int8 + scales) in
                    place (csrc/paged_flash_decode.cu), and the prefix-cache
                    tail prefill over in-place prefix pages
                    (csrc/paged_prefix_attention.cu)
flash_attention  -- causal flash attention of every cold prefill
                    (csrc/flash_attention.cu)

A wrapper runs its plain version on CPU tensors and its CUDA kernel on CUDA
tensors (or raises); ``<wrapper>.launches`` counts kernel launches.
"""
from . import ref
from .boolean_bwd import boolean_weight_bwd, boolean_weight_bwd_plain
from .flash_attention import flash_attention_fwd, flash_attention_plain
from .packed_xnor import (pack_bits, packed_xnor_gemv, packed_xnor_gemv_plain,
                          unpack_bits)
from .paged_attention import (paged_flash_decode, paged_flash_decode_plain,
                              paged_prefix_attention,
                              paged_prefix_attention_plain)

#: every kernel wrapper of the port, for launch-count bookkeeping
KERNELS = (packed_xnor_gemv, paged_flash_decode, boolean_weight_bwd,
           flash_attention_fwd, paged_prefix_attention)
