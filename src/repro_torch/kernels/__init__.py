"""Hand-written Hopper kernels of the port, each beside its plain version.

packed_xnor      -- bit-packed Boolean tensors, the thin-M serving GEMV
                    (csrc/packed_xnor_gemv.cu: a tensor-core route and a
                    CUDA-core one, picked by ``gemv_route``) and the fully
                    packed XNOR-popcount GEMM of the packed ±1-input
                    convolutions (csrc/packed_xnor_matmul.cu, the words on
                    the binary tensor cores)
boolean_matmul   -- the int8 ±1 GEMM (int32 counts or the fused threshold)
                    of the int8 ±1-input convolutions
                    (csrc/boolean_matmul.cu)
boolean_bwd      -- the Boolean-variation weight backward (vote counts) of
                    every Boolean projection in training
                    (csrc/boolean_weight_bwd.cu: a tensor-core route and a
                    CUDA-core one, picked by ``weight_bwd_route``)
paged_attention  -- serve-decode flash attention that walks the block table
                    and reads K/V pool pages (bf16/fp32, or int8 + scales) in
                    place (csrc/paged_flash_decode.cu: a tensor-core route
                    and a CUDA-core one, picked by ``decode_route``), and
                    the prefix-cache tail prefill over in-place prefix pages
                    (csrc/paged_prefix_attention.cu: a tensor-core route and
                    a CUDA-core one, picked by ``prefix_route``)
flash_attention  -- causal flash attention of every cold prefill
                    (csrc/flash_attention.cu: a tensor-core route and a
                    CUDA-core one, picked by ``flash_route``)

boolean_matmul and the weight backward's tensor-core route share
csrc/hopper_gemm.cuh: TMA tensor maps, mbarrier rings, wgmma and one
warp-specialised kernel skeleton; the two packed kernels use its maps,
barriers and wgmma instructions, the decode kernel's tensor-core route its
barriers and TMA loads; the two prefill-attention kernels' tensor-core
routes share one consumer body on them (csrc/attention_tc.cuh).

A wrapper runs its plain version on CPU tensors and its CUDA kernel on CUDA
tensors (or raises); ``<wrapper>.launches`` counts kernel launches.
"""
from . import ref
from .boolean_bwd import (boolean_weight_bwd, boolean_weight_bwd_plain,
                          weight_bwd_route)
from .boolean_matmul import (boolean_matmul, boolean_matmul_operands,
                             boolean_matmul_plain)
from .flash_attention import (flash_attention_fwd, flash_attention_plain,
                              flash_route)
from .packed_xnor import (gemv_route, pack_bits, packed_xnor_gemv,
                          packed_xnor_gemv_plain, packed_xnor_matmul,
                          packed_xnor_matmul_plain, unpack_bits)
from .paged_attention import (decode_route, paged_flash_decode,
                              paged_flash_decode_plain, paged_prefix_attention,
                              paged_prefix_attention_plain, prefix_route)

#: every kernel wrapper of the port, for launch-count bookkeeping
KERNELS = (packed_xnor_gemv, paged_flash_decode, boolean_weight_bwd,
           flash_attention_fwd, paged_prefix_attention, boolean_matmul,
           packed_xnor_matmul)
