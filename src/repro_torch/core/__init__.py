"""B⊕LD core: Boolean tensors, scaling, the threshold activation and the
Boolean linear layer with their Boolean-variation backwards, packed serving
weights, and the flip-rule + Adam hybrid optimizer."""
from .activation import boolean_activation
from .boolean_linear import (PACKED_GEMV_MAX_M, PackedBool, boolean_dense,
                             boolean_dense_inference, matmul_f32,
                             pack_boolean_weight)
from .scaling import backward_scale, preactivation_alpha
from .variation import BOOL_DTYPE, random_boolean
