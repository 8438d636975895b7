"""B⊕LD core: Boolean tensors, scaling, the threshold activation, the
Boolean linear layer and convolution with their Boolean-variation
backwards, packed serving weights and the ±1-input inference routes, and
the flip-rule + Adam hybrid optimizer."""
from .activation import boolean_activation, boolean_activation_inference
from .boolean_linear import (PACKED_GEMV_MAX_M, PackedBool, boolean_dense,
                             boolean_dense_inference, matmul_f32,
                             pack_boolean_weight)
from .boolean_conv import boolean_conv2d, boolean_conv2d_inference
from .scaling import backward_scale, backward_scale_conv, preactivation_alpha
from .variation import BOOL_DTYPE, random_boolean
