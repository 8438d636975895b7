"""The paper's Boolean vision models: VGG-SMALL (§4.1) and SMALL-EDSR
(§4.2), NHWC as in the JAX package's ``vision/``."""
from .edsr import edsr_apply, edsr_init, psnr
from .vgg import vgg_apply, vgg_forward, vgg_init, vgg_loss
