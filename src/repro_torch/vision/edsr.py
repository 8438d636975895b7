"""Boolean SMALL-EDSR (paper §4.2, Table 3): 8 Boolean residual blocks and a
pixel-shuffle upsampler, the first and last convs FP as in the paper's
setup. The JAX package's ``vision/edsr.py`` in NHWC.

The leaf type of a block's second conv picks its route, as in VGG: a float
±1 view goes through ``boolean_conv2d`` (training); an int8 or
``PackedBool`` leaf reads the block's int8 ±1 threshold output through
``boolean_conv2d_inference`` (exact integer counts, the ``boolean_matmul``
or ``packed_xnor_matmul`` kernel). The first conv of a block reads the real
residual stream and takes the float conv in every case.
"""
from __future__ import annotations

import torch

from repro_torch.core import (boolean_activation, boolean_activation_inference,
                              boolean_conv2d, boolean_conv2d_inference,
                              random_boolean)
from repro_torch.core.boolean_conv import conv2d, is_stored_boolean, weight_view

from .vgg import conv_fp_init


def edsr_init(generator: torch.Generator, n_blocks: int = 8, width: int = 64,
              scale: int = 2, boolean: bool = True):
    """The JAX package's ``edsr_init`` tree, drawn from ``generator`` on its
    device; ``_meta`` holds 0-d int tensors."""
    gen = generator
    params = {"head": {"w": conv_fp_init(gen, 3, 3, 3, width)}}
    for i in range(n_blocks):
        params[f"b{i}"] = {
            f"w{j}": (random_boolean((3, 3, width, width), gen) if boolean
                      else conv_fp_init(gen, 3, 3, width, width))
            for j in range(2)}
    params["up"] = {"w": conv_fp_init(gen, 3, 3, width, width * scale * scale)}
    params["tail"] = {"w": conv_fp_init(gen, 3, 3, width, 3)}
    params["_meta"] = {k: torch.tensor(v, dtype=torch.int32, device=gen.device)
                       for k, v in (("n_blocks", n_blocks), ("scale", scale),
                                    ("boolean", int(boolean)))}
    return params


def _block(h, blk, fan_in):
    """A Boolean block's update: conv, threshold, conv, counts / fan_in."""
    w0, w1 = blk["w0"], blk["w1"]
    y = boolean_conv2d(h, weight_view(w0, h.dtype), 1, "SAME")
    if is_stored_boolean(w1):
        a = boolean_activation_inference(y, 0.0)
        y = boolean_conv2d_inference(a, w1).to(h.dtype)
    else:
        y = boolean_activation(y, 0.0, fan_in)
        y = boolean_conv2d(y, w1.to(h.dtype), 1, "SAME")
    return y / fan_in               # counts back to the activation range


def edsr_apply(params, x, n_blocks: int = 8, scale: int = 2,
               boolean: bool = True):
    """x: (N, H, W, 3) in [0, 1] -> (N, H·scale, W·scale, 3)."""
    x = x - 0.5
    h = conv2d(x, params["head"]["w"])
    feat = h
    fan_in = 9 * h.shape[-1]
    for i in range(n_blocks):
        blk = params[f"b{i}"]
        if boolean:
            y = _block(h, blk, fan_in)
        else:
            y = conv2d(torch.relu(conv2d(h, blk["w0"])), blk["w1"])
        h = h + y * 0.1             # EDSR residual scaling
    h = h + feat
    u = conv2d(h, params["up"]["w"])
    N, H, W, C = u.shape
    r = scale
    # the reference's shuffle order, (row, sub-row, col, sub-col, channel)
    u = u.reshape(N, H, W, r, r, C // (r * r))
    u = u.permute(0, 1, 3, 2, 4, 5).reshape(N, H * r, W * r, C // (r * r))
    return conv2d(u, params["tail"]["w"]) + 0.5


def psnr(pred, target, max_val: float = 1.0):
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-10))
