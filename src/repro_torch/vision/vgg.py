"""Boolean VGG-SMALL (paper §4.1, Tables 2/6/9) on the core Boolean convs,
the JAX package's ``vision/vgg.py`` in NHWC.

As in the paper's setup, the first conv and the classifier stay FP (Adam)
and every inner conv carries native Boolean weights with the threshold
activation, optionally behind batch statistics (Table 2 "with BN").

The Boolean leaf type picks the route of a layer, as ``proj_apply`` does
for the LM: a float ±1 view goes through ``boolean_conv2d`` (training); an
int8 or ``PackedBool`` leaf fed the ±1 int8 output of the layer before it
goes through ``boolean_conv2d_inference`` (the ``boolean_matmul`` or
``packed_xnor_matmul`` kernel); the first Boolean conv reads the real output
of the FP conv and takes the float conv in every case. Every route returns
the logits that the JAX package's ``vgg_apply`` returns on the int8 leaves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import (boolean_activation, boolean_activation_inference,
                              boolean_conv2d, boolean_conv2d_inference,
                              random_boolean)
from repro_torch.core.boolean_conv import conv2d, is_stored_boolean, weight_view


def conv_fp_init(gen, kh, kw, cin, cout):
    """An FP HWIO conv weight, N(0, 1/fan_in), drawn from ``gen``."""
    return torch.randn((kh, kw, cin, cout), generator=gen,
                       device=gen.device) / math.sqrt(kh * kw * cin)


def vgg_init(cfg, generator: torch.Generator):
    """The JAX package's ``vgg_init`` tree (int8 ±1 Boolean leaves, fp32 FP
    leaves), drawn from ``generator`` on its device."""
    gen = generator
    cin = cfg.in_channels
    first_cout = cfg.stages[0][0]
    params = {"first": {"w": conv_fp_init(gen, 3, 3, cin, first_cout)}}
    cin = first_cout
    for si, (cout, n_convs) in enumerate(cfg.stages):
        stage = {}
        for ci in range(n_convs):
            if si == 0 and ci == 0:
                continue            # the FP first conv takes its place
            layer = {"w": (random_boolean((3, 3, cin, cout), gen)
                           if cfg.boolean
                           else conv_fp_init(gen, 3, 3, cin, cout))}
            if cfg.with_bn:
                layer["bn_scale"] = torch.ones((cout,), device=gen.device)
                layer["bn_bias"] = torch.zeros((cout,), device=gen.device)
            stage[f"c{ci}"] = layer
            cin = cout
        params[f"s{si}"] = stage
    hw = cfg.input_hw // (2 ** len(cfg.stages))
    flat = hw * hw * cfg.stages[-1][0]
    params["fc"] = {
        "w": torch.randn((flat, cfg.fc_dim), generator=gen,
                         device=gen.device) / math.sqrt(flat),
        "b": torch.zeros((cfg.fc_dim,), device=gen.device)}
    params["out"] = {
        "w": torch.randn((cfg.fc_dim, cfg.n_classes), generator=gen,
                         device=gen.device) / math.sqrt(cfg.fc_dim),
        "b": torch.zeros((cfg.n_classes,), device=gen.device)}
    return params


def _bn(x, scale, bias, eps=1e-5):
    """Batch statistics over (N, H, W), population variance."""
    mu = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _maxpool(x):
    """2×2, stride 2, VALID. Float tensors through ``max_pool2d`` (its
    gradient goes to the first maximum of a window, as XLA's
    select-and-scatter does); the int8 ±1 of the inference routes by
    elementwise maxima."""
    if x.dtype.is_floating_point:
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h, :w]
    return torch.maximum(torch.maximum(x[:, 0::2, 0::2], x[:, 0::2, 1::2]),
                         torch.maximum(x[:, 1::2, 0::2], x[:, 1::2, 1::2]))


def _boolean_layer(x, layer, cfg):
    """One Boolean conv and its threshold (behind BN with ``with_bn``)."""
    w = layer["w"]
    stored = is_stored_boolean(w)
    if stored and x.dtype == torch.int8:          # ±1 input: a kernel route
        if not cfg.with_bn:
            return boolean_conv2d_inference(x, w, fuse_threshold=True, tau=0.0)
        s = boolean_conv2d_inference(x, w).to(torch.float32)
        return boolean_activation_inference(
            _bn(s, layer["bn_scale"], layer["bn_bias"]), 0.0)
    s = boolean_conv2d(x, weight_view(w, x.dtype), 1, "SAME")
    fan_in = 9 * w.shape[2]
    if cfg.with_bn:
        s, fan_in = _bn(s, layer["bn_scale"], layer["bn_bias"]), 1
    if stored:                  # the int8 ±1 input of the next kernel route
        return boolean_activation_inference(s, 0.0)
    return boolean_activation(s, 0.0, fan_in)


def vgg_forward(params, cfg, images):
    """images (N, H, W, C) in [-1, 1] -> (logits (N, n_classes), the ±1
    output of every Boolean layer in order: float ±1 on the training route,
    int8 ±1 on the inference routes)."""
    x = conv2d(images, params["first"]["w"].to(images.dtype))
    acts = []
    for si, (_, n_convs) in enumerate(cfg.stages):
        for ci in range(n_convs):
            if si == 0 and ci == 0:
                continue
            layer = params[f"s{si}"][f"c{ci}"]
            if cfg.boolean:
                x = _boolean_layer(x, layer, cfg)
                acts.append(x)
            else:
                x = conv2d(x, layer["w"].to(x.dtype))
                if cfg.with_bn:
                    x = _bn(x, layer["bn_scale"], layer["bn_bias"])
                x = torch.relu(x)
        x = _maxpool(x)
    fc, out = params["fc"], params["out"]
    x = x.reshape(x.shape[0], -1).to(fc["w"].dtype)
    x = torch.relu(x @ fc["w"] + fc["b"])
    return x @ out["w"] + out["b"], acts


def vgg_apply(params, cfg, images):
    """images (N, H, W, C) in [-1, 1] -> logits (N, n_classes)."""
    return vgg_forward(params, cfg, images)[0]


def vgg_loss(params, cfg, images, labels):
    """(mean NLL, accuracy) of ``labels`` (N,) int64."""
    logits = vgg_apply(params, cfg, images)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return nll, acc
