"""The weights of a cell, made on the device from ``--seed``.

Every leaf of every layer is drawn from a generator of its own, seeded
from (seed, leaf, layer), in one call: the program's stacked tree is
filled layer by layer, and the reference remakes any one layer when it
needs it, so no second copy of a 14 G-parameter tree is ever held. The
tree is the port's (the JAX package's) parameter layout: Boolean
projections are int8 ±1, norms, biases and the SSM's parameters fp32,
the embedding and the head in the configuration's dtype.

The draws follow the port's initialisers, with norms' scales and the
q/k/v and conv biases drawn at random instead of constants, so that the
paths that read them are exercised.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

from bench.yardstick.work import Sizes

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_seed(seed: int, name: str, layer: int = -1) -> int:
    h = hashlib.sha256(f"{int(seed)}/{name}/{layer}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _gen(seed: int, name: str, layer: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, name, layer))
    return g


def _layer_spec(s: Sizes, qkv_bias: bool) -> List[Tuple[str, tuple, str]]:
    """(dotted path inside a block, shape of one layer, init) for every
    leaf of a layer."""
    D = s.d_model
    spec = [("norm1.scale", (D,), "norm")]
    if s.family == "ssm":
        DI, N, R, W = s.di, s.ssm_state, s.r, s.conv_width
        spec += [("mamba.in_x.w", (D, DI), "bool"),
                 ("mamba.in_z.w", (D, DI), "bool"),
                 ("mamba.conv_w", (W, DI), "conv"),
                 ("mamba.conv_b", (DI,), "norm"),
                 ("mamba.x_proj.w", (DI, R + 2 * N), "bool"),
                 ("mamba.dt_proj.w", (R, DI), "bool"),
                 ("mamba.dt_bias", (DI,), "dt_bias"),
                 ("mamba.A_log", (DI, N), "a_log"),
                 ("mamba.D", (DI,), "ones"),
                 ("mamba.out_proj.w", (DI, D), "bool")]
        return spec
    hd, hp, kvp, F = s.hd, s.hp, s.kvp, s.d_ff
    for name, n in (("wq", hp * hd), ("wk", kvp * hd), ("wv", kvp * hd)):
        spec.append((f"attn.{name}.w", (D, n), "bool"))
        if qkv_bias:
            spec.append((f"attn.{name}.b", (n,), "bias"))
    spec += [("attn.wo.w", (hp * hd, D), "bool"),
             ("norm2.scale", (D,), "norm"),
             ("ffn.wg.w", (D, F), "bool"), ("ffn.wu.w", (D, F), "bool"),
             ("ffn.wd.w", (F, D), "bool"), ("ffn.tau", (F,), "zeros")]
    return spec


def _draw(init: str, shape: tuple, g: torch.Generator, dtype) -> torch.Tensor:
    dev = g.device
    if init == "bool":
        w = torch.randint(0, 2, shape, generator=g, device=dev,
                          dtype=torch.int8)
        return w.mul_(2).sub_(1)
    if init == "a_log":
        N = shape[-1]
        a = torch.arange(1, N + 1, dtype=torch.float32, device=dev)
        return torch.log(a).expand(shape).contiguous()
    if init == "ones":
        return torch.ones(shape, device=dev)
    if init == "zeros":
        return torch.zeros(shape, device=dev)
    if init == "dt_bias":
        u = torch.rand(shape, generator=g, device=dev)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
    scale = {"norm": 0.1, "bias": 0.5, "conv": 1.0 / math.sqrt(shape[0]),
             "embed": 0.02, "head": 1.0 / math.sqrt(shape[0])}[init]
    return x.mul_(scale).to(dtype)


def _global_spec(s: Sizes):
    return [("embed.table", (s.vp, s.d_model), "embed"),
            ("final_norm.scale", (s.d_model,), "norm"),
            ("head.w", (s.d_model, s.vp), "head")]


def _set(tree: dict, path: str, value) -> None:
    keys = path.split(".")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def layer_weights(model: dict, seed: int, layer: int, device) -> Dict:
    """One layer's block leaves (unstacked), as nested dicts."""
    s = Sizes.of(model)
    out: Dict = {}
    for path, shape, init in _layer_spec(s, model.get("qkv_bias", False)):
        g = _gen(seed, path, layer, device)
        _set(out, path, _draw(init, shape, g, torch.float32))
    return out


def global_weights(model: dict, seed: int, device) -> Dict:
    """The embedding table, the final norm and the head."""
    s = Sizes.of(model)
    dtype = DTYPES[model.get("dtype", "bfloat16")]
    out: Dict = {}
    for path, shape, init in _global_spec(s):
        g = _gen(seed, path, -1, device)
        _set(out, path, _draw(init, shape, g,
                              torch.float32 if init == "norm" else dtype))
    return out


def program_params(model: dict, seed: int, device) -> Dict:
    """The port's whole parameter tree: every block leaf stacked on a
    leading (n_layers,) axis, each layer's slice drawn as
    ``layer_weights`` draws it."""
    s = Sizes.of(model)
    tree = global_weights(model, seed, device)
    block: Dict = {}
    for path, shape, init in _layer_spec(s, model.get("qkv_bias", False)):
        stacked = None
        for layer in range(s.n_layers):
            g = _gen(seed, path, layer, device)
            w = _draw(init, shape, g, torch.float32)
            if stacked is None:
                stacked = torch.empty((s.n_layers, *shape), dtype=w.dtype,
                                      device=w.device)
            stacked[layer].copy_(w)
            del w
        _set(block, path, stacked)
    tree["blocks"] = {"b0": block}
    return tree
