"""The training policy and the three training config options against the
JAX package.

``launch/shardings.py``'s ``apply_policy`` and ``train_microbatches`` are
config arithmetic: for every registry arch, every cell of ``SHAPES`` and
several mesh shapes (a stand-in object: both read only ``mesh.shape`` and
``mesh.axis_names``) the port's config equals the reference's field for
field, and the microbatch counts are equal. ``SHAPES``, ``applicable``
and ``input_specs`` (meta tensors against ``ShapeDtypeStruct``s) too.

Then the loss gradients with ``reduce_bf16`` (in fp32, where it changes
nothing), ``remat_policy="save_block_outs"`` and ``block_grad_barriers``
against the reference's with the same flags, on smoke archs: fp32 grads
within 1e-6 + 1e-4·max|grad| of a leaf (as ``tests/test_torch_train.py``);
with the two memory / scheduling options the port's grads also bit for bit
those without them. ``reduce_bf16`` acts on bf16, where a whole smoke
model cannot be compared across the packages (the threshold activations
turn the packages' different bf16 roundings into different losses, with
or without the flag), so it is held one layer at a time: a Boolean
projection's output, activation grad and votes, and an MoE layer's expert
MLP and its grads, on bf16 inputs.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.data import make_pipeline as jax_pipeline
from repro.launch import shapes as jax_shapes
from repro.launch.shardings import apply_policy as jax_apply_policy
from repro.launch.shardings import train_microbatches as jax_microbatches
from repro.models import lm_init as jax_lm_init
from repro.models import lm_loss as jax_lm_loss
from repro.train.step import bool_view as jax_bool_view
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.optimizer import tree_leaves
from repro_torch.launch import shapes
from repro_torch.launch.shardings import apply_policy, train_microbatches
from repro_torch.models import lm_loss
from repro_torch.train import bool_view

MESHES = [
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
    {"data": 1, "model": 1},
    {"data": 2, "model": 2},
    {"data": 4, "model": 2},
    {"data": 8, "model": 1},
]


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape),
                                 axis_names=tuple(shape))


def _same(a, b) -> bool:
    """Field values equal; dtypes by name (jnp.bfloat16 vs torch.bfloat16)."""
    if isinstance(b, torch.dtype):
        return jnp.dtype(a).name == str(b).removeprefix("torch.")
    return a == b


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_apply_policy_and_microbatches_equal_the_reference(arch):
    """Every cell and mesh: every field of the port's policy config equals
    the reference's, and ``train_microbatches`` agrees."""
    ct, cj = get_config(arch), jax_config(arch)
    for name, sj in jax_shapes.SHAPES.items():
        st = shapes.SHAPES[name]
        for shape in MESHES:
            pt = apply_policy(ct, st, _mesh(shape))
            pj = jax_apply_policy(cj, sj, _mesh(shape))
            ref = {f.name: getattr(pj, f.name) for f in dataclasses.fields(pj)}
            for f in dataclasses.fields(pt):
                assert _same(ref[f.name], getattr(pt, f.name)), \
                    (arch, name, shape, f.name)
            assert train_microbatches(ct, st, _mesh(shape)) == \
                jax_microbatches(cj, sj, _mesh(shape)), (arch, name, shape)


def test_shapes_applicable_and_input_specs_equal_the_reference():
    assert list(shapes.SHAPES) == list(jax_shapes.SHAPES)
    for name, st in shapes.SHAPES.items():
        assert dataclasses.asdict(st) == \
            dataclasses.asdict(jax_shapes.SHAPES[name])
    for arch in ARCH_IDS:
        ct, cj = get_config(arch), jax_config(arch)
        for name, st in shapes.SHAPES.items():
            sj = jax_shapes.SHAPES[name]
            assert shapes.applicable(ct, st) == jax_shapes.applicable(cj, sj)
            got, want = shapes.input_specs(ct, st), \
                jax_shapes.input_specs(cj, sj)
            assert got.keys() == want.keys(), (arch, name)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == want[k].shape, (arch, name, k)
                assert _same(want[k].dtype, t.dtype), (arch, name, k)


SEQ, BATCH = 32, 2
FLAG_CASES = {
    # name: (arch, dtype, flags)
    "reduce_bf16-fp32": ("gemma2-2b", "float32", dict(reduce_bf16=True)),
    "save_block_outs": ("gemma2-2b", "float32",
                        dict(remat=True, remat_policy="save_block_outs")),
    "save_block_outs-hybrid": ("jamba-1.5-large-398b", "float32",
                               dict(remat=True,
                                    remat_policy="save_block_outs")),
    "block_grad_barriers": ("gemma2-2b", "float32",
                            dict(block_grad_barriers=True)),
    "block_grad_barriers-hybrid": ("jamba-1.5-large-398b", "float32",
                                   dict(block_grad_barriers=True)),
}
FP32_RTOL = 1e-4     # of a leaf's max |grad|, plus 1e-6 (test_torch_train)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_grads(cfg, params_np, batch):
    params = bridge.params_from_numpy(params_np, "cpu")
    pf = bool_view(params, cfg.dtype)
    loss, _ = lm_loss(cfg, pf, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(pf))
    return float(loss.detach()), [g.float() for g in grads]


@pytest.mark.parametrize("name", list(FLAG_CASES))
def test_grads_with_the_flag_match_the_reference(name):
    """The loss within 1e-5 and every leaf's grad within 1e-6 +
    1e-4·max|grad| with the flag set, against the JAX package's with the
    same flag; the scheduling and memory options leave the port's grads bit
    for bit those without them."""
    arch, dtype, flags = FLAG_CASES[name]
    cfg_j = jax_smoke(arch).scaled(dtype=getattr(jnp, dtype), **flags)
    cfg_t = get_smoke(arch).scaled(dtype=getattr(torch, dtype), **flags)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), cfg_j)
    params_np = jax.tree.map(np.asarray, params_j)
    batch = jax_pipeline(cfg_j, SEQ, BATCH).batch_at(0)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jax_lm_loss(cfg_j, p, b), has_aux=True))(
        jax_bool_view(params_j, cfg_j.dtype),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, grads_t = _port_grads(cfg_t, params_np, batch)
    assert abs(loss_t - float(loss_j)) <= 1e-5
    want = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    assert len(want) == len(grads_t)
    for (path, a), g in zip(want, grads_t):
        a = np.asarray(a, np.float32)
        tol = 1e-6 + FP32_RTOL * np.abs(a).max()
        np.testing.assert_allclose(g.numpy(), a, rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))
    if "reduce_bf16" not in flags:
        off = {k: (False if k != "remat_policy" else "full") for k in flags
               if k != "remat"}
        loss0, grads0 = _port_grads(cfg_t.scaled(**off), params_np, batch)
        assert loss0 == loss_t
        for a, b in zip(grads0, grads_t):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("reduce_bf16", [False, True])
def test_reduce_bf16_boolean_layer_matches_the_reference(reduce_bf16):
    """One Boolean projection on bf16 x, ±1 w and upstream z: the output,
    the activation grad (a bf16 transpose under the flag, fp32 without)
    and the votes bit for bit the JAX package's ``boolean_dense``; the
    flag changes the activation grad."""
    from repro.core.boolean_linear import boolean_dense as jax_dense
    from repro_torch.core import boolean_dense

    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    w = np.where(rng.random((96, 80)) < 0.5, 1.0, -1.0).astype(np.float32)
    z = rng.standard_normal((64, 80)).astype(np.float32)

    def port(flag):
        xt, wt = _bf16(x).requires_grad_(), _bf16(w).requires_grad_()
        y = boolean_dense(xt, wt, None, True, False, flag)
        return (y,) + torch.autograd.grad(y, (xt, wt), _bf16(z))

    y, vjp = jax.vjp(lambda a, b: jax_dense(a, b, None, True, False,
                                            reduce_bf16),
                     *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w)))
    want = (y,) + vjp(jnp.asarray(z).astype(jnp.bfloat16))
    got = port(reduce_bf16)
    for a, b in zip(want, got):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.detach().float().numpy(),
                                      np.asarray(a, np.float32))
    assert not torch.equal(got[1], port(not reduce_bf16)[1])


def test_reduce_bf16_expert_mlp_matches_the_reference():
    """An MoE layer's expert MLP on bf16 tokens under ``reduce_bf16``: the
    output and the grads of the tokens and the three expert weights within
    2^-16 of each one's max |value| (the bf16 products' fp32 sums may round
    apart in an element)."""
    from repro.models import moe as jax_moe
    from repro_torch.models import moe

    arch = "moonshot-v1-16b-a3b"
    cfg_j = jax_smoke(arch).scaled(dtype=jnp.bfloat16, reduce_bf16=True)
    cfg_t = get_smoke(arch).scaled(dtype=torch.bfloat16, reduce_bf16=True)
    rng = np.random.default_rng(1)
    E, C, D, F = 8, 16, 64, 64
    xin = rng.standard_normal((E, C, D)).astype(np.float32)
    w = {k: np.where(rng.random(s) < 0.5, 1.0, -1.0).astype(np.float32)
         for k, s in (("wg", (E, D, F)), ("wu", (E, D, F)),
                      ("wd", (E, F, D)))}
    tau = (0.1 * rng.standard_normal(F)).astype(np.float32)
    z = rng.standard_normal((E, C, D)).astype(np.float32)

    def f(xx, wg, wu, wd):
        return jax_moe._expert_mlp(cfg_j, {"wg": wg, "wu": wu, "wd": wd,
                                           "tau": jnp.asarray(tau)}, xx)

    args = [jnp.asarray(a).astype(jnp.bfloat16)
            for a in (xin, w["wg"], w["wu"], w["wd"])]
    y, vjp = jax.vjp(f, *args)
    want = (y,) + vjp(jnp.asarray(z).astype(jnp.bfloat16))
    ts = [_bf16(a).requires_grad_() for a in (xin, w["wg"], w["wu"],
                                              w["wd"])]
    yt = moe._expert_mlp(cfg_t, {"wg": ts[1], "wu": ts[2], "wd": ts[3],
                                 "tau": torch.from_numpy(tau)}, ts[0])
    got = (yt,) + torch.autograd.grad(yt, ts, _bf16(z))
    for a, b in zip(want, got):
        a = np.asarray(a, np.float32)
        assert b.dtype == torch.bfloat16
        np.testing.assert_allclose(b.detach().float().numpy(), a, rtol=0,
                                   atol=2.0 ** -16 * np.abs(a).max())
