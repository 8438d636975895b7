"""The port's vision path against the JAX package: the Boolean convolution
(training route and its VJP, the ±1-input inference routes with int8 and
bit-packed weights), VGG-SMALL with and without BN in its three leaf forms,
its loss and gradients, SMALL-EDSR, one fine-tuning step of the example,
and the weight bridge on both trees.

Every input and weight is made with numpy (or by the JAX package's own
init) from a fixed seed and handed to both sides. ±1 activations and
integer counts are compared bit for bit; real outputs within a stated
tolerance. The CUDA kernels behind the inference routes are held against
their plain versions on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.bold_vgg_small import CONFIG as JAX_VGG
from repro.core import boolean_activation as jax_activation
from repro.core import boolean_conv2d as jax_conv
from repro.core import boolean_optimizer as jax_boolean_optimizer
from repro.core import backward_scale_conv as jax_scale_conv
from repro.vision import edsr_apply as jax_edsr_apply
from repro.vision import edsr_init as jax_edsr_init
from repro.vision import vgg_apply as jax_vgg_apply
from repro.vision import vgg_init as jax_vgg_init
from repro.vision import vgg_loss as jax_vgg_loss
from repro.vision.vgg import _bn as jax_bn
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.bold_vgg_small import CONFIG as VGG
from repro_torch.core import (backward_scale_conv, boolean_conv2d,
                              boolean_conv2d_inference, pack_boolean_weight)
from repro_torch.core.boolean_conv import im2col, pad_taps
from repro_torch.core.optimizer import (adam, boolean_optimizer, tree_leaves,
                                        tree_map)
from repro_torch.examples import finetune_boolean_cnn as example
from repro_torch.kernels import KERNELS
from repro_torch.vision import (edsr_apply, edsr_init, psnr, vgg_forward,
                                vgg_init, vgg_loss)

# inner convs read ±1: two convs a stage, so 3 Boolean layers, 2 of them on
# the previous layer's ±1 output
STAGES, HW, FC = ((16, 2), (24, 2)), 8, 32
# logits: the same ±1 features through the same fp32 fc layers, summed in
# another order
LOGIT_ATOL = 1e-5
TIE = 1e-4          # |η·q·w − 1| within fp32 noise of the flip threshold


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size convs are far too small to split among threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pm1(rng, shape, dtype=np.int8):
    return np.where(rng.random(shape) < 0.5, 1, -1).astype(dtype)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_form(params, form):
    """The VGG tree with its Boolean leaves as float views, int8 or
    PackedBool."""
    def conv(w):
        return {"float": lambda: w.to(torch.float32), "int8": lambda: w,
                "packed": lambda: pack_boolean_weight(w)}[form]()
    return {k: ({c: {**l, "w": conv(l["w"])} for c, l in v.items()}
                if k.startswith("s") else v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# the Boolean convolution
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(8, 8), (7, 6)])
@pytest.mark.parametrize("opts", [(True, False), (False, False), (True, True)])
def test_boolean_conv2d_forward_and_vjp_match_jax(stride, hw, opts):
    """Forward counts on ±1 x and the VJP (δx scaled by App C's conv factor,
    or projected to ±1; votes in the weight's dtype) against ``jax.vjp``;
    SAME padding at stride 2 on an even size is JAX's (0, 1). fp32,
    atol 1e-4: sums of up to 45 products of magnitude < 4."""
    bwd_norm, sign_backward = opts
    rng = np.random.default_rng(stride * 10 + hw[0])
    x = _pm1(rng, (2, *hw, 5), np.float32)
    w = _pm1(rng, (3, 3, 5, 7), np.float32)
    ho, wo = -(-hw[0] // stride), -(-hw[1] // stride)
    z = rng.standard_normal((2, ho, wo, 7)).astype(np.float32)

    y_j, pull = jax.vjp(lambda a, b: jax_conv(a, b, stride, "SAME", bwd_norm,
                                              sign_backward),
                        jnp.asarray(x), jnp.asarray(w))
    gx_j, gw_j = pull(jnp.asarray(z))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = boolean_conv2d(xt, wt, stride, "SAME", bwd_norm, sign_backward)
    y.backward(torch.from_numpy(z))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    if sign_backward:       # ±1: equal except where δx sits at 0 (none here)
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx_j))
    else:
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j),
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), rtol=0,
                               atol=1e-4)
    assert wt.grad.dtype == torch.float32


@pytest.mark.parametrize("args", [(64, 3, 3, 1, False), (128, 3, 3, 2, False),
                                  (512, 3, 3, 1, True), (7, 1, 5, 3, True)])
def test_backward_scale_conv_matches_jax(args):
    assert backward_scale_conv(*args) == jax_scale_conv(*args)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cin", [3, 32, 45])
@pytest.mark.parametrize("hw", [(5, 5), (6, 4), (1, 3)])
def test_inference_conv_int8_and_packed_match_the_float_conv(stride, cin, hw):
    """int8 ±1 x against int8 and PackedBool weights: the counts of JAX's
    float conv, bit for bit, at every pixel — corners and edges too, where
    the packed route's pad-tap correction acts, with Cin not a multiple of
    32 — and the fused threshold at τ = 0 and 1."""
    rng = np.random.default_rng(stride * 100 + cin + hw[0])
    x = _pm1(rng, (3, *hw, cin))
    w = _pm1(rng, (3, 3, cin, 11))
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32),
        (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for wleaf in (wt, pack_boolean_weight(wt)):
        got = boolean_conv2d_inference(xt, wleaf, stride)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
        for tau in (0.0, 1.0):
            y = boolean_conv2d_inference(xt, wleaf, stride,
                                         fuse_threshold=True, tau=tau)
            assert y.dtype == torch.int8
            np.testing.assert_array_equal(y.numpy(),
                                          np.where(want >= tau, 1, -1))


def test_im2col_order_and_pad_taps():
    """Patches in (kh, kw, c) order with zeros where the window leaves the
    image, and the pad mask marks exactly those taps."""
    x = torch.arange(1, 2 * 4 * 3 + 1, dtype=torch.int32).reshape(1, 2, 4, 3)
    cols, ho, wo = im2col(x, 3, 3, 2, "SAME")
    assert (ho, wo) == (1, 2) and tuple(cols.shape) == (2, 27)
    taps = cols.reshape(2, 9, 3)
    mask = pad_taps(2, 4, 3, 3, 2, "SAME")
    np.testing.assert_array_equal((taps == 0).all(-1).to(torch.int32), mask)
    # stride 2 on an even size pads (0, 1): the first window starts at (0, 0)
    np.testing.assert_array_equal(taps[0, 0], x[0, 0, 0])
    np.testing.assert_array_equal(mask[1], [0, 0, 1, 0, 0, 1, 1, 1, 1])


def test_float_conv_and_its_vjp_run_without_tf32():
    """The float route's convolutions, forward and backward, run with cuDNN's
    TF32 off even where the process allows it, and leave that setting as
    they found it."""
    from torch.utils._python_dispatch import TorchDispatchMode
    convs = (torch.ops.aten.convolution, torch.ops.aten.convolution_backward)
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in convs:
                seen.append((func.overloadpacket.__name__,
                             torch.backends.cudnn.allow_tf32))
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 4)).astype(np.float32))
    w = torch.from_numpy(_pm1(rng, (3, 3, 4, 5), np.float32))
    x.requires_grad_(), w.requires_grad_()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with Record():
            boolean_conv2d(x, w, 2, "SAME").sum().backward()
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert {name for name, _ in seen} == {"convolution",
                                           "convolution_backward"}
    assert not any(tf32 for _, tf32 in seen)


# ---------------------------------------------------------------------------
# VGG-SMALL
# ---------------------------------------------------------------------------
def _jax_acts(params, cfg, images):
    """The ±1 outputs of the reference's Boolean layers, by the steps of its
    ``vgg_apply`` (the JAX package returns only the logits)."""
    x = jax.lax.conv_general_dilated(images, params["first"]["w"], (1, 1),
                                     "SAME", dimension_numbers=("NHWC", "HWIO",
                                                                "NHWC"))
    acts = []
    for si, (_, n_convs) in enumerate(cfg.stages):
        for ci in range(n_convs):
            if si == 0 and ci == 0:
                continue
            layer = params[f"s{si}"][f"c{ci}"]
            w = layer["w"]
            x = jax_conv(x, w.astype(x.dtype), 1, "SAME")
            if cfg.with_bn:
                x = jax_activation(jax_bn(x, layer["bn_scale"],
                                          layer["bn_bias"]), 0.0, 1)
            else:
                x = jax_activation(x, 0.0, 9 * w.shape[2])
            acts.append(np.asarray(x))
        x = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                  (1, 2, 2, 1), "VALID")
    return acts


@pytest.fixture(scope="module", params=[False, True], ids=["no-bn", "bn"])
def vgg(request):
    cfg_j = JAX_VGG.scaled(stages=STAGES, input_hw=HW, fc_dim=FC,
                           with_bn=request.param)
    cfg_t = VGG.scaled(stages=STAGES, input_hw=HW, fc_dim=FC,
                       with_bn=request.param)
    params_j = jax_vgg_init(jax.random.PRNGKey(3), cfg_j)
    if request.param:       # BN affine leaves away from (1, 0)
        rng = np.random.default_rng(4)
        for si, (_, n) in enumerate(STAGES):
            for ci in range(1 if si == 0 else 0, n):
                layer = params_j[f"s{si}"][f"c{ci}"]
                c = layer["bn_scale"].shape[0]
                layer["bn_scale"] = jnp.asarray(
                    rng.uniform(0.5, 1.5, (c,)).astype(np.float32))
                layer["bn_bias"] = jnp.asarray(
                    rng.uniform(-0.3, 0.3, (c,)).astype(np.float32))
    images = np.random.default_rng(5).uniform(-1, 1, (6, HW, HW, 3)) \
        .astype(np.float32)
    return {"cfg_j": cfg_j, "cfg_t": cfg_t, "params_j": params_j,
            "params_np": _np(params_j), "images": images}


@pytest.mark.parametrize("form", ["float", "int8", "packed"])
def test_vgg_three_leaf_forms_match_jax(vgg, form):
    """Every Boolean layer's ±1 output bit-identical to the reference's, and
    the logits of ``vgg_apply`` (on the int8 leaves) within LOGIT_ATOL. The
    int8 and packed forms run the two ±1-input layers through the kernels'
    plain versions and launch nothing on CPU tensors."""
    for k in KERNELS:
        k.launches = 0
    imgs = jnp.asarray(vgg["images"])
    want_logits = np.asarray(jax_vgg_apply(vgg["params_j"], vgg["cfg_j"], imgs))
    want_acts = _jax_acts(vgg["params_j"], vgg["cfg_j"], imgs)
    params = _leaf_form(params_from_numpy(vgg["params_np"], "cpu"), form)
    with torch.no_grad():
        logits, acts = vgg_forward(params, vgg["cfg_t"],
                                   torch.from_numpy(vgg["images"]))
    assert len(acts) == len(want_acts) == 3
    for a, b in zip(acts, want_acts):
        assert a.dtype == (torch.float32 if form == "float" else torch.int8)
        np.testing.assert_array_equal(a.numpy().astype(np.float32), b)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=LOGIT_ATOL)
    assert all(k.launches == 0 for k in KERNELS)


def test_vgg_loss_and_every_leaf_grad_match_jax(vgg):
    """``vgg_loss`` and the gradient of every leaf (Boolean leaves as fp32
    views: their votes) against ``jax.value_and_grad``. Loss within 1e-5;
    each gradient within 1e-4 of its largest entry (fp32 sums in another
    order, through the max-pool's first-maximum routing)."""
    rng = np.random.default_rng(6)
    labels = rng.integers(0, 10, (6,))
    pf_j = jax.tree.map(lambda p: p.astype(jnp.float32), vgg["params_j"])
    (loss_j, acc_j), g_j = jax.value_and_grad(jax_vgg_loss, has_aux=True)(
        pf_j, vgg["cfg_j"], jnp.asarray(vgg["images"]), jnp.asarray(labels))
    params = tree_map(lambda p: p.to(torch.float32).requires_grad_(),
                      params_from_numpy(vgg["params_np"], "cpu"))
    loss, acc = vgg_loss(params, vgg["cfg_t"], torch.from_numpy(vgg["images"]),
                         torch.from_numpy(labels))
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5
    assert float(acc) == float(acc_j)
    for p, gj in zip(tree_leaves(params), jax.tree.leaves(g_j)):
        gj = np.asarray(gj)
        tol = 1e-4 * max(np.abs(gj).max(), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), gj, rtol=0, atol=tol)


def test_example_step_makes_the_reference_flip_decisions(vgg):
    """One fine-tuning step of the example (flip rule on the int8 leaves,
    Adam on the rest) from the same weights and batch as the reference's
    step: loss within 1e-5, flips identical except counted ties at the
    threshold, and the step does flip weights."""
    eta, fp_lr = 1000.0, 2e-3       # η large enough that one step flips
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 10, (6,))
    cfg_j = vgg["cfg_j"]
    bool_j = jax.tree.map(lambda p: p if p.dtype == jnp.int8 else None,
                          vgg["params_j"])
    pf_j = jax.tree.map(lambda p: p.astype(jnp.float32), vgg["params_j"])
    (loss_j, _), g_j = jax.value_and_grad(jax_vgg_loss, has_aux=True)(
        pf_j, cfg_j, jnp.asarray(vgg["images"]), jnp.asarray(labels))
    bg_j = jax.tree.map(lambda p, g: g if p is not None else None, bool_j,
                        g_j, is_leaf=lambda v: v is None)
    bopt_j = jax_boolean_optimizer(eta)
    new_bool_j, _ = bopt_j.update(bg_j, bopt_j.init(bool_j), bool_j)

    params = params_from_numpy(vgg["params_np"], "cpu")
    bool_t, fp_t = example.split_params(params)
    bopt, fopt = boolean_optimizer(eta), adam(fp_lr)
    before = [p.clone() for p in tree_leaves(bool_t)]
    loss, _, _ = example.train_step(
        vgg["cfg_t"], bopt, fopt, bool_t, fp_t, bopt.init(bool_t),
        fopt.init(fp_t), torch.from_numpy(vgg["images"]),
        torch.from_numpy(labels))
    assert abs(float(loss) - float(loss_j)) <= 1e-5
    flips = ties = 0
    for w0, a, b, q in zip(before, jax.tree.leaves(new_bool_j),
                           tree_leaves(bool_t), jax.tree.leaves(bg_j)):
        a, w0 = np.asarray(a), w0.numpy()
        flips += int((a != w0).sum())
        differ = a != b.numpy()
        margin = np.abs(eta * np.asarray(q) * w0 - 1.0)
        assert (margin[differ] <= TIE).all(), margin[differ].min()
        ties += int(differ.sum())
    print(f"example step: {flips} flips, {ties} ties")
    assert flips > 0


# ---------------------------------------------------------------------------
# SMALL-EDSR
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("form", ["float", "int8", "packed"])
def test_edsr_matches_jax(form):
    """EDSR at smoke size (2 blocks, width 16, ×2) against ``edsr_apply``:
    the pixel shuffle's order, the residual scaling, and each block's ±1
    conv read through the int8 or packed inference route (exact counts) or
    the float route. fp32, atol 1e-5 on outputs of magnitude ~1."""
    for k in KERNELS:
        k.launches = 0
    params_j = jax_edsr_init(jax.random.PRNGKey(8), n_blocks=2, width=16)
    x = np.random.default_rng(9).uniform(0, 1, (2, 6, 5, 3)).astype(np.float32)
    want = np.asarray(jax_edsr_apply(params_j, jnp.asarray(x), n_blocks=2))
    params = params_from_numpy(_np(params_j), "cpu")
    for i in range(2):
        blk = params[f"b{i}"]
        for j in ("w0", "w1"):
            blk[j] = {"float": blk[j].to(torch.float32), "int8": blk[j],
                      "packed": pack_boolean_weight(blk[j])}[form]
    with torch.no_grad():
        got = edsr_apply(params, torch.from_numpy(x), n_blocks=2)
    assert tuple(got.shape) == want.shape == (2, 12, 10, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert float(psnr(got, torch.from_numpy(np.array(want)))) > 80
    assert all(k.launches == 0 for k in KERNELS)


def test_edsr_init_tree_and_non_boolean_variant_match_jax():
    """``edsr_init`` makes the reference's tree (shapes, dtypes, ``_meta``),
    and the FP variant (boolean=False) computes the reference's output."""
    params_j = jax_edsr_init(jax.random.PRNGKey(1), n_blocks=2, width=8,
                             boolean=False)
    ours = edsr_init(torch.Generator().manual_seed(1), n_blocks=2, width=8,
                     boolean=False)
    flat_j = jax.tree_util.tree_flatten_with_path(params_j)[0]
    assert len(flat_j) == len(tree_leaves(ours))
    for (path, a), b in zip(flat_j, tree_leaves(ours)):
        assert a.shape == tuple(b.shape) and a.dtype.name == str(b.dtype)[6:], \
            path
    x = np.random.default_rng(2).uniform(0, 1, (1, 4, 4, 3)).astype(np.float32)
    want = np.asarray(jax_edsr_apply(params_j, jnp.asarray(x), n_blocks=2,
                                     boolean=False))
    got = edsr_apply(params_from_numpy(_np(params_j), "cpu"),
                     torch.from_numpy(x), n_blocks=2, boolean=False)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# bridge, config, init
# ---------------------------------------------------------------------------
def test_bridge_takes_both_vision_trees_leaf_by_leaf():
    """The VGG tree (BN leaves included) and the EDSR tree (0-d ``_meta``
    leaves included) cross with their structure, shapes, dtypes and values."""
    trees = [jax_vgg_init(jax.random.PRNGKey(0),
                          JAX_VGG.scaled(stages=STAGES, input_hw=HW,
                                         fc_dim=FC, with_bn=True)),
             jax_edsr_init(jax.random.PRNGKey(1), n_blocks=2, width=8)]
    for tree in trees:
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        ours = params_from_numpy(_np(tree), "cpu")
        assert len(flat) == len(tree_leaves(ours))
        for (path, a), b in zip(flat, tree_leaves(ours)):
            assert a.shape == tuple(b.shape), path
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert b.numpy().dtype == np.asarray(a).dtype, path
    meta = params_from_numpy(_np(trees[1]), "cpu")["_meta"]
    assert meta["n_blocks"].dim() == 0 and int(meta["n_blocks"]) == 2
    assert int(meta["scale"]) == 2 and int(meta["boolean"]) == 1


def test_config_and_init_tree_match_jax():
    """The registry's bold-vgg-small is the reference's CONFIG, and
    ``vgg_init`` makes the reference's tree (keys, shapes, dtypes), ±1
    int8 Boolean leaves included, at published widths."""
    import dataclasses
    assert dataclasses.asdict(get_config("bold-vgg-small")) == \
        dataclasses.asdict(JAX_VGG)
    for bn in (False, True):
        cfg_j, cfg_t = JAX_VGG.scaled(with_bn=bn), VGG.scaled(with_bn=bn)
        shapes_j = jax.eval_shape(lambda k: jax_vgg_init(k, cfg_j),
                                  jax.random.PRNGKey(0))
        ours = vgg_init(cfg_t, torch.Generator().manual_seed(0))
        flat_j = jax.tree_util.tree_flatten_with_path(shapes_j)[0]
        assert len(flat_j) == len(tree_leaves(ours))
        for (path, a), b in zip(flat_j, tree_leaves(ours)):
            assert a.shape == tuple(b.shape), path
            assert a.dtype.name == str(b.dtype)[6:], path
            if b.dtype == torch.int8:
                assert bool(((b == 1) | (b == -1)).all())
