"""The port's analytic cost model against the JAX package's, with ``==``:
``analytic_cell_cost`` for every registry arch × the four input shapes ×
the production meshes (16 x 16, 2 x 16 x 16) and two small ones (1 x 1,
4 x 2), each config under its mesh's policy (``apply_policy``) and the
reference's ``train_microbatches``; ``model_flops``, ``total_params`` and
``active_params`` for every arch and shape. Pure Python on both sides:
the numbers are equal, not close.
"""
import pytest

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.launch import hlo_analysis as jax_hlo
from repro.launch.flops_model import analytic_cell_cost as jax_cost
from repro.launch.shapes import SHAPES as JAX_SHAPES
from repro.launch.shardings import apply_policy as jax_policy
from repro.launch.shardings import train_microbatches as jax_micro
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import hlo_analysis
from repro_torch.launch.flops_model import analytic_cell_cost
from repro_torch.launch.shapes import SHAPES
from repro_torch.launch.shardings import apply_policy


def fake_mesh(shape, axes):
    """A mesh both packages read: ``axis_names``, ``shape`` by axis (the
    policies' reads) and ``devices.shape`` / ``devices.size`` (the JAX
    package's ``_mesh_info``), as the reference test's ``FakeMesh``."""
    size = 1
    for n in shape:
        size *= n

    class Devices:
        pass

    Devices.shape, Devices.size = tuple(shape), size

    class Mesh:
        axis_names = tuple(axes)
        devices = Devices

    Mesh.shape = dict(zip(axes, shape))
    return Mesh


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def test_same_arch_and_shape_ids():
    assert list(ARCH_IDS) == list(JAX_ARCH_IDS)
    assert {k: (v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} \
        == {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_cell_cost_equals_the_reference(arch, mesh_name):
    mesh = fake_mesh(*MESHES[mesh_name])
    for shape_name in SHAPES:
        cfg_j = jax_policy(jax_config(arch), JAX_SHAPES[shape_name], mesh)
        cfg_t = apply_policy(get_config(arch), SHAPES[shape_name], mesh)
        mb = jax_micro(cfg_j, JAX_SHAPES[shape_name], mesh) \
            if SHAPES[shape_name].kind == "train" else 1
        want = jax_cost(cfg_j, JAX_SHAPES[shape_name], mesh, microbatches=mb)
        got = analytic_cell_cost(cfg_t, SHAPES[shape_name], mesh,
                                 microbatches=mb)
        assert got == want, (arch, shape_name, mesh_name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_params_equal_the_reference(arch):
    cfg_j, cfg_t = jax_config(arch), get_config(arch)
    assert hlo_analysis.total_params(cfg_t) == jax_hlo.total_params(cfg_j)
    assert hlo_analysis.active_params(cfg_t) == jax_hlo.active_params(cfg_j)
    for name in SHAPES:
        assert hlo_analysis.model_flops(cfg_t, SHAPES[name]) \
            == jax_hlo.model_flops(cfg_j, JAX_SHAPES[name])


def test_mesh_info_reads_a_train_mesh_shape():
    """``_mesh_info`` takes a ``TrainMesh``'s ``shape`` dict as the JAX
    mesh's ``devices`` (the dry run passes its ``TrainMesh``)."""
    from repro_torch.launch.flops_model import _mesh_info

    class Train:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 16, "model": 16}

    assert _mesh_info(Train) == (512, 16, 32)
    assert _mesh_info(fake_mesh(*MESHES["2x16x16"])) == (512, 16, 32)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen1.5-110b",
                                  "internvl2-26b"])
def test_analytic_flops_cover_model_flops_dense(arch):
    """The counterpart of the reference's test: for dense archs the step
    does at least the useful work, analytic >= 6·N·D (waste terms only
    add)."""
    shape = SHAPES["train_4k"]
    cfg = get_config(arch)
    ana = analytic_cell_cost(cfg, shape, fake_mesh(*MESHES["16x16"]),
                             microbatches=16)
    assert ana["flops_total"] >= 0.95 * hlo_analysis.model_flops(cfg, shape)
