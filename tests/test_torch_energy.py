"""The port's energy model (paper Appendix E) against the JAX package's.

``repro_torch.energy`` is pure Python arithmetic, so over a seeded grid of
conv and linear shapes, every hierarchy, every pair of weight and
activation dtypes, forward and backward, its ``layer_energy``,
``network_energy`` and ``training_energy`` dicts equal the JAX package's
with ``==``, and its hardware tables are the JAX package's field for
field. The JAX package's property tests of the model
(``tests/test_analysis_models.py``, ``tests/test_substrate.py``) are run
on the port.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.energy as R
import repro.energy.model as RM
import repro_torch.energy as E
import repro_torch.energy.model as EM
from repro_torch.energy import (ASCEND, TPU_V5E, V100, ConvShape, LinearShape,
                                layer_energy, network_energy, training_energy)

HW = ("ASCEND", "V100", "TPU_V5E")
DTYPES = tuple(RM.BYTES)


def _grid(mod, seed=0, n=5):
    """``n`` conv and ``n`` linear shapes of ``mod`` drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        hw = int(rng.choice([4, 7, 8, 14, 16, 32]))
        f = int(rng.choice([1, 3, 5]))
        out.append(mod.ConvShape(N=int(rng.integers(1, 65)),
                                 M=int(rng.integers(8, 513)),
                                 C=int(rng.integers(3, 513)), HI=hw, WI=hw,
                                 HF=f, WF=f, stride=int(rng.choice([1, 2]))))
        out.append(mod.LinearShape(N=int(rng.integers(1, 257)),
                                   Cin=int(rng.integers(16, 4097)),
                                   Cout=int(rng.integers(16, 4097))))
    return out


def test_public_names_and_tables_are_the_references():
    names = ("ASCEND", "V100", "TPU_V5E", "ConvShape", "LinearShape",
             "layer_energy", "network_energy", "training_energy")
    assert all(hasattr(E, n) for n in names)
    for h in HW:
        assert dataclasses.asdict(getattr(E, h)) == \
            dataclasses.asdict(getattr(R, h))
    assert EM.BYTES == RM.BYTES
    assert EM._ADD_FRACTION == RM._ADD_FRACTION
    assert EM._NUMERIC_EQUIV == RM._NUMERIC_EQUIV
    for shape in _grid(EM):
        ref = (RM.ConvShape if isinstance(shape, ConvShape)
               else RM.LinearShape)(**dataclasses.asdict(shape))
        if isinstance(shape, ConvShape):
            assert (shape.HO, shape.WO, shape.macs(), shape.ifmap_elems(),
                    shape.filter_elems(), shape.ofmap_elems()) == \
                (ref.HO, ref.WO, ref.macs(), ref.ifmap_elems(),
                 ref.filter_elems(), ref.ofmap_elems())
        else:
            assert dataclasses.asdict(shape.as_conv()) == \
                dataclasses.asdict(ref.as_conv())


@pytest.mark.parametrize("hw", HW)
def test_layer_energy_equals_reference(hw):
    """Every shape of the grid, every (weight, activation) dtype pair,
    forward and backward: the same dict, compared with ``==``."""
    mine, ref = getattr(E, hw), getattr(R, hw)
    n = 0
    for shape, rshape in zip(_grid(EM, seed=1), _grid(RM, seed=1)):
        for w in DTYPES:
            for a in DTYPES:
                for mode in ("forward", "backward"):
                    got = layer_energy(shape, mine, w, a, mode)
                    assert got == RM.layer_energy(rshape, ref, w, a, mode), \
                        (shape, w, a, mode)
                    n += 1
    assert n == 10 * len(DTYPES) ** 2 * 2


@pytest.mark.parametrize("hw", HW)
def test_network_and_training_energy_equal_reference(hw):
    """Whole networks (seeded layer lists), forward and backward, and a
    training iteration for every dtype pair, with and without latent
    weights, with the default gradient dtype and with int16."""
    mine, ref = getattr(E, hw), getattr(R, hw)
    for seed in range(2):
        layers, rlayers = _grid(EM, seed=10 + seed, n=2), \
            _grid(RM, seed=10 + seed, n=2)
        for w in DTYPES:
            for a in DTYPES:
                for mode in ("forward", "backward"):
                    assert network_energy(layers, mine, w, a, mode) == \
                        RM.network_energy(rlayers, ref, w, a, mode)
                for latent in (False, True):
                    for g in (None, "int16"):
                        assert training_energy(
                            layers, mine, w, a, g, latent) == \
                            RM.training_energy(rlayers, ref, w, a, g, latent)


# ---------------------------------------------------------------------------
# the JAX package's properties of the model, on the port
# ---------------------------------------------------------------------------
@settings(max_examples=25, deadline=None)
@given(st.integers(1, 64), st.integers(8, 256), st.integers(8, 256),
       st.integers(4, 64))
def test_energy_monotone_in_size(n, m, c, hw):
    small = ConvShape(N=n, M=m, C=c, HI=hw, WI=hw, HF=3, WF=3)
    big = ConvShape(N=n, M=2 * m, C=c, HI=hw, WI=hw, HF=3, WF=3)
    for h in (ASCEND, V100, TPU_V5E):
        e_s = layer_energy(small, h, "bool", "bool")["total_pj"]
        e_b = layer_energy(big, h, "bool", "bool")["total_pj"]
        assert e_b > e_s


@settings(max_examples=25, deadline=None)
@given(st.integers(16, 512), st.integers(16, 512), st.integers(1, 128))
def test_energy_dtype_ordering(cin, cout, n):
    layer = LinearShape(N=n, Cin=cin, Cout=cout)
    for h in (ASCEND, V100, TPU_V5E):
        e_bool = layer_energy(layer, h, "bool", "bool")["total_pj"]
        e_int8 = layer_energy(layer, h, "int8", "int8")["total_pj"]
        e_fp32 = layer_energy(layer, h, "fp32", "fp32")["total_pj"]
        assert e_bool < e_int8 < e_fp32


def test_training_energy_latent_penalty():
    layers = [ConvShape(N=32, M=64, C=64, HI=16, WI=16, HF=3, WF=3)]
    for h in (ASCEND, V100, TPU_V5E):
        bold = training_energy(layers, h, "bool", "bool")["total_pj"]
        bnn = training_energy(layers, h, "bool", "bool",
                              latent_weights=True)["total_pj"]
        assert bnn > 1.5 * bold


def test_energy_bold_beats_fp_and_bnn():
    layers = [ConvShape(N=64, M=128, C=128, HI=32, WI=32, HF=3, WF=3)]
    for hw in (ASCEND, V100):
        fp = training_energy(layers, hw, "fp32", "fp32")["total_pj"]
        bnn = training_energy(layers, hw, "bool", "bool",
                              latent_weights=True)["total_pj"]
        bold = training_energy(layers, hw, "bool", "bool")["total_pj"]
        assert bold < bnn < fp
        assert bold / fp < 0.15


def test_energy_memory_dominates_small_arithmetic():
    e = layer_energy(LinearShape(N=1, Cin=1024, Cout=1024), ASCEND,
                     "bool", "bool")
    assert e["memory_pj"] > e["compute_pj"]
