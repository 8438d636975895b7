"""The port's roofline and collective record against the JAX package's
``launch/hlo_analysis.py``: ``roofline_terms`` on a test-local hardware
record with the reference's TPU v5e constants (one rate for both link
kinds) equals the reference's dict key by key; the bottleneck
classification under ``H100_SXM``; and a ``CollectiveRecord`` of
collectives issued on a fake-backend world (``FakeTensorMode`` tensors)
sums to the reference's ``collective_bytes(HLO_SAMPLE, (4, 13))``, the
sample's loop trips issued as repeated calls.
"""
import math

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import hlo_analysis as jax_hlo
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import fake_world

V5E = H.Hardware("TPU v5e (the reference's constants)", jax_hlo.PEAK_FLOPS_BF16,
                 jax_hlo.PEAK_OPS_INT8, jax_hlo.HBM_BW, jax_hlo.ICI_BW,
                 jax_hlo.ICI_BW, 8)

# the reference test's HLO sample (tests/test_analysis_models.py)
HLO_SAMPLE = """
  %ar = f32[4,4096,2304]{2,1,0} all-reduce(%x), replica_groups=[16,16]<=[256], metadata={op_name="jit(f)/while/body/foo"}
  %ag = bf16[16,128]{1,0} all-gather(%y), replica_groups=[4,4]<=[16], metadata={op_name="jit(f)/bar"}
  %rs = f32[8]{0} reduce-scatter(%z), replica_groups=[2,8]<=[16], metadata={op_name="jit(f)/while/body/while/body/baz"}
"""


@pytest.mark.parametrize("args", [
    (1e15, 1e9, 1e9, 256, 0.0, None),
    (1e9, 1e12, 1e9, 256, 0.0, 3e9),
    (1e9, 1e9, 1e12, 256, 0.25, 2e12),
    (3.3e12, 7.7e9, 4.4e8, 512, 0.5, 8.8e8),
    (0.0, 0.0, 0.0, 1, 0.0, 0.0),
])
def test_roofline_terms_equal_the_reference_under_its_constants(args):
    flops, nbytes, coll, chips, int8, ring = args
    want = jax_hlo.roofline_terms(flops, nbytes, coll, chips,
                                  int8_fraction=int8, ring_total=ring)
    got = H.roofline_terms(flops, nbytes, coll, chips, int8_fraction=int8,
                           ring_total=ring, hw=V5E)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k


def test_no_tpu_constant_in_the_default_record():
    hw = H.H100_SXM
    assert (hw.peak_flops_bf16, hw.peak_ops_int8, hw.hbm_bw, hw.node_bw,
            hw.net_bw, hw.node_size) == (989.4e12, 1978.9e12, 3.35e12, 450e9,
                                         50e9, 8)
    assert not hasattr(H, "PEAK_FLOPS_BF16") and not hasattr(H, "ICI_BW")


def test_roofline_bottleneck_classification_h100():
    t = H.roofline_terms(1e15, 1e9, 1e9, 256)        # compute dominates
    assert t["bottleneck"] == "compute"
    assert t["compute_s"] == 1e15 / 989.4e12
    t = H.roofline_terms(1e9, 1e12, 1e9, 256)        # memory dominates
    assert t["bottleneck"] == "memory"
    assert t["memory_s"] == 1e12 / 3.35e12
    t = H.roofline_terms(1e9, 1e9, 1e12, 256)        # collective dominates
    assert t["bottleneck"] == "collective"
    # 256 ranks span 32 nodes: the network's rate
    assert t["collective_s"] == 1e12 / 50e9
    assert 0 < t["roofline_fraction_of_compute"] <= 1
    # 8 ranks share a node: NVLink
    t = H.roofline_terms(1e9, 1e9, 1e12, 8)
    assert t["collective_s"] == 1e12 / 450e9


def test_link_rate_by_group():
    hw = H.H100_SXM
    assert hw.link_bw(range(8)) == 450e9
    assert hw.link_bw(range(8, 16)) == 450e9
    assert hw.link_bw(range(16)) == 50e9
    assert hw.link_bw((0, 16, 32)) == 50e9
    assert hw.link_bw((5,)) == 450e9


@pytest.fixture
def world():
    """A fake-backend world of 256 ranks (this process rank 0) with the
    sample's groups; destroyed afterwards."""
    mesh = fake_world((16, 16), ("data", "model"))
    groups = {n: dist.new_group(list(range(n))) for n in (4, 8, 16)}
    try:
        yield mesh, groups
    finally:
        for g in groups.values():
            dist.destroy_process_group(g)
        mesh.close()


def _issue_sample(groups, rec):
    """The sample's three ops, each as many times as its loop trips run:
    the all-reduce at depth 1 (4 trips), the all-gather at depth 0, the
    reduce-scatter at depth 2 (4 x 13 trips)."""
    fm = FakeTensorMode()
    with fm, rec:
        x = torch.empty((4, 4096, 2304), dtype=torch.float32, device="meta")
        for _ in range(4):
            dist.all_reduce(x, group=groups[16])
        y = torch.empty((4, 128), dtype=torch.bfloat16, device="meta")
        out = torch.empty((16, 128), dtype=torch.bfloat16, device="meta")
        dist.all_gather_into_tensor(out, y, group=groups[4])
        z = torch.empty((64,), dtype=torch.float32, device="meta")
        rs = torch.empty((8,), dtype=torch.float32, device="meta")
        for _ in range(4 * 13):
            dist.reduce_scatter_tensor(rs, z, group=groups[8])
        dist.broadcast(y, 0, group=groups[4])     # kept out of the sums


def test_collective_record_equals_the_hlo_parser(world):
    _, groups = world
    rec = H.CollectiveRecord()
    _issue_sample(groups, rec)
    want = jax_hlo.collective_bytes(HLO_SAMPLE, trip_stack=(4, 13))
    got = H.collective_bytes(rec)
    for k in (*jax_hlo.COLLECTIVES, "total", "ring_total",
              "ops_below_known_loops"):
        assert got[k] == want[k], k
    # the reference counts HLO instructions (3), whose trips multiply
    # their bytes; an eager record holds every issued call
    assert got["count"] == 4 + 1 + 52
    kinds = [op["kind"] for op in rec.ops]
    assert kinds.count("broadcast") == 1
    ar = rec.ops[0]
    assert (ar["dtype"], ar["shape"], ar["group"], ar["ranks"]) == \
        ("f32", (4, 4096, 2304), 16, tuple(range(16)))
    rs = [op for op in rec.ops if op["kind"] == "reduce-scatter"][0]
    assert (rs["shape"], rs["group"], rs["bytes"]) == ((8,), 8, 32)

    top = H.collective_breakdown(rec)
    assert [e["kind"] for e in top] == ["all-reduce", "reduce-scatter",
                                        "all-gather"]
    assert [e["count"] for e in top] == [4, 52, 1]
    assert sum(e["bytes"] for e in top) == want["total"]

    # per-op link rates: the 16-rank group crosses nodes, the 8- and
    # 4-rank groups do not
    op_s, ring_s = H.collective_seconds(rec)
    assert math.isclose(op_s, want["all-reduce"] / 50e9
                        + (want["all-gather"] + want["reduce-scatter"])
                        / 450e9, rel_tol=1e-12)
    terms = H.roofline_terms(1.0, 1.0, got["total"], 256,
                             ring_total=got["ring_total"], record=rec)
    assert terms["collective_s"] == op_s
    assert terms["collective_ring_s"] == ring_s


def test_call_sites_name_the_mesh_counter(world):
    mesh, _ = world
    rec = H.CollectiveRecord()
    with FakeTensorMode(), rec:
        t = torch.empty((3,), device="meta")
        mesh.all_reduce(t, "data", count="vote_reduces")
        mesh.all_gather(t, "model", 0)
    assert [op["site"] for op in rec.ops] == [
        "TrainMesh.all_reduce[vote_reduces]",
        "TrainMesh.all_gather[leaf_gathers]"]
    assert [op["ranks"][:3] for op in rec.ops] == [(0, 16, 32), (0, 1, 2)]
    assert mesh.counts["vote_reduces"] == 1
