"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the
CPU: each cell in a subprocess, since the fake world belongs to its
process, writing into ``tmp_path``; the subprocesses run at once.

- gemma2-2b × decode_32k and × prefill_32k × single are ``ok`` under the
  JAX package's placement (``lm_init``'s specs: FSDP over "data", the
  "model" splits; k/v replicated over the 16 "model" ranks, 4 KV heads),
  peaks under those of whole weights on every rank (5.33 and 22.44 GiB),
  and their recorded collectives equal, op by op, the cell's formula:
  the embedding's FSDP gather over
  "data" and its vocab-parallel sum over "model", then for each layer
  group one flat FSDP gather of its int8 slices and, per attention layer,
  the heads' gather over "model" (decode: the token's q heads, before
  the slab's read; prefill: the flash kernel's outputs, before ``wo``),
  the decode's three ``seq_combines`` all-reduces of the seq-sharded read
  (``models/attention.py::_decode_seq_sharded``: the max, the rescaled
  sum, the rescaled accumulator) and the row-split ``wd``'s sum; then the
  head's FSDP gather and the logits' gather over "model" to the whole
  vocab. The prefill trades no heads for cache rows (k/v replicated) and
  launches row 4 once a layer.
- gemma2-2b's smoke widths (``--variant``) × train_4k × single is ``ok``
  with every collective of the step under the JAX package's placement
  counted: per microbatch the FSDP all-gathers over "data" (the
  embedding, each layer group's slices in its forward and again in its
  recompute, the head) and their grads' reduce-scatters, the "model" sums
  (the vocab-parallel lookup, each row-split ``wd``), the three loss
  statistics over the vocab shards, the head gathers, the activation-grad
  sums of the column-split q/k/v/gate/up and of the head's input (and, its
  2 KV heads fewer than the 16 "model" ranks, the replicated k/v votes'
  sums); once a step the grads of the leaves whole over "data" and the
  loss all-reduced over "data", and the flip counts of the split Boolean
  leaves over each axis they split over. The record states the placement
  and its two differences from the JAX package's.
- The same cell traced at 2 and 6 layers and 1 and 2 microbatches
  (``--depths``) and extrapolated equals the whole trace's collectives,
  call sites and launches exactly, and its peak within 1%.
- ``--calibrate`` reports analytic / counted FLOPs within [0.5, 2] for
  gemma2-2b's three kinds.
- ``--lower-only`` builds the inputs and traces nothing.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.optimizer import tree_leaves
from repro_torch.launch.shapes import SHAPES
from repro_torch.launch.shardings import apply_policy
from repro_torch.models import lm_init

ROOT = Path(__file__).resolve().parents[1]
SMOKE = get_smoke("gemma2-2b")
# the smoke config's widths over the full config (a variant overrides
# fields of the published config)
VARIANT = {k: getattr(SMOKE, k) for k in (
    "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
    "vocab_size", "sliding_window")}

RUNS = {
    "decode": ["--arch", "gemma2-2b", "--shape", "decode_32k", "--mesh",
               "single"],
    "prefill": ["--arch", "gemma2-2b", "--shape", "prefill_32k", "--mesh",
                "single"],
    "train": ["--arch", "gemma2-2b", "--shape", "train_4k", "--mesh",
              "single", "--variant", json.dumps(VARIANT), "--tag", "smoke"],
    "cut": ["--arch", "gemma2-2b", "--shape", "train_4k", "--mesh",
            "single", "--variant", json.dumps(VARIANT), "--tag", "cut",
            "--depths", "2,6"],
    "lower": ["--arch", "gemma2-2b", "--shape", "train_4k", "--mesh",
              "single", "--lower-only", "--tag", "lower"],
    "cal-train": ["--arch", "gemma2-2b", "--calibrate", "--shape", "train_4k"],
    "cal-prefill": ["--arch", "gemma2-2b", "--calibrate", "--shape",
                    "prefill_32k"],
    "cal-decode": ["--arch", "gemma2-2b", "--calibrate", "--shape",
                   "decode_32k"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run at once, each in its own directory -> {name: (stdout,
    out dir)}; each must exit 0."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for name, args in RUNS.items():
        out = tmp / name
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), out)
    done = {}
    try:
        for name, (p, out) in procs.items():
            stdout, stderr = p.communicate(timeout=400)
            assert p.returncode == 0, f"{name}:\n{stderr[-4000:]}"
            done[name] = (stdout, out)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return done


def _record(runs, name, file):
    rec = json.loads((runs[name][1] / file).read_text())
    assert rec["status"] == "ok", rec.get("traceback", rec)
    return rec


def _group_gather(cfg) -> int:
    """The elements of one layer group's flat FSDP gather over "data" on
    the 16 x 16 mesh: every leaf of the group cut over "data", at its
    "model" slice (``train_param_specs``' placement)."""
    from repro_torch.launch.shardings import kv_replicated, train_param_specs

    params = _meta_params(cfg)
    specs = train_param_specs(params, replicate_kv=kv_replicated(cfg, 16))
    n = 0
    for p, sp in zip(tree_leaves(params["blocks"]),
                     tree_leaves(specs["blocks"])):
        if "data" in sp:
            # a group's slice: every split dim but the group axis cut
            n += math.prod(p.shape[1:]) // 16 ** len(sp.axes())
    return 16 * n


def _meta_params(cfg):
    """Fake params at published widths (shapes, no storage)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return lm_init(cfg, torch.Generator().manual_seed(0))


def _serve_ops(cfg, per_layer, head_shape):
    """A serving cell's collectives by formula, (kind, dtype, shape,
    group) in order: the embedding's FSDP gather and vocab-parallel sum,
    each group's FSDP gather and its layers' ``per_layer`` ops, the head's
    FSDP gather, the logits' vocab gather."""
    vd = cfg.vocab_padded * cfg.d_model // 16
    ops = [("all-gather", "bf16", [vd], 16),
           ("all-reduce", "bf16", head_shape + [cfg.d_model], 16)]
    for _ in range(cfg.n_groups):
        ops.append(("all-gather", "s8", [_group_gather(cfg)], 16))
        ops += per_layer * cfg.group_size
    ops += [("all-gather", "bf16", [vd], 16),
            ("all-gather", "f32", [cfg.vocab_padded, head_shape[0], 1], 16)]
    return ops


def test_decode_cell_is_ok_and_its_collectives_are_the_formula(runs):
    rec = _record(runs, "decode", "gemma2-2b__decode_32k__single__baseline.json")
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    # a rank holding the whole weights peaked at 5.33 GiB
    assert 0 < rec["peak_bytes_per_device"] < 5.33 * 2 ** 30
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert rec["roofline"]["step_time_lower_bound_s"] > 0
    assert rec["collectives"]["total"] > 0 and rec["collectives"]["count"] > 0

    cfg = get_config("gemma2-2b")
    b = 128 // 16                                   # rows of a data rank
    kvp = cfg.kv_heads_padded()
    r = cfg.heads_padded() // kvp
    hd, D = cfg.head_dim_, cfg.d_model
    # each layer: the token's q head gathered (k/v replicated), the three
    # seq combines, the row-split wd's sum
    layer = [("all-gather", "bf16", [16, b, 1, 1, hd], 16),
             ("all-reduce", "f32", [b, kvp, r], 16),           # max
             ("all-reduce", "f32", [b, kvp, r], 16),           # sum
             ("all-reduce", "f32", [b, kvp, r, hd], 16),       # acc
             ("all-reduce", "f32", [b, 1, D], 16)]             # wd
    want = _serve_ops(cfg, layer, [b, 1])
    got = [(op["kind"], op["dtype"], op["shape"], op["group"])
           for op in rec["collective_ops"]]
    assert got == want
    n_attn = cfg.n_layers                          # every layer attends
    assert rec["collective_sites"] == {
        "all-gather TrainMesh.all_gather[fsdp_gathers]": 2 + cfg.n_groups,
        "all-reduce TrainMesh.all_reduce[model_sums]": 1 + n_attn,
        "all-gather TrainMesh.all_gather[head_gathers]": n_attn,
        "all-reduce TrainMesh.all_reduce[seq_combines]": 3 * n_attn,
        "all-gather TrainMesh.all_gather[vocab_gathers]": 1}
    assert rec["collectives"]["total"] == sum(
        rec["collectives"][k] for k in ("all-reduce", "all-gather"))
    pl = rec["placement"]
    assert pl["cache_seq"] == ["model"]
    assert pl["heads"] == "'model': q columns, k/v replicated"
    assert len(pl["stated_differences"]) == 2
    assert "one placement" in rec["roofline_placement"]["shared"]
    # the KV cache (int8 rows + scales) of this rank's slab of 2,048 rows
    assert rec["mem_by_kind"]["BUFFER"] == n_attn * 2 * b * (32768 // 16) \
        * kvp * (cfg.head_dim_ + 4)
    assert rec["fake_launches"] == {}


def test_prefill_cell_is_ok_and_its_collectives_are_the_formula(runs):
    rec = _record(runs, "prefill",
                  "gemma2-2b__prefill_32k__single__baseline.json")
    assert rec["mesh"] == "16x16"
    # a rank holding the whole weights peaked at 22.44 GiB
    assert 0 < rec["peak_bytes_per_device"] < 22.44 * 2 ** 30
    cfg = get_config("gemma2-2b")
    b, S = 32 // 16, 32768
    hd, D = cfg.head_dim_, cfg.d_model
    # each layer: the flash kernel's one q head gathered before wo, the
    # row-split wd's sum; k/v replicated: no heads traded for cache rows
    layer = [("all-gather", "bf16", [16, b, S, hd], 16),
             ("all-reduce", "f32", [b, S, D], 16)]
    want = _serve_ops(cfg, layer, [b, S])
    got = [(op["kind"], op["dtype"], op["shape"], op["group"])
           for op in rec["collective_ops"]]
    assert got == want
    assert "cache_exchanges" not in " ".join(rec["collective_sites"])
    assert rec["placement"]["cache_rows"].startswith("k/v replicated")
    # row 4 once a layer, on this rank's q head
    assert rec["fake_launches"] == {"flash_attention_fwd": cfg.n_layers}
    assert "one placement" in rec["roofline_placement"]["shared"]


def test_smoke_train_cell_counts_every_collective(runs):
    rec = _record(runs, "train", "gemma2-2b__train_4k__single__smoke.json")
    cfg = apply_policy(get_config("gemma2-2b").scaled(**VARIANT),
                       SHAPES["train_4k"], _Mesh)
    mb = rec["microbatches"]
    assert mb == 256 // (16 * 4)                # 4 rows a rank a microbatch
    n_attn = cfg.n_layers
    # 2 KV heads under 16 "model" ranks: k/v replicated, their votes summed
    assert cfg.kv_heads_padded() == 2
    assert rec["placement"]["heads"] == "'model': q columns, k/v replicated"
    assert len(rec["placement"]["stated_differences"]) == 2
    assert "one placement" in rec["roofline_placement"]["shared"]
    sites = rec["collective_sites"]
    remat = 2 if cfg.remat else 1
    groups = cfg.n_groups
    # the embedding, each group (forward and recompute) and the head
    assert sites["all-gather TrainMesh.all_gather[fsdp_gathers]"] \
        == mb * (2 + groups * remat)
    assert sites["reduce-scatter TrainMesh.reduce_scatter[fsdp_scatters]"] \
        == mb * (2 + groups)
    # the vocab-parallel lookup and each layer's row-split wd
    assert sites["all-reduce TrainMesh.all_reduce[model_sums]"] \
        == mb * (1 + n_attn * remat)
    # the loss's max, sum of exponentials and picked logit
    assert sites["all-reduce TrainMesh.all_reduce[vocab_reduces]"] == 3 * mb
    assert sites["all-gather TrainMesh.all_gather[head_gathers]"] \
        == n_attn * mb * remat
    # q, k, v, gate, up activation grads + the k and v votes, each layer,
    # and the head's input, each microbatch
    assert sites["all-reduce boolean_linear.all_reduce_sum"] \
        == n_attn * mb * 7 + mb
    # the grads of the leaves whole over "data" (each block role's two
    # norms and FFN tau, the final norm) and the loss, over "data", once a
    # step; the flip counts of each Boolean leaf over each axis it splits
    # over (q, gate, up, down: both; k, v, o: "data"), each block role
    roles = len(lm_init(cfg, torch.Generator().manual_seed(0))["blocks"])
    assert sites["all-reduce TrainMesh.all_reduce[grad_reduces]"] \
        == 3 * roles + 1 + 1
    assert sites["all-reduce TrainMesh.all_reduce[count_reduces]"] \
        == (4 * 2 + 3 * 1) * roles
    assert len(sites) == 8
    grads = [op for op in rec["collective_ops"]
             if op["site"].endswith("[grad_reduces]")]
    assert {op["group"] for op in grads} == {16}
    assert {op["dtype"] for op in grads} == {"f32"}
    scatters = [op for op in rec["collective_ops"]
                if op["site"].endswith("[fsdp_scatters]")]
    assert {(op["group"], op["dtype"]) for op in scatters} == {(16, "f32")}
    gathers = [op for op in rec["collective_ops"]
               if op["site"].endswith("[fsdp_gathers]")]
    assert {(op["group"], op["dtype"]) for op in gathers} == {(16, "bf16")}
    # the weight backward of 7 Boolean projections a layer a microbatch
    assert rec["fake_launches"] == {"boolean_weight_bwd": mb * n_attn * 7}
    kinds = rec["mem_by_kind"]
    assert kinds["PARAM"] > 0 and kinds["OPT"] > 0
    assert rec["peak_bytes_per_device"] >= kinds["PARAM"] + kinds["OPT"]


def test_depth_cut_extrapolates_the_whole_trace(runs):
    whole = _record(runs, "train", "gemma2-2b__train_4k__single__smoke.json")
    cut = _record(runs, "cut", "gemma2-2b__train_4k__single__cut.json")
    traced = cut["depth_cut"]["traced"]
    assert sorted((t["n_layers"], t["microbatches"]) for t in traced) == \
        [(2, 1), (2, 2), (6, 1), (6, 2)]
    assert cut["depth_cut"]["extrapolated_to"]["n_layers"] == 4
    assert cut["microbatches"] == whole["microbatches"]
    assert cut["collectives"] == whole["collectives"]
    assert cut["collective_sites"] == whole["collective_sites"]
    assert cut["fake_launches"] == whole["fake_launches"]
    assert abs(cut["peak_bytes_per_device"] / whole["peak_bytes_per_device"]
               - 1) < 0.01
    assert cut["roofline"]["collective_s"] == pytest.approx(
        whole["roofline"]["collective_s"], rel=1e-9)


class _Mesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def _n_leaves(cfg):
    return len(tree_leaves(lm_init(cfg, torch.Generator().manual_seed(0))))


def test_lower_only_traces_nothing(runs):
    rec = _record(runs, "lower", "gemma2-2b__train_4k__single__lower.json")
    assert "build_s" in rec and "trace_s" not in rec
    assert "collectives" not in rec and "peak_bytes_per_device" not in rec


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_calibration_ratio(runs, shape):
    name = "cal-" + shape.split("_")[0]
    rec = json.loads((runs[name][1] / f"calibrate__gemma2-2b__{shape}.json")
                     .read_text())
    ratio = rec["ratio_analytic_over_counted"]
    assert 0.5 <= ratio <= 2.0, rec
    assert rec["loopfree_counted_flops_per_dev"] > 0
    assert "analytic/counted" in runs[name][0]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_world(multi_pod):
    """``make_production_mesh`` builds the (16, 16) / (2, 16, 16) mesh on a
    fake world of that many ranks, its device ``meta``; the world's
    backend is ``"fake"`` only because this test chose it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    n = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        try:
            want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                    else {"data": 16, "model": 16})
            assert mesh.shape == want and mesh.size == n
            assert mesh.device == torch.device("meta")
            assert mesh.size_of(("pod", "data") if multi_pod else "data") \
                == n // 16
        finally:
            mesh.close()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
