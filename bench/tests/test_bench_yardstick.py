"""The frozen yardstick equals the port's own arithmetic at the commit
that defined the benchmark: the H100 record and roofline terms and the
model FLOPs of ``launch/hlo_analysis.py``, and ``chip_smoke.py``'s
phase-2 bound and live pairs."""
import sys

import pytest

from bench.harness import BENCH, ROOT, load_json
from bench.yardstick import peaks, work

CONFIGS = ("qwen2.5-14b", "falcon-mamba-7b-d16")


def _port_cfg(name):
    from bench.systems.serve import model_config
    return model_config(load_json(BENCH / "configs" / f"{name}.json")["model"])


def test_peaks_equal_the_ports():
    from repro_torch.launch import hlo_analysis as H
    assert peaks.H100_SXM.peak_flops_bf16 == H.H100_SXM.peak_flops_bf16
    assert peaks.H100_SXM.peak_ops_int8 == H.H100_SXM.peak_ops_int8
    assert peaks.H100_SXM.hbm_bw == H.H100_SXM.hbm_bw
    for flops, nbytes in ((1e12, 1e9), (1e9, 1e12)):
        mine = peaks.roofline_terms(flops, nbytes)
        theirs = H.roofline_terms(flops, nbytes, 0.0, 1)
        for k in ("compute_s", "memory_s", "step_time_lower_bound_s",
                  "bottleneck"):
            assert mine[k] == theirs[k]


@pytest.mark.parametrize("name", CONFIGS)
def test_params_and_model_flops_equal_the_ports(name):
    from repro_torch.launch import hlo_analysis as H
    cfg = _port_cfg(name)
    s = work.Sizes.of(load_json(BENCH / "configs" / f"{name}.json")["model"])
    assert work.params(s, padded=True) == H.active_params(cfg) \
        == H.total_params(cfg)
    # the yardstick's own count leaves out the q heads the port pads
    pad = 2 * s.d_model * (s.hp - s.n_heads) * s.hd * s.n_layers \
        if s.family != "ssm" else 0
    assert work.params(s) == work.params(s, padded=True) - pad

    class Shape:
        global_batch, seq_len = 4, 512
    for kind in ("train", "decode", "prefill"):
        Shape.kind = kind
        tokens = 4 if kind == "decode" else 4 * 512
        assert work.model_flops(s, kind, tokens, padded=True) == \
            H.model_flops(cfg, Shape)
    assert s.hp == cfg.heads_padded() and s.kvp == cfg.kv_heads_padded()
    assert s.vp == cfg.vocab_padded and s.di == cfg.d_inner_
    assert s.r == cfg.dt_rank_ and s.hd == cfg.head_dim_


def test_boolean_params_are_the_port_trees():
    import torch
    from bench import weights
    from repro_torch.models import lm_init
    for name in CONFIGS:
        model = dict(load_json(BENCH / "configs" / f"{name}.json")["model"])
        small = dict(model, n_layers=2)
        if model["family"] == "ssm":
            small.update(d_model=64, d_inner=128, dt_rank=8, ssm_state=4,
                         vocab_size=256)
        else:
            small.update(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                         d_ff=256, vocab_size=512)
        from bench.systems.serve import model_config
        tree = lm_init(model_config(small), torch.Generator().manual_seed(0))
        from bench.reference.train import flat
        port = {k: v.numel() for k, v in flat(tree).items()
                if v.dtype == torch.int8}
        assert sum(port.values()) == \
            work.Sizes.of(small).boolean_params(padded=True)
        mine = flat(weights.program_params(small, 1, "cpu"))
        assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in flat(tree).items()}


@pytest.mark.parametrize("name,published", [
    ("qwen2.5-14b", 13_212_057_600), ("falcon-mamba-7b-d16", 1_681_915_904)])
def test_boolean_work_counts_the_published_heads(name, published):
    """The Boolean weights the work counts are the published model's:
    qwen2.5-14b's 40 q heads, not the 48 the port holds."""
    s = work.Sizes.of(load_json(BENCH / "configs" / f"{name}.json")["model"])
    assert s.boolean_params() == published
    assert s.group == s.n_heads // s.n_kv_heads


def test_kernel_bounds_equal_chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    assert peaks.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    assert peaks.PEAK_FLOPS == cs.PEAK_FLOPS
    for S, w in ((1024, 0), (4096, 100), (37, 4096)):
        assert work.live_pairs(S, w) == cs._live_pairs(S, w)
    for nbytes, flops in ((1e9, 1e12), (5e9, 1e9)):
        ms, _ = cs.bound(nbytes, flops, "bf16")
        assert abs(peaks.bound_s(nbytes, flops) * 1e3 - ms) <= 1e-12 * ms
    # phase 2's GEMV and weight-backward operands, row for row
    M, K, N = 128, 5120, 6144
    b, f = work.gemv_work(M, K, N)
    assert (b, f) == (M * K * 2 + (K // 32) * N * 4 + M * N * 4,
                      2.0 * M * K * N)
    b, f = work.weight_bwd_work(1024, 4096, 8192)
    assert (b, f) == (1024 * 4096 * 2 + 1024 * 8192 * 2 + 4096 * 8192 * 4,
                      2.0 * 1024 * 4096 * 8192)
