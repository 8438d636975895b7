"""The reader of the port's spans (``bench/spans.py``) and the six
metrics that read them: attribution of kernels to the innermost range
that holds their launch, on fixed range and kernel lists; the join of
profiler events by correlation id and of the scan's backward by sequence
number, on fixed events; each reader's value on a fixed trace, and
nothing where the trace holds none of the port's ranges (the parent);
and on a real CPU profile of a small training step, the scan found by
sequence number against ``Trace.op_kernels_reading``'s shape grouping."""
from collections import Counter
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench import spans, weights
from bench.harness import load_metric
from bench.spans import SCAN, SCAN_BACKWARD, Spans
from bench.systems.serve import model_config
from bench.tests.small import cell
from bench.trace import Trace
from bench.traffic.train_steps import Traffic

MS = 1_000_000                          # ns in a ms

# a traced decode sub-window: an admission round (two prefills, one of
# more than PACKED_GEMV_MAX_M rows with two unpacks), then a decode round
DECODE = Spans(
    ranges=[("bench.session.step", 0, 100 * MS),
            ("serve.admit", 1 * MS, 60 * MS),
            ("serve.prefill", 2 * MS, 40 * MS),
            ("linear.unpack", 5 * MS, 10 * MS),
            ("linear.unpack", 20 * MS, 25 * MS),
            ("serve.first_token", 41 * MS, 50 * MS),
            ("serve.prefill", 51 * MS, 55 * MS),
            ("bench.session.step", 100 * MS, 200 * MS),
            ("serve.admit", 101 * MS, 102 * MS),
            ("serve.segment", 103 * MS, 190 * MS),
            ("serve.segment.launch", 104 * MS, 150 * MS),
            ("serve.segment.read", 150 * MS, 189 * MS),
            ("serve.drain", 191 * MS, 199 * MS)],
    kernels=[(6 * MS, 12 * MS, 6 * MS),         # unpack
             (21 * MS, 30 * MS, 21 * MS),       # unpack
             (30 * MS, 45 * MS, 26 * MS),       # the prefill's matmul
             (52 * MS, 56 * MS, 52 * MS),       # the GEMV prefill
             (106 * MS, 140 * MS, 105 * MS),    # decode steps
             (140 * MS, 160 * MS, 149 * MS)])

# two traced training steps: the forward's scan, the backward with one
# scan backward function that holds the remat's recompute of the scan
# (on the autograd thread, while train.backward stays open), the
# optimizer
TRAIN = Spans(
    ranges=[("bench.train.step", 0, 1000 * MS),
            ("train.forward", 10 * MS, 300 * MS),
            (SCAN, 50 * MS, 100 * MS),
            ("train.backward", 300 * MS, 800 * MS),
            (SCAN_BACKWARD, 400 * MS, 500 * MS),
            (SCAN, 420 * MS, 450 * MS),
            (SCAN_BACKWARD, 600 * MS, 650 * MS),
            ("train.optimizer", 850 * MS, 950 * MS),
            ("bench.train.step", 1000 * MS, 2000 * MS),
            ("train.optimizer", 1850 * MS, 1950 * MS)],
    kernels=[(20 * MS, 30 * MS, 15 * MS),       # forward, not the scan
             (55 * MS, 70 * MS, 55 * MS),       # scan: 15
             (310 * MS, 330 * MS, 305 * MS),    # backward, not the scan
             (405 * MS, 410 * MS, 401 * MS),    # scan backward: 5
             (430 * MS, 440 * MS, 425 * MS),    # recompute: 10
             (460 * MS, 480 * MS, 455 * MS),    # scan backward: 20
             (610 * MS, 611 * MS, 605 * MS),    # scan backward: 1
             (860 * MS, 900 * MS, 855 * MS),    # optimizer: 40
             (1860 * MS, 1880 * MS, 1855 * MS)])    # optimizer: 20

EXPECTED = {
    # the segment's 87 ms: kernels 106-160 ms, so 33 ms idle
    "idle_share.segment.decode": (DECODE, 100 * 33 / 87),
    # 59 + 1 ms of admissions: kernels cover 6 + 24 + 4 ms of the first
    "idle_share.admit.decode": (DECODE, 100 * (59 - 34 + 1) / 60),
    # 6 + 9 ms under the unpacks, over the one prefill that unpacked
    "unpack_ms.decode": (DECODE, 15.0),
    "scan_fwd_ms.train": (TRAIN, (15 + 10) / 2),
    "scan_bwd_ms.train": (TRAIN, (5 + 20 + 1) / 2),
    "optimizer_ms.train": (TRAIN, (40 + 20) / 2),
}


def _run(sp):
    return SimpleNamespace(traced=object(), port_spans=sp, notes=[])


def test_attribution_is_to_the_innermost_range():
    assert DECODE.owner == ["linear.unpack", "linear.unpack",
                            "serve.prefill", "serve.prefill",
                            "serve.segment.launch", "serve.segment.launch"]
    assert TRAIN.owner == ["train.forward", SCAN, "train.backward",
                           SCAN_BACKWARD, SCAN, SCAN_BACKWARD,
                           SCAN_BACKWARD, "train.optimizer",
                           "train.optimizer"]
    assert TRAIN.innermost(435 * MS) == SCAN
    assert TRAIN.innermost(1500 * MS) == "bench.train.step"
    assert TRAIN.innermost(2500 * MS) is None
    assert DECODE.holding("serve.prefill", "linear.unpack") == 1
    assert DECODE.steps("session.step") == 2


def test_idle_gaps_are_named_by_the_port_spans():
    """Each gap by the innermost range open where the card went idle:
    after the GEMV prefill, inside the first prefill between its unpacks,
    while the host waited on the first token."""
    assert DECODE.idle_gaps() == [
        ["serve.admit", pytest.approx(0.050)],
        ["serve.prefill", pytest.approx(0.009)],
        ["serve.first_token", pytest.approx(0.007)]]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_fixed_trace(name):
    sp, want = EXPECTED[name]
    assert load_metric(name).read(_run(sp)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_the_port_spans(name):
    """The parent's trace: the harness's ranges and kernels, none of the
    port's: no value, and no error. No trace at all: no value."""
    sp, _ = EXPECTED[name]
    bare = Spans([r for r in sp.ranges if r[0].startswith(spans.HARNESS)],
                 sp.kernels)
    assert load_metric(name).read(_run(bare)) is None
    assert load_metric(name).read(SimpleNamespace(traced=None)) is None


class _Ev:
    """A profiler event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, dev="CPU", t0=0, t1=0, corr=0, linked=0, tid=1,
                 seq=-1, fwd=0, ua=False):
        self._v = dict(name=name, device_type="DeviceType." + dev,
                       start_ns=t0, end_ns=t1, correlation_id=corr,
                       linked_correlation_id=linked, start_thread_id=tid,
                       sequence_nr=seq, fwd_thread_id=fwd,
                       is_user_annotation=ua)

    def __getattr__(self, k):
        return lambda: self._v[k]


def test_events_joined_by_correlation_and_sequence_number():
    bwd = "autograd::engine::evaluate_function: "
    ev = [_Ev(SCAN, t0=10, t1=20, corr=1, ua=True),
          _Ev(SCAN, "CUDA", t0=30, t1=40, corr=1, ua=True),   # its mirror
          _Ev("aten::mul", t0=12, t1=14, corr=100, seq=5),
          _Ev("cudaLaunchKernel", t0=13, t1=14, corr=900, linked=100),
          _Ev("mul_kernel", "CUDA", t0=30, t1=40, corr=900, linked=100),
          _Ev("aten::add", t0=25, t1=26, corr=102, seq=7),
          _Ev(bwd + "MulBackward0", t0=50, t1=60, corr=103, tid=2, seq=5,
              fwd=1),
          _Ev("cudaLaunchKernel", t0=55, t1=56, corr=901, linked=104, tid=2),
          _Ev("mul_bwd_kernel", "CUDA", t0=61, t1=70, corr=901, linked=104),
          _Ev(bwd + "AddBackward0", t0=70, t1=80, corr=105, tid=2, seq=7,
              fwd=1),
          _Ev("aten::add", t0=75, t1=76, corr=106, tid=2),
          # no runtime call recorded: the launching op's start stands in
          _Ev("add_bwd_kernel", "CUDA", t0=81, t1=90, corr=902, linked=106),
          # sequence number 5 of another thread: not the scan's
          _Ev(bwd + "MulBackward0", t0=90, t1=95, corr=107, tid=2, seq=5,
              fwd=2)]
    sp = Spans.of_events(ev)
    assert sp.ranges == [(SCAN, 10, 20), (SCAN_BACKWARD, 50, 60)]
    assert sp.kernels == [(30, 40, 13), (61, 70, 55), (81, 90, 75)]
    assert sp.owner == [SCAN, SCAN_BACKWARD, None]
    assert sp.device_s(SCAN) == 10 / 1e9
    assert sp.device_s(SCAN_BACKWARD) == 9 / 1e9


def test_spans_read_once_with_their_notes():
    events = SimpleNamespace(events=lambda: [])
    run = _run(None)
    run.traced = SimpleNamespace(prof=SimpleNamespace(
        profiler=SimpleNamespace(kineto_results=events)))
    first = spans.of(run)
    assert spans.of(run) is first and len(run.notes) == 4
    lines = DECODE.notes()
    assert "serve.segment 0.0870 / 0.0330" in lines[3]
    assert lines[0].startswith("idle gaps by span (s): serve.admit 0.050000")
    assert lines[-1].startswith("session.step covered by serve.admit, "
                                "serve.segment, serve.drain: 77.50%")


# ops that only make a view or read metadata launch no kernel on the card
NO_KERNEL = {"aten::view", "aten::as_strided", "aten::slice",
             "aten::select", "aten::unsqueeze", "aten::expand",
             "aten::permute", "aten::transpose", "aten::t", "aten::detach",
             "aten::alias", "aten::_unsafe_view", "aten::reshape",
             "aten::squeeze", "aten::empty", "aten::empty_strided",
             "aten::empty_like", "aten::lift_fresh", "aten::resolve_conj",
             "aten::resolve_neg", "aten::_reshape_alias", "aten::split",
             "aten::unbind", "aten::split_with_sizes", "aten::narrow",
             "aten::item", "aten::_local_scalar_dense", "aten::result_type"}
# the scan's ops whose operands do not end in (d_inner, N)
SCAN_ONLY = {"aten::copy_", "aten::to", "aten::mul", "aten::fill_",
             "aten::cat", "aten::add", "aten::add_"}


def test_scan_by_sequence_number_matches_the_shape_grouping():
    """At the small falcon size (d_inner 128, N 4, remat), one training
    step profiled with shapes on the CPU: the ops that launch kernels
    under a ``mamba.scan`` range or a ``mamba.scan.backward`` function
    (the sequence-number join), against those that
    ``Trace.op_kernels_reading((d_inner, N))`` groups. Every op of the
    shape grouping is found by the join, but for Adam's update of
    ``A_log`` (d_inner, N) in ``train.optimizer`` and the sum of its
    gradient over the microbatches (in the step, under no port range).
    The join finds more: the scan's ops whose operands do not end in
    (d_inner, N), ``SCAN_ONLY``: its casts to fp32 and back and their
    backward copies (``copy_``, ``to``), dt·x, the (B, Q, d_inner, 1) ×
    (B, Q, 1, N) product that makes x̄ and D·x (``mul``), the
    concatenation of the chunks' outputs (``cat``), the skip term's
    ``add``, the zeros that the backward of a slice and of the
    concatenation fill (``fill_``) and the gradients they sum
    (``add_``). Here the profiler records the shapes of ``cat``'s
    TensorList operand, so the doubling scan's ``cat`` per offset is in
    both groupings; on the card's torch 2.11 it records none, and the
    shape grouping misses that ``cat`` (PERF.md §5)."""
    c, cfgd = cell("falcon7b-train-2k")
    tp = c["traffic_params"]
    cfg = model_config(cfgd["model"])
    assert cfg.remat
    from repro_torch.core.optimizer import hybrid_optimizer
    from repro_torch.train import make_train_step
    torch.manual_seed(0)
    params = weights.program_params(cfgd["model"], 7, "cpu")
    opt = hybrid_optimizer(eta=float(tp["eta"]), fp_lr=float(tp["fp_lr"]))
    state = opt.init(params)
    step = make_train_step(cfg, opt, microbatches=int(tp["microbatches"]))
    traffic = Traffic(tp, 7, cfg.vocab_size)
    params, state, _ = step(params, state, traffic.batch(0, "cpu"))
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        step(params, state, traffic.batch(1, "cpu"))
    sp = Spans.of_events(prof.profiler.kineto_results.events())
    base = prof.profiler.kineto_results.trace_start_ns()
    tail = (cfg.d_inner_, cfg.ssm_state)
    both, joined_only, grouped_only = 0, Counter(), Counter()
    for e in prof.events():
        if e.cpu_children or not e.name.startswith("aten::") \
                or e.name in NO_KERNEL:
            continue
        fake = SimpleNamespace(device_type=e.device_type,
                               input_shapes=e.input_shapes,
                               kernels=[SimpleNamespace(duration=1e6)])
        one = SimpleNamespace(prof=SimpleNamespace(events=lambda: [fake]))
        mid = base + int(1000 * (e.time_range.start + e.time_range.end) / 2)
        owner = sp.innermost(mid)
        joined = owner in (SCAN, SCAN_BACKWARD)
        grouped = Trace.op_kernels_reading(one, tail) == 1.0
        both += joined and grouped
        if joined and not grouped:
            joined_only[e.name] += 1
        if grouped and not joined:
            grouped_only[(owner, e.name)] += 1
    assert both > 100
    assert {o for o, _ in grouped_only} == {"train.optimizer", None}, \
        grouped_only
    assert set(joined_only) <= SCAN_ONLY, joined_only
