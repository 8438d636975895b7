"""The port's spans (``repro_torch.spans``): under a CPU ``torch.profiler``
a serving session and a training step open their ranges, nested where
their calls are; with no profiler the helper hands back one shared no-op
context, opens no ``record_function`` and leaves the results bit for bit
what they were."""
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_smoke
from repro_torch.core import boolean_linear
from repro_torch.core.optimizer import hybrid_optimizer, tree_leaves
from repro_torch.models import lm_init
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.train import make_train_step


def _ranges(prof):
    """(name, start ns, end ns, thread) of every host range, by start."""
    out = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation()]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _each_inside(ranges, inner, outer):
    """Every ``inner`` range lies in an ``outer`` one."""
    outs = _named(ranges, outer)
    ins = _named(ranges, inner)
    assert ins, inner
    for r in ins:
        assert any(_inside(r, o) for o in outs), (inner, outer)


def _serve(prompts, n_tokens):
    cfg = get_smoke("qwen2.5-14b").scaled(dtype=torch.float32)
    params = lm_init(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, max_len=64, packed=True, device="cpu")
    with eng.session(lanes=2, page_size=8, segment=3) as sess:
        hs = [sess.submit(p, SamplingParams(max_tokens=n_tokens))
              for p in prompts]
        sess.run_until_idle()
        return [h.tokens_so_far() for h in hs]


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 128, (n,)).astype(np.int32) for n in (20, 33)]


def test_serving_spans_nest(monkeypatch):
    """Admission ⊃ prefill ⊃ unpack (the unpack branch forced at these
    short prompts), admission ⊃ first-token read, segment ⊃ launch, read;
    drain after each segment; the launches close before the read opens."""
    monkeypatch.setattr(boolean_linear, "PACKED_GEMV_MAX_M", 8)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(_prompts(), 7)
    r = _ranges(prof)
    _each_inside(r, "serve.prefill", "serve.admit")
    _each_inside(r, "linear.unpack", "serve.prefill")
    _each_inside(r, "serve.first_token", "serve.admit")
    _each_inside(r, "serve.segment.launch", "serve.segment")
    _each_inside(r, "serve.segment.read", "serve.segment")
    assert len(_named(r, "serve.prefill")) == 2
    assert len(_named(r, "serve.first_token")) == 2
    segs = _named(r, "serve.segment")
    assert len(segs) == 2        # 7 tokens: the first, then 2 segments of 3
    assert len(_named(r, "serve.drain")) == len(segs)
    for s in segs:
        (launch,) = [x for x in _named(r, "serve.segment.launch")
                     if _inside(x, s)]
        (read,) = [x for x in _named(r, "serve.segment.read")
                   if _inside(x, s)]
        assert launch[2] <= read[1]
    for name in ("serve.segment", "serve.drain"):
        assert not any(_inside(x, a) for x in _named(r, name)
                       for a in _named(r, "serve.admit"))


def test_serving_without_unpack_opens_no_unpack_span():
    """Prompts within ``PACKED_GEMV_MAX_M`` rows take the GEMV: no
    ``linear.unpack`` range, the others as before."""
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(_prompts(), 4)
    names = {x[0] for x in _ranges(prof)}
    assert "linear.unpack" not in names
    assert {"serve.admit", "serve.prefill", "serve.first_token",
            "serve.segment", "serve.segment.launch", "serve.segment.read",
            "serve.drain"} <= names


def _train_setup(remat: bool):
    cfg = get_smoke("falcon-mamba-7b").scaled(dtype=torch.float32,
                                               remat=remat)
    params = lm_init(cfg, torch.Generator().manual_seed(1))
    opt = hybrid_optimizer(eta=1.0, fp_lr=1e-3)
    state = opt.init(params)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (4, 17), generator=g,
                        dtype=torch.int32)
    batch = {"tokens": ids[:, :-1].contiguous(),
             "labels": ids[:, 1:].contiguous()}
    return make_train_step(cfg, opt, microbatches=2), params, state, batch, \
        cfg


@pytest.mark.parametrize("remat", [False, True])
def test_training_spans(remat):
    """Each microbatch's forward and backward, the optimizer once, and
    the scan in the forward; under remat the scan opens again inside the
    backward (the recompute), on whichever thread runs it."""
    step, params, state, batch, cfg = _train_setup(remat)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, batch)
    r = _ranges(prof)
    assert len(_named(r, "train.forward")) == 2
    assert len(_named(r, "train.backward")) == 2
    assert len(_named(r, "train.optimizer")) == 1
    scans = _named(r, "mamba.scan")
    fwd = [s for s in scans if any(_inside(s, f)
                                   for f in _named(r, "train.forward"))]
    bwd = [s for s in scans if any(_inside(s, b)
                                   for b in _named(r, "train.backward"))]
    assert len(fwd) == 2 * cfg.n_layers
    assert len(bwd) == (2 * cfg.n_layers if remat else 0)
    assert len(scans) == len(fwd) + len(bwd)


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    """No profiler: one shared context, and a step calls no
    ``record_function`` at all (it would raise here)."""
    assert spans.span("serve.admit") is spans.span("mamba.scan") \
        is spans._OFF

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    step, params, state, batch, _ = _train_setup(True)
    step(params, state, batch)
    with torch.no_grad():
        _serve(_prompts(), 4)


def test_results_bit_identical_with_and_without_spans():
    """The same step and the same session, traced and untraced: the
    same loss, parameters, optimizer state and tokens, bit for bit."""
    step, params, state, batch, _ = _train_setup(True)
    p0, s0 = copy.deepcopy(params), copy.deepcopy(state)
    pa, sa, ma = step(params, state, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        pb, sb, mb = step(p0, s0, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    la = tree_leaves(pa) + tree_leaves(sa)
    lb = tree_leaves(pb) + tree_leaves(sb)
    assert len(la) == len(lb) > 0
    for a, b in zip(la, lb):
        assert torch.equal(a, b)
    with torch.no_grad():
        plain = _serve(_prompts(), 7)
        with profile(activities=[ProfilerActivity.CPU]):
            traced = _serve(_prompts(), 7)
    assert plain == traced
