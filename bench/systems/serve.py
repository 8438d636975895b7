"""Serving cells: the port's packed ``ServeEngine`` and its continuous-
batching session, driven through ``submit`` and ``step`` by the cell's
traffic, then checked against the plain reference.

``correct``: once the window has closed, a sample drawn from the seed of
the requests the window finished, the longest among them, is run through
the reference (prompt and served tokens, teacher-forced by the served
tokens) after the port's state is freed; each served token's logit may
lie below the reference's best at its position by at most the cell's
``served_logit_gap`` limit (the widest gap over the sample is compared),
and every finished request must carry its whole budget of tokens.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import time
from typing import List, Optional

import numpy as np

from bench import weights
from bench.reference.lm import served_logits
from bench.reference.numerics import Numerics, setup_matmuls


@dataclasses.dataclass
class Rec:
    client: int
    rid: int
    prompt: np.ndarray
    max_tokens: int
    handle: object
    due: float
    first_at: Optional[float] = None
    done_at: Optional[float] = None
    seen: int = 0
    tokens: Optional[list] = None
    status: str = ""


class Served:
    """The session as the traffic sees it, with the harness's own
    bookkeeping: when each request was due, when its tokens came back
    (the host clock at the end of the ``step()`` that returned them),
    and per step the work it asked of the card."""

    def __init__(self, session, terminal, segment: int):
        self.session = session
        self.terminal = terminal
        self.segment = segment
        self.recs: List[Rec] = []
        self.active: List[Rec] = []
        self.decoded = False        # whether the last step() decoded

    def submit(self, client, rid, prompt, max_tokens):
        from repro_torch.serve.scheduler import SamplingParams
        now = time.perf_counter()
        h = self.session.submit(prompt, SamplingParams(max_tokens=max_tokens))
        rec = Rec(client, rid, prompt, max_tokens, h, now)
        self.recs.append(rec)
        self.active.append(rec)
        return rec

    def pending(self) -> bool:
        return any(r.first_at is None for r in self.active)

    def step(self, run) -> List[Rec]:
        """One ``session.step()`` in a span that records the work it
        did: decode steps with their live lanes and KV rows read, or the
        prompt lengths it prefilled. Returns the requests it finished."""
        work = self.session.work
        d0, p0 = work["decode_steps"], sum(work["prefills"].values())
        decoding = [r for r in self.active if r.first_at is not None]
        seg = self.segment
        kv_rows = sum(seg * (len(r.prompt) + r.seen) + seg * (seg - 1) // 2
                      for r in decoding)
        with run.span("session.step") as sp:
            self.session.step()
        now = sp["t1"]
        admitted, done, emitted = [], [], 0
        for r in self.active:
            n = r.handle.tokens_ready
            if n > r.seen:
                emitted += n - r.seen
                if r.first_at is None:
                    r.first_at = now
                    admitted.append(len(r.prompt))
                r.seen = n
            if r.handle.status in self.terminal:
                r.done_at = now
                r.status = r.handle.status.name
                r.tokens = r.handle.tokens_so_far()
                done.append(r)
        if done:
            self.active = [r for r in self.active if r.done_at is None]
        self.decoded = work["decode_steps"] > d0
        sp["info"].update(
            decode_steps=work["decode_steps"] - d0,
            prefills=sum(work["prefills"].values()) - p0,
            lanes=len(decoding), kv_rows=kv_rows, admitted=admitted,
            emitted=emitted)
        return done


def model_config(model: dict):
    import torch
    from repro_torch.models import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in model.items() if k in fields and k != "dtype"}
    return ModelConfig(dtype=weights.DTYPES[model["dtype"]], **kw)


def sample(run, recs: List[Rec]) -> List[Rec]:
    """The requests the window finished, the longest (prompt + served)
    first, then ``check.sample - 1`` more drawn from the seed."""
    done = [r for r in recs if r.status == "DONE" and r.tokens
            and r.first_at is not None and r.due <= run.window[1]]
    if not done:
        return []
    done.sort(key=lambda r: r.rid)
    longest = max(done, key=lambda r: len(r.prompt) + len(r.tokens))
    rest = [r for r in done if r is not longest]
    k = min(int(run.cell["check"]["sample"]) - 1, len(rest))
    rng = np.random.default_rng([run.seed & 0xFFFFFFFF, run.seed >> 32, 11])
    pick = rng.choice(len(rest), size=k, replace=False) if k else []
    return [longest] + [rest[i] for i in sorted(pick)]


def gaps(logits, served) -> float:
    """Widest gap by which a served token's reference logit lies below
    the reference's best at its position."""
    import torch
    tok = torch.as_tensor(served, device=logits.device).long()[:, None]
    return float((logits.max(-1).values - logits.gather(-1, tok)[:, 0]).max())


def reference_gaps(run, picked: List[Rec], device, control: bool = False):
    """(widest gap of the served tokens, widest gap of the tokens the
    fp8 control puts first, or None), over ``picked``."""
    import torch
    setup_matmuls()
    seqs = [torch.from_numpy(np.concatenate(
        [r.prompt, np.asarray(r.tokens[:-1], np.int32)]).astype(np.int64))
        for r in picked]
    firsts = [len(r.prompt) - 1 for r in picked]
    ref = served_logits(run.model, run.seed, seqs, firsts,
                        Numerics("bfloat16"), device)
    served_gap = max(gaps(lg, r.tokens) for lg, r in zip(ref, picked))
    ctl_gap = None
    if control:
        ctl = served_logits(run.model, run.seed, seqs, firsts,
                            Numerics("fp8"), device)
        ctl_gap = max(gaps(lg, c.argmax(-1).tolist())
                      for lg, c in zip(ref, ctl))
    return served_gap, ctl_gap


def run(run) -> None:
    import torch
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.scheduler import TERMINAL

    cell, dev = run.cell, run.device
    cfg = model_config(run.model)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        with run.span("setup.weights"):
            params = weights.program_params(run.model, run.seed, dev)
        with run.span("setup.engine"):
            engine = ServeEngine(cfg, params, packed=True, device=dev,
                                 **cell["engine"])
            del params
        session = engine.session(**cell["session"])
        served = Served(session, TERMINAL, int(cell["session"]["segment"]))
        kind = importlib.import_module(f"bench.traffic.{cell['traffic']}")
        traffic = kind.Traffic(cell["traffic_params"], run.seed,
                               cfg.vocab_size)
        traffic.setup(run, served)
        run.warm_profiler()
        if dev == "cuda":
            torch.cuda.synchronize()
        run.setup_s = time.perf_counter() - run.t_start
        traffic.window(run, served)
        if dev == "cuda":
            torch.cuda.synchronize()
            run.memory_peak = int(torch.cuda.max_memory_allocated())
    w1 = run.window[1]
    due = [r for r in served.recs if r.due <= w1]
    run.attempted = len(due)
    # a request still under way when the loop was cut has not failed
    run.failed = sum(1 for r in due if r.done_at is not None
                     and r.status != "DONE")
    picked = sample(run, served.recs)
    short = sum(1 for r in served.recs if r.status == "DONE"
                and len(r.tokens) != r.max_tokens)
    session.close()
    del session, engine, served.session
    for r in served.recs:
        r.handle = None
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    limits = cell["check"]["limits"]
    ok = bool(picked)
    ok &= run.check("short_streams", float(short), 0.0)
    with torch.no_grad(), run.span("check.reference"):
        gap, ctl = reference_gaps(run, picked, dev,
                                  control=getattr(run, "control", False)) \
            if picked else (None, None)
    ok &= run.check("served_logit_gap", gap, limits["served_logit_gap"])
    if ctl is not None:
        run.control_reading = {"served_logit_gap": ctl}
    run.correct = ok
