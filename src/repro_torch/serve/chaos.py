"""Chaos soak: seeded randomized fault schedules, replayable byte-for-byte.

The port of the JAX package's ``serve/chaos.py``; ``FaultSchedule.random``
draws from ``np.random.default_rng`` exactly as the JAX package does, so a
seed compiles to the same plan and the same JSON in both packages.

The ``FaultInjector`` drills hand-picked single faults — one
``site@poll``, one containment path, one assertion. That proves each
containment mechanism exists; it does not prove the mechanisms COMPOSE.
A swap-out fault during the recovery from a pool loss, an OOM victim
whose pages the prefix index still references, an index quarantine racing
an admission burst: the dangerous states are the cross products, and
B⊕LD's ``sign()`` activations turn any missed composition into
confidently wrong tokens rather than a visible crash.

This module is the storm generator on top of the same injector:

  * ``FaultSchedule.random(seed, rates)`` compiles per-site firing
    PROBABILITIES into a concrete ``site@poll`` plan — one Bernoulli draw
    per poll index per site from ``np.random.default_rng(seed)``. The
    plan is a plain dict, so a random schedule and a hand-written one are
    indistinguishable to the injector.
  * Every schedule serializes (``to_json`` / ``spec``): a failing soak
    reproduces byte-for-byte from one printed seed — re-running
    ``FaultSchedule.random(seed, rates, horizon)`` regenerates the
    IDENTICAL plan, and the saved JSON replays it even if the generator
    ever changes.
  * ``soak_session`` runs one schedule against a live session to drain
    and audits the wreckage: every handle terminal, allocator + index
    invariants clean, and greedy streams that finished without recompute
    resumes spot-checked BIT-IDENTICAL against a fault-free oracle.

The contract under storm is the same binary containment contract as
single-fault drills — no new leniency: every fault resolves to a terminal
status on its victim, every page is released, and surviving greedy
streams are bit-identical to a fault-free run.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .faults import SITES, FaultInjector
from .scheduler import TERMINAL, RequestStatus, ShedError


class FaultSchedule:
    """A concrete, serializable ``site → [poll indices]`` plan.

    Wraps the plain-dict plan the ``FaultInjector`` constructor takes,
    plus the provenance needed to reproduce it (seed / rates / horizon
    when randomly generated). Site names are validated here, mirroring
    the injector's strict ``from_env`` — a typo'd site must never compile
    into a plan that silently never fires.
    """

    def __init__(self, plan: Dict[str, Sequence[int]], *,
                 seed: Optional[int] = None,
                 rates: Optional[Dict[str, float]] = None,
                 horizon: Optional[int] = None):
        self.plan: Dict[str, List[int]] = {}
        for site, idxs in plan.items():
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r} in schedule "
                    f"(have {SITES})")
            idxs = sorted(int(i) for i in idxs)
            if idxs and idxs[0] < 0:
                raise ValueError(
                    f"negative poll index for site {site!r}")
            if idxs:
                self.plan[site] = idxs
        self.seed = seed
        self.rates = dict(rates) if rates else None
        self.horizon = horizon

    @classmethod
    def random(cls, seed: int, rates: Dict[str, float],
               horizon: int = 64) -> "FaultSchedule":
        """Compile per-site firing probabilities into a concrete plan:
        for each site, one Bernoulli(``rates[site]``) draw per poll index
        in ``0..horizon-1``. Sites are drawn in sorted order so the plan
        is a pure function of ``(seed, rates, horizon)`` — the whole
        reproducibility story hangs on that."""
        if horizon < 1:
            raise ValueError("horizon must be >= 1")
        for site, p in rates.items():
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r} in rates (have {SITES})")
            if not 0.0 <= float(p) <= 1.0:
                raise ValueError(
                    f"rate for {site!r} must be in [0, 1], got {p}")
        rng = np.random.default_rng(seed)
        plan: Dict[str, List[int]] = {}
        for site in sorted(rates):
            fire = rng.random(horizon) < float(rates[site])
            idxs = np.flatnonzero(fire)
            if idxs.size:
                plan[site] = [int(i) for i in idxs]
        return cls(plan, seed=seed, rates=rates, horizon=horizon)

    def injector(self) -> FaultInjector:
        """A fresh injector armed with this plan (injectors count polls,
        so every run needs its own)."""
        return FaultInjector({s: list(i) for s, i in self.plan.items()})

    def spec(self) -> str:
        """The plan as a ``REPRO_FAULTS``-style string
        (``site@idx,site@idx``) — round-trips through the strict
        ``FaultInjector.from_env`` parser, so a failing soak's plan can be
        replayed against the launcher with one env var."""
        parts = []
        for site in sorted(self.plan):
            parts.extend(f"{site}@{i}" for i in self.plan[site])
        return ",".join(parts)

    def to_json(self) -> str:
        """Canonical JSON (sorted keys): the artifact a failing CI soak
        uploads. Carries both the concrete plan AND the generator inputs,
        so replay works from either."""
        return json.dumps({"plan": self.plan, "seed": self.seed,
                           "rates": self.rates, "horizon": self.horizon},
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        d = json.loads(text)
        return cls(d["plan"], seed=d.get("seed"), rates=d.get("rates"),
                   horizon=d.get("horizon"))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    def __eq__(self, other) -> bool:
        return isinstance(other, FaultSchedule) and self.plan == other.plan

    def __repr__(self) -> str:
        return (f"FaultSchedule(seed={self.seed}, "
                f"sites={sorted(self.plan)}, "
                f"armed={sum(len(v) for v in self.plan.values())})")


@dataclass
class SoakReport:
    """What one schedule did to one session — the evidence a soak
    assertion reads. ``failures`` is the verdict: empty means the
    containment contract held under this storm."""
    seed: Optional[int]
    spec: str
    steps: int = 0
    fired: List[Tuple[str, int]] = field(default_factory=list)
    #: rid → (terminal status name, fail reason or None, token count)
    outcomes: Dict[int, Tuple[str, Optional[str], int]] = \
        field(default_factory=dict)
    shed_submits: int = 0
    identity_checked: int = 0
    failures: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    def summary(self) -> str:
        by_status: Dict[str, int] = {}
        for status, _, _ in self.outcomes.values():
            by_status[status] = by_status.get(status, 0) + 1
        return (f"seed={self.seed} steps={self.steps} "
                f"fired={len(self.fired)} outcomes={by_status} "
                f"shed_submits={self.shed_submits} "
                f"identity_checked={self.identity_checked} "
                f"failures={len(self.failures)}")


def soak_session(make_session: Callable[[FaultInjector], "object"],
                 prompts: Sequence, schedule: FaultSchedule, *,
                 params_for: Optional[Callable[[int], "object"]] = None,
                 oracle: Optional[Callable[[int], Sequence[int]]] = None,
                 preempt_period: Optional[int] = None,
                 max_steps: int = 2000) -> SoakReport:
    """Run ONE schedule against ONE session to drain; return the report.

    ``make_session(injector)`` builds the session under test (the caller
    owns geometry / audit flags — pass ``audit=True`` for the post-step
    invariant walk). ``prompts[i]`` is submitted with ``params_for(i)``
    (default greedy); a shed submit is a LEGAL outcome under storm and is
    only counted. ``preempt_period`` deterministically evicts the
    lowest active lane every N steps, so swap/recompute resume paths sit
    inside the storm too. ``oracle(i)`` returns the fault-free token
    stream for prompt ``i``; every greedy request that finished DONE with
    zero recompute resumes must match it BIT-exactly (kernel fallback,
    swap resume, and co-residency with victims are all bit-preserving by
    contract).

    Checks, in order: (1) drain within ``max_steps`` (a hang IS a
    containment failure); (2) every submitted handle terminal before
    ``close()``; (3) FAILED/SHED/EXPIRED requests carry a typed reason;
    (4) ``session.audit()`` clean after drain; (5) oracle bit-identity.
    All violations are RECORDED, not raised — the caller gets the full
    wreckage plus the schedule that caused it.
    """
    inj = schedule.injector()
    report = SoakReport(seed=schedule.seed, spec=schedule.spec())
    sess = make_session(inj)
    handles = {}
    try:
        for i, prompt in enumerate(prompts):
            params = params_for(i) if params_for is not None else None
            try:
                handles[i] = sess.submit(prompt, params)
            except ShedError:
                report.shed_submits += 1
        live = True
        while live and report.steps < max_steps:
            live = sess.step()
            report.steps += 1
            if preempt_period and report.steps % preempt_period == 0 \
                    and sess.sched.active:
                lane = min(sess.sched.active)
                h = sess._handles.get(sess.sched.active[lane].rid)
                if h is not None:
                    sess.preempt(h)
        if live:
            report.failures.append(
                f"hang: session still live after {max_steps} steps")
        for i, h in handles.items():
            status = h.status
            if status not in TERMINAL:
                report.failures.append(
                    f"prompt {i} (rid {h.rid}) non-terminal after drain: "
                    f"{status.name}")
                continue
            report.outcomes[h.rid] = (status.name, h.error, h.tokens_ready)
            if status in (RequestStatus.FAILED, RequestStatus.SHED,
                          RequestStatus.EXPIRED) and not h.error:
                report.failures.append(
                    f"prompt {i} (rid {h.rid}) terminal {status.name} "
                    "without a typed reason")
            if oracle is not None and status is RequestStatus.DONE \
                    and h.preempt_recompute == 0:
                p = params_for(i) if params_for is not None else None
                if p is None or getattr(p, "temperature", 0.0) == 0.0:
                    want = [int(t) for t in oracle(i)]
                    got = h.tokens_so_far()
                    report.identity_checked += 1
                    if got != want:
                        report.failures.append(
                            f"prompt {i} (rid {h.rid}) DONE but NOT "
                            f"bit-identical to fault-free oracle: "
                            f"got {got} want {want}")
        try:
            sess.audit()
        except Exception as e:                        # noqa: BLE001
            report.failures.append(
                f"audit failed after drain: {type(e).__name__}: {e}")
    finally:
        report.fired = list(inj.fired)
        try:
            sess.close()
        except Exception as e:                        # noqa: BLE001
            report.failures.append(
                f"close failed: {type(e).__name__}: {e}")
    return report


#: default per-site rates for soak drills — every single-device site the
#: session polls, weighted so a horizon-64 storm fires a handful of
#: faults without drowning admission (shed-everything runs drill nothing).
DEFAULT_RATES: Dict[str, float] = {
    "page_alloc": 0.04,
    "fork_page": 0.04,
    "kernel_dispatch": 0.06,
    "prefix_index": 0.03,
    "swap_out": 0.05,
    "swap_in": 0.05,
    "host_pool": 0.04,
    "device_oom": 0.04,
}
