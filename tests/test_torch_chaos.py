"""The port's chaos soak against the JAX package's (``-m soak``).

``FaultSchedule`` compiles per-site firing probabilities into concrete
``site@poll`` plans from ``np.random.default_rng``; the port's plans, specs
and JSON must equal the JAX package's byte for byte for every seed, rate
table and horizon, so a failing soak replays from one printed seed in
either package. The soak cases run the JAX package's
``tests/test_chaos_soak.py`` schedules through both packages' sessions
(gemma2-2b smoke width, fp32, bridged weights, the JAX session on its
gather path) and hold the reports equal: fired faults, outcomes, steps,
sheds, and every DONE never-recomputed greedy stream equal to the
fault-free oracle. The gateway soak runs the JAX package's
``test_gateway_soak_no_hung_sse_streams`` schedule through both packages'
HTTP gateways and holds their SSE responses equal.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.gateway import Gateway as JGateway
from repro.gateway import GatewayHTTP as JGatewayHTTP
from repro.models import attention as JA
from repro.models import lm_init as jax_lm_init
from repro.serve import DEFAULT_RATES as J_RATES
from repro.serve import FaultSchedule as JSchedule
from repro.serve import SamplingParams as JParams
from repro.serve import ServeEngine as JEngine
from repro.serve import soak_session as j_soak
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.gateway import Gateway, GatewayHTTP
from repro_torch.serve import (DEFAULT_RATES, FaultInjector, FaultSchedule,
                               SamplingParams, ServeEngine, soak_session)

pytestmark = pytest.mark.soak

torch.set_num_threads(1)

BASE_SEED = 1000


@pytest.fixture(scope="module")
def engines():
    cfg_j = jax_smoke("gemma2-2b").scaled(dtype=jnp.float32)
    cfg_t = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params = jax.tree.map(np.asarray,
                          jax_lm_init(jax.random.PRNGKey(0), cfg_j)[0])
    return (JEngine(cfg_j, jax.tree.map(jnp.asarray, params), max_len=32),
            ServeEngine(cfg_t, bridge.params_from_numpy(params, "cpu"),
                        max_len=32, device="cpu"))


def _prompts(cfg, lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
            for L in lens]


# ---------------------------------------------------------------------------
# schedules: the JAX package's plans and JSON, byte for byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,horizon", [(0, 64), (7, 48), (123, 64),
                                          (1016, 64), (2 ** 31 + 5, 200)])
def test_schedule_json_byte_identical_to_jax(seed, horizon):
    assert DEFAULT_RATES == J_RATES
    for rates in (DEFAULT_RATES, {"page_alloc": 0.5, "swap_in": 0.25},
                  {s: 0.1 for s in DEFAULT_RATES}):
        s = FaultSchedule.random(seed, rates, horizon=horizon)
        j = JSchedule.random(seed, rates, horizon=horizon)
        assert s.to_json() == j.to_json()
        assert s.spec() == j.spec() and repr(s) == repr(j)
        assert FaultSchedule.from_json(j.to_json()) == s


def test_same_seed_compiles_the_identical_plan():
    a = FaultSchedule.random(123, DEFAULT_RATES, horizon=64)
    b = FaultSchedule.random(123, DEFAULT_RATES, horizon=64)
    assert a.plan == b.plan and a == b
    assert a.plan != FaultSchedule.random(124, DEFAULT_RATES, horizon=64).plan


def test_schedule_spec_roundtrips_through_strict_from_env(tmp_path):
    s = FaultSchedule.random(9, DEFAULT_RATES, horizon=48)
    assert s.plan
    assert FaultInjector.from_env(s.spec())._at == s.injector()._at
    path = tmp_path / "plan.json"
    s.save(path)
    assert FaultSchedule.from_json(path.read_text()) == s
    assert path.read_text() == s.to_json() + "\n"
    assert json.loads(s.to_json())["seed"] == 9


def test_schedule_validation_is_strict():
    for Sched in (JSchedule, FaultSchedule):
        with pytest.raises(ValueError, match="unknown fault site"):
            Sched({"typo_site": [1]})
        with pytest.raises(ValueError, match="unknown fault site"):
            Sched.random(1, {"typo_site": 0.5})
        with pytest.raises(ValueError, match="rate"):
            Sched.random(1, {"page_alloc": 1.5})
        with pytest.raises(ValueError, match="negative"):
            Sched({"page_alloc": [-1]})
        with pytest.raises(ValueError, match="horizon"):
            Sched.random(1, DEFAULT_RATES, horizon=0)


# ---------------------------------------------------------------------------
# soaks: the same storm, the same wreckage in both packages
# ---------------------------------------------------------------------------
def _report(rep):
    return (rep.fired, rep.outcomes, rep.steps, rep.shed_submits,
            rep.identity_checked, rep.failures, rep.summary())


def _soak(eng, soak, P, schedule, prompts, n_tok, oracle, preempt, **kw):
    def make(inj):
        return eng.session(lanes=2, page_size=8, segment=2, audit=True,
                           faults=inj, prefix_cache=True, **kw)
    return soak(make, prompts, schedule,
                params_for=lambda i: P(max_tokens=n_tok),
                oracle=oracle, preempt_period=preempt, max_steps=500)


def test_seeded_soak_schedules_drain_clean(engines):
    """Seeded storms, the swap tier on every other one: each drains clean
    in both packages, with the same report."""
    jeng, teng = engines
    prompts = _prompts(teng.cfg, [9, 11, 7, 13, 10, 8])
    refs = [[int(x) for x in teng.generate(p[None], 6)[0]] for p in prompts]
    for i in range(4):
        schedule = FaultSchedule.random(BASE_SEED + i, DEFAULT_RATES,
                                        horizon=64)
        hb = 16 if i % 2 else None
        with JA.paged_kernel_override(False):
            want = _soak(jeng, j_soak, JParams,
                         JSchedule.from_json(schedule.to_json()), prompts, 6,
                         lambda k: refs[k], 5, host_page_budget=hb)
        got = _soak(teng, soak_session, SamplingParams, schedule, prompts, 6,
                    lambda k: refs[k], 5, host_page_budget=hb)
        assert got.ok, (BASE_SEED + i, got.failures)
        assert _report(got) == _report(want)
        assert got.identity_checked > 0


def test_soak_replays_exactly(engines):
    """Same seed, same storm, same wreckage: two runs of one schedule agree
    on every fired fault, outcome and token count."""
    _, teng = engines
    prompts = _prompts(teng.cfg, [9, 12, 7])
    schedule = FaultSchedule.random(BASE_SEED, DEFAULT_RATES, horizon=64)
    a, b = (_soak(teng, soak_session, SamplingParams, schedule, prompts, 5,
                  None, 4) for _ in range(2))
    assert a.ok and b.ok, (a.failures, b.failures)
    assert _report(a) == _report(b)


def test_soak_seed_zero_with_swap_tier(engines):
    """The seed the card's soak runs (``FaultSchedule.random(0,
    DEFAULT_RATES, horizon=64)``), with the swap tier and periodic
    preemption: ``report.ok`` and the JAX package's report."""
    jeng, teng = engines
    prompts = _prompts(teng.cfg, [9, 11, 7, 13, 10, 8, 12, 6], seed=3)
    refs = [[int(x) for x in teng.generate(p[None], 6)[0]] for p in prompts]
    schedule = FaultSchedule.random(0, DEFAULT_RATES, horizon=64)
    with JA.paged_kernel_override(False):
        want = _soak(jeng, j_soak, JParams, JSchedule.random(
            0, J_RATES, horizon=64), prompts, 6, lambda k: refs[k], 3,
            host_page_budget=12)
    got = _soak(teng, soak_session, SamplingParams, schedule, prompts, 6,
                lambda k: refs[k], 3, host_page_budget=12)
    assert got.ok, got.failures
    assert _report(got) == _report(want)


# ---------------------------------------------------------------------------
# gateway under storm: zero hung SSE streams, both gateways alike
# ---------------------------------------------------------------------------
class _Held:
    """The session as the gateway's step thread sees it: idle until
    ``release()``, so all the soak's requests are queued before the first
    admission round and both sessions meet the storm at the same steps."""

    def __init__(self, session):
        self._session = session
        self._go = threading.Event()

    def __getattr__(self, name):
        return getattr(self._session, name)

    @property
    def idle(self):
        return not self._go.is_set() or self._session.idle

    def release(self):
        self._go.set()


def _gateway_soak(G, H, eng, injector, prompts):
    """The JAX package's gateway soak: four SSE streams against a session
    under the storm; -> ({i: (kind, text)}, tracked after the drain)."""
    gw = G(eng, lanes=2, page_size=8, segment=2, prefix_cache=True,
           audit=True, faults=injector, max_pending=8)
    gw.session = _Held(gw.session)
    http = H(gw)
    host, port = http.start_background()
    url = f"http://{host}:{port}/v1/generate"
    results = {}

    def stream(i):
        body = json.dumps({"prompt": [int(t) for t in prompts[i]],
                           "max_tokens": 6,
                           "request_id": f"soak-{i}"}).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                results[i] = ("ok", r.read().decode())
        except urllib.error.HTTPError as e:
            results[i] = ("http", e.code)

    try:
        threads = []
        for i in range(len(prompts)):
            threads.append(threading.Thread(target=stream, args=(i,)))
            threads[-1].start()
            t0 = time.monotonic()
            while len(gw._tracked) < i + 1:
                assert time.monotonic() - t0 < 60, "request never queued"
                time.sleep(0.01)
        gw.session.release()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "hung SSE stream thread"
        t0 = time.monotonic()
        while gw._tracked and time.monotonic() - t0 < 5:
            time.sleep(0.1)
        with gw.lock:
            gw.session.audit()
            fired = gw.session.faults.fired
        return results, len(gw._tracked), fired
    finally:
        http.stop()
        gw.close()


@pytest.mark.parametrize("storm", ["reference", "dense"])
def test_gateway_soak_no_hung_sse_streams(engines, storm):
    """The JAX package's gateway soak (``FaultSchedule.random(BASE_SEED +
    77, DEFAULT_RATES, horizon=48)``, prefix cache, audit, a queue of 8)
    through both gateways: every SSE stream ends in ``end`` or a typed
    ``error`` echoing its request_id, the session's books audit clean after
    the drain with nothing tracked, and the two gateways' responses and
    fired faults are equal. That schedule fires nothing within this
    traffic's polls, so a denser one (every site at rate 0.15 over 8 polls:
    device_oom, kernel_dispatch and page_alloc fire, two streams fail and
    two finish) runs the same checks through faults that do fire."""
    jeng, teng = engines
    rates, horizon = ((DEFAULT_RATES, 48) if storm == "reference" else
                      ({s: 0.15 for s in DEFAULT_RATES}, 8))
    schedule = FaultSchedule.random(BASE_SEED + 77, rates, horizon=horizon)
    prompts = _prompts(teng.cfg, [9, 11, 7, 13])
    with JA.paged_kernel_override(False):
        want = _gateway_soak(JGateway, JGatewayHTTP, jeng, JSchedule.from_json(
            schedule.to_json()).injector(), prompts)
    got = _gateway_soak(Gateway, GatewayHTTP, teng, schedule.injector(),
                        prompts)
    assert got == want
    results, tracked, fired = got
    assert tracked == 0 and len(results) == len(prompts)
    assert (fired == []) == (storm == "reference"), fired
    for i, (kind, text) in sorted(results.items()):
        if kind == "http":
            assert text in (429, 503), text
            continue
        assert ("event: end" in text) or ("event: error" in text), \
            f"stream {i} got no terminal event: {text!r}"
        assert f'"request_id": "soak-{i}"' in text
