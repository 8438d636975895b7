"""The port's HTTP/SSE gateway against the JAX package's: token streams.

Each case runs one script over live HTTP (``GatewayHTTP.start_background``,
``http.client``) against the JAX gateway and then the port's, on one set of
bridged weights (smoke width, fp32; the JAX session on its gather path,
which the JAX package pins bitwise to its Pallas kernel), and holds the
records equal: status codes, the ``Content-Type``, ``Retry-After`` and
``X-Request-Id`` headers, JSON bodies and SSE event sequences. Where the
JAX package's ``tests/test_gateway.py`` holds a stream to the sequential
oracle, the port's is held to its own ``engine.generate`` as well; the
hybrid config's stream differs from ``generate`` on the JAX package too (a
known failure there: its MoE capacity couples co-scheduled lanes), so it is
held to the JAX gateway's stream only. Requests that must share a segment
for their streams to be comparable are queued before the first admission
round (``_Held``), so both sessions admit them in the same order. The
protocol cases (rejections, /metrics, lifecycle, watchdog, the launcher)
are ``tests/test_torch_gateway_protocol.py``.

The emission-order cases hold the port's session to the rule the SSE
writer relies on: a request's terminal status is written only after its
last token, on cancel, expiry and an injected failure.
"""
import http.client
import json
import threading
import time

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
from repro.serve import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.gateway import Gateway, GatewayHTTP
from repro_torch.serve import (TERMINAL, FaultInjector, Request, RequestStatus,
                               ServeEngine)

torch.set_num_threads(1)

MAX_LEN = 32
CONFIGS = {"dense": ("gemma2-2b", False, False),
           "packed": ("gemma2-2b", True, False),
           "kv-quant": ("gemma2-2b", False, True),
           "ssm": ("falcon-mamba-7b", False, False),
           "hybrid": ("jamba-1.5-large-398b", False, False)}


@pytest.fixture(scope="module")
def pairs():
    """{config: (JAX engine, port engine)}, each built at first use."""
    return {}


def _engines(pairs, config="dense"):
    """(JAX engine, port engine) of ``config`` on one set of weights."""
    if config not in pairs:
        arch, packed, quant = CONFIGS[config]
        cfg_j = jax_smoke(arch).scaled(dtype=jnp.float32,
                                       kv_cache_quant=quant)
        cfg_t = get_smoke(arch).scaled(dtype=torch.float32,
                                       kv_cache_quant=quant)
        params = jax.tree.map(np.asarray,
                              jax_lm_init(jax.random.PRNGKey(0), cfg_j)[0])
        pairs[config] = (
            JEngine(cfg_j, jax.tree.map(jnp.asarray, params), max_len=MAX_LEN,
                    packed=packed),
            ServeEngine(cfg_t, bridge.params_from_numpy(params, "cpu"),
                        max_len=MAX_LEN, packed=packed, device="cpu"))
    return pairs[config]


class _Held:
    """The session as the gateway's step thread sees it: idle until
    ``release()``, so every request of a script is queued before the first
    admission round and both packages admit the same requests together.
    Everything else passes through to the session."""

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


def _run(pairs, config, script, held=False, **kw):
    """``script(gw, host, port)`` against the JAX gateway, then the port's;
    returns both records."""
    records = []
    jeng, teng = _engines(pairs, config)
    for G, H, eng, jax_side in ((JGateway, JGatewayHTTP, jeng, True),
                                (Gateway, GatewayHTTP, teng, False)):
        with JA.paged_kernel_override(False if jax_side else None):
            gw = G(eng, **kw)
            if held:
                gw.session = _Held(gw.session)
            srv = H(gw)
            host, port = srv.start_background()
            try:
                records.append(script(gw, host, port))
            finally:
                srv.stop()
                gw.close()
    return records


def _post(host, port, body, timeout=120):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request("POST", "/v1/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = (resp.status, dict(resp.getheaders()), resp.read().decode())
    conn.close()
    return out


def _parse_sse(text):
    """-> (tokens, [(terminal event, payload)])."""
    toks, terminals = [], []
    for block in text.strip().split("\n\n"):
        fields = dict(line.split(": ", 1) for line in block.splitlines())
        if fields.get("event") == "token":
            toks.append(int(fields["data"]))
        elif "event" in fields:
            terminals.append((fields["event"], json.loads(fields["data"])))
    return toks, terminals


def _view(result):
    """What the two gateways must agree on in one response."""
    status, headers, body = result
    keep = {k: headers[k] for k in ("Content-Type", "Retry-After",
                                    "X-Request-Id") if k in headers}
    if headers.get("Content-Type") == "text/event-stream":
        return status, keep, _parse_sse(body)
    return status, keep, json.loads(body)


def _paced(gw, seconds=0.05):
    """Each step of ``gw``'s session first waits ``seconds``, so a script's
    next move lands while its request is still decoding (a smoke-width step
    on the CPU takes milliseconds)."""
    step = gw.session.step

    def paced():
        time.sleep(seconds)
        return step()

    gw.session.step = paced


def _wait(cond, timeout=60.0, msg="condition"):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.01)


def _prompts(vocab, lens, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _post_queued(gw, host, port, bodies):
    """POST ``bodies`` from client threads in order (each queued before the
    next is sent), then release the held session; returns the results."""
    results = [None] * len(bodies)

    def worker(i):
        results[i] = _post(host, port, bodies[i])

    threads = []
    for i in range(len(bodies)):
        threads.append(threading.Thread(target=worker, args=(i,)))
        threads[-1].start()
        _wait(lambda: len(gw._tracked) == i + 1, msg=f"request {i} queued")
    gw.session.release()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "SSE client hung"
    return results


# ---------------------------------------------------------------------------
# acceptance identity: SSE over HTTP, both gateways, all configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config", list(CONFIGS))
def test_sse_stream_matches_jax_gateway(pairs, config):
    """Concurrent greedy requests over live HTTP (mirrors the JAX package's
    ``test_sse_stream_matches_sequential``): the port's SSE responses equal
    the JAX gateway's (status, headers, one ``token`` event a token, exactly
    one terminal ``end``), and but for the hybrid config each stream is the
    port's own sequential ``generate``."""
    jeng, teng = _engines(pairs, config)
    lens, ntoks = [5, 8, 11], [6, 3, 8]
    prompts = _prompts(teng.cfg.vocab_size, lens)
    bodies = [{"prompt": p.tolist(), "max_tokens": n}
              for p, n in zip(prompts, ntoks)]
    want, got = _run(pairs, config, lambda gw, h, p: [
        _view(r) for r in _post_queued(gw, h, p, bodies)],
        held=True, lanes=2, page_size=4, segment=2)
    assert got == want
    for i, (status, headers, (toks, terminals)) in enumerate(got):
        assert status == 200
        assert headers == {"Content-Type": "text/event-stream",
                           "X-Request-Id": str(i)}
        assert terminals == [("end", {"status": "done", "tokens": ntoks[i],
                                      "preempted": 0, "preempted_swap": 0,
                                      "preempted_recompute": 0})]
        if config != "hybrid":
            ref = teng.generate(prompts[i][None], ntoks[i])[0]
            assert toks == [int(t) for t in ref], i


def test_nonstream_json_matches_jax_gateway(pairs):
    """``"stream": false`` answers one JSON body, the JAX gateway's, with
    the sequential oracle's tokens."""
    jeng, teng = _engines(pairs)
    p = _prompts(teng.cfg.vocab_size, [6])[0]
    want, got = _run(pairs, "dense", lambda gw, h, port: _view(_post(
        h, port, {"prompt": p.tolist(), "max_tokens": 8, "stream": False})),
        lanes=2, page_size=4)
    assert got == want
    status, headers, obj = got
    assert status == 200 and headers == {"Content-Type": "application/json"}
    assert obj["status"] == "done" and obj["event"] == "end"
    assert obj["tokens"] == [int(t) for t in teng.generate(p[None], 8)[0]]


def test_expired_midflight_matches_jax_gateway(pairs):
    """A deadline passes mid-decode (an injected clock that jumps once the
    request has 3 tokens, so both sessions expire it at the same step):
    one terminal ``error`` event with ``expired`` / ``deadline``, the
    partial tokens a prefix of the oracle, both gateways alike."""
    jeng, teng = _engines(pairs)
    p = _prompts(teng.cfg.vocab_size, [5])[0]
    gws = []

    def clock():
        live = list(gws[-1]._tracked.values()) if gws else []
        return 20_000.0 if any(t.handle.tokens_ready >= 3 for t in live) \
            else 0.0

    def script(gw, host, port):
        gws.append(gw)
        return _view(_post(host, port, {"prompt": p.tolist(),
                                        "max_tokens": 24,
                                        "deadline_ms": 10_000}))

    want, got = _run(pairs, "dense", script, lanes=1, page_size=4, segment=1,
                     clock=clock)
    assert got == want
    status, _, (toks, terminals) = got
    assert status == 200 and len(terminals) == 1
    ev, payload = terminals[0]
    assert (ev, payload["status"], payload["reason"]) == \
        ("error", "expired", "deadline")
    assert len(toks) == 3 and payload["tokens"] == 3
    assert toks == [int(t) for t in teng.generate(p[None], 24)[0][:3]]


def test_request_id_echo_duplicate_and_reuse_match_jax_gateway(pairs):
    """A client ``request_id`` is echoed in the terminal payload (absent
    without one); a second submit of a live id is a 409 naming the
    original rid; once terminal the id is reusable (mirrors the JAX
    package's two request_id tests)."""
    jeng, teng = _engines(pairs)
    p = _prompts(teng.cfg.vocab_size, [5])[0]

    def script(gw, host, port):
        _paced(gw)
        out, res = [], {}
        t = threading.Thread(target=lambda: res.setdefault("r", _post(
            host, port, {"prompt": p.tolist(), "max_tokens": 24,
                         "request_id": "dup-1"})))
        t.start()
        _wait(lambda: "dup-1" in gw._live_ids, msg="original live")
        out.append(_view(_post(host, port, {"prompt": p.tolist(),
                                            "max_tokens": 2,
                                            "request_id": "dup-1"})))
        t.join(timeout=120)
        assert not t.is_alive()
        out.append(_view(res["r"]))
        _wait(lambda: "dup-1" not in gw._live_ids, msg="id released")
        out.append(_view(_post(host, port, {"prompt": p.tolist(),
                                            "max_tokens": 2,
                                            "request_id": "dup-1"})))
        out.append(_view(_post(host, port, {"prompt": p.tolist(),
                                            "max_tokens": 3})))
        return out

    want, got = _run(pairs, "dense", script, lanes=1, page_size=4, segment=1)
    assert got == want
    dup, original, reuse, plain = got
    assert dup[0] == 409 and dup[2]["error"] == "duplicate-request-id"
    assert dup[2]["request_id"] == "dup-1" and dup[2]["rid"] == 0
    for status, _, (toks, terminals) in (original, reuse):
        assert status == 200 and terminals[0][0] == "end"
        assert terminals[0][1]["request_id"] == "dup-1"
    assert len(original[2][0]) == 24
    assert "request_id" not in plain[2][1][0][1]


# ---------------------------------------------------------------------------
# emission order: every token before the terminal status
# ---------------------------------------------------------------------------
class _Watched(Request):
    """A request that records how many tokens it had when its status first
    became terminal, and every token appended after that."""

    @property
    def status(self):
        return self.__dict__["_status"]

    @status.setter
    def status(self, value):
        if value in TERMINAL and "_at_terminal" not in self.__dict__:
            self.__dict__["_at_terminal"] = len(self.emitted)
        self.__dict__["_status"] = value


class _Emitted(list):
    def __init__(self, req):
        super().__init__(req.emitted)
        self.req = req
        self.late = []

    def _note(self, n):
        if self.req.status in TERMINAL:
            self.late.append((self.req.status, n))

    def append(self, tok):
        self._note(1)
        super().append(tok)

    def extend(self, toks):
        toks = list(toks)
        self._note(len(toks))
        super().extend(toks)


def _watch(req):
    req.__dict__["_status"] = req.__dict__.pop("status")
    req.__class__ = _Watched
    req.emitted = _Emitted(req)
    return req


@pytest.mark.parametrize("end", ["cancel", "expiry", "failure"])
def test_terminal_status_written_after_the_last_token(pairs, end):
    """On the port's session: a request cancelled by its client's
    disconnect, expired past its deadline, or failed by an injected
    ``device_oom`` gets no token after its terminal status is written, and
    the SSE stream (when its client reads to the end) carries exactly the
    tokens the request holds."""
    _, teng = _engines(pairs)
    p = _prompts(teng.cfg.vocab_size, [5])[0]
    clk = [0.0]
    kw = dict(lanes=1, page_size=4, segment=1, clock=lambda: clk[0])
    if end == "failure":
        kw["faults"] = FaultInjector({"device_oom": [3]})
    gw = Gateway(teng, **kw)
    gw.session = _Held(gw.session)
    _paced(gw)
    srv = GatewayHTTP(gw)
    host, port = srv.start_background()
    try:
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("POST", "/v1/generate",
                     json.dumps({"prompt": p.tolist(), "max_tokens": 24,
                                 "deadline_ms": 10_000}),
                     {"Content-Type": "application/json"})
        _wait(lambda: gw._tracked, msg="request queued")
        req = _watch(next(iter(gw._tracked.values())).handle._req)
        gw.session.release()
        resp = conn.getresponse()
        assert resp.status == 200
        if end == "cancel":
            resp.fp.read(16)                  # the first event arrived
            resp.fp.close()
            _wait(lambda: req.status in TERMINAL, msg="cancelled")
        else:
            if end == "expiry":
                _wait(lambda: len(req.emitted) >= 2, msg="decoding")
                clk[0] = 20_000.0
            toks, terminals = _parse_sse(resp.read().decode())
            assert toks == list(req.emitted) and len(terminals) == 1
            assert terminals[0][1]["tokens"] == len(toks)
        conn.close()
        want = {"cancel": RequestStatus.CANCELLED,
                "expiry": RequestStatus.EXPIRED,
                "failure": RequestStatus.FAILED}[end]
        _wait(lambda: not gw._tracked, msg="harvested")
        assert req.status is want
        assert req.emitted.late == []
        assert req.__dict__["_at_terminal"] == len(req.emitted) >= 1
        if end == "failure":
            assert req.fail_reason == "oom:decode-segment"
        assert gw.session.stats()["pool"]["n_owned"] == 0
    finally:
        srv.stop()
        gw.close()
