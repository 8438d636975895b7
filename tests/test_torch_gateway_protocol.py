"""The port's HTTP/SSE gateway against the JAX package's: the protocol.

Each case mirrors a test of the JAX package's ``tests/test_gateway.py`` and
runs one script over live HTTP against the JAX gateway and then the port's
(gemma2-2b at smoke width, fp32, bridged weights, the JAX session on its
gather path), holding the records equal: status codes, the
``Content-Type``, ``Retry-After`` and ``X-Request-Id`` headers, JSON bodies,
SSE event sequences, and ``/metrics`` series by name with their counts
(latency values excepted). Covered: typed rejections (queue-full,
tenant-quota, page-budget, the live depth-scaled ``Retry-After``),
malformed bodies, ``/metrics`` after prefix-cached traffic and under the
tenant label bound, ``/healthz`` and drain, disconnect-cancels,
keep-alive and HTTP/1.0, the watchdog on a stalled and on a crashed step,
``parse_generate_body``, and ``python -m repro_torch.launch.serve --http``
beside the JAX launcher (``/healthz``, one stream, SIGTERM, exit 0, the
same ``[serve]`` lines).
"""
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.gateway import Gateway as JGateway
from repro.gateway import GatewayHTTP as JGatewayHTTP
from repro.gateway import GatewayMetrics as JMetrics
from repro.gateway import parse_generate_body as j_parse
from repro.models import attention as JA
from repro.models import lm_init as jax_lm_init
from repro.serve import SamplingParams as JParams
from repro.serve import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.gateway import (Gateway, GatewayHTTP, GatewayMetrics,
                                 parse_generate_body)
from repro_torch.serve import SamplingParams, ServeEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def engines():
    cfg_j = jax_smoke("gemma2-2b").scaled(dtype=jnp.float32)
    cfg_t = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params = jax.tree.map(np.asarray,
                          jax_lm_init(jax.random.PRNGKey(0), cfg_j)[0])
    return (JEngine(cfg_j, jax.tree.map(jnp.asarray, params), max_len=32),
            ServeEngine(cfg_t, bridge.params_from_numpy(params, "cpu"),
                        max_len=32, device="cpu"))


def _run(engines, script, max_tenants=None, **kw):
    """``script(gw, host, port, P)`` against the JAX gateway, then the
    port's (``P``: that package's SamplingParams; with ``max_tenants``, each
    package's metrics registry under that label bound); returns both
    records."""
    records = []
    for (G, H, M, P), eng, jax_side in (
            ((JGateway, JGatewayHTTP, JMetrics, JParams), engines[0], True),
            ((Gateway, GatewayHTTP, GatewayMetrics, SamplingParams),
             engines[1], False)):
        extra = {} if max_tenants is None else {
            "metrics": M(max_tenants=max_tenants)}
        with JA.paged_kernel_override(False if jax_side else None):
            gw = G(eng, **kw, **extra)
            srv = H(gw)
            host, port = srv.start_background()
            try:
                records.append(script(gw, host, port, P))
            finally:
                srv.stop()
                gw.close()
    return records


def _post(host, port, body, timeout=120):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request("POST", "/v1/generate",
                 body if isinstance(body, str) else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = (resp.status, dict(resp.getheaders()), resp.read().decode())
    conn.close()
    return out


def _get(host, port, path, timeout=30):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = (resp.status, dict(resp.getheaders()), resp.read().decode())
    conn.close()
    return out


def _parse_sse(text):
    toks, terminals = [], []
    for block in text.strip().split("\n\n"):
        fields = dict(line.split(": ", 1) for line in block.splitlines())
        if fields.get("event") == "token":
            toks.append(int(fields["data"]))
        elif "event" in fields:
            terminals.append((fields["event"], json.loads(fields["data"])))
    return toks, terminals


def _view(result):
    status, headers, body = result
    keep = {k: headers[k] for k in ("Content-Type", "Retry-After",
                                    "X-Request-Id") if k in headers}
    ctype = headers.get("Content-Type", "")
    if ctype == "text/event-stream":
        return status, keep, _parse_sse(body)
    if ctype.startswith("text/plain"):
        return status, keep, _series(body)
    return status, keep, json.loads(body)


_LATENCY = re.compile(r"^gateway_(ttft|ttft_by_tenant|inter_token)_seconds"
                      r"_(bucket|sum)\b")


def _series(text):
    """/metrics as {series: value} with every latency-valued series
    (histogram buckets and sums) kept by name only; the comment lines."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            out[line] = None
        elif line:
            name, value = line.rsplit(" ", 1)
            out[name] = None if _LATENCY.match(name) else float(value)
    return out


def _values(text):
    return {n: float(v) for n, v in (line.rsplit(" ", 1)
                                     for line in text.splitlines()
                                     if line and not line.startswith("#"))}


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


def _prompt(cfg, n):
    return RNG.integers(0, cfg.vocab_size, (n,)).astype(np.int32)


# ---------------------------------------------------------------------------
# typed rejections -> stable HTTP codes
# ---------------------------------------------------------------------------
def test_queue_full_is_429_with_retry_after(engines):
    want, got = _run(engines, lambda gw, h, p, P: _view(_post(
        h, p, {"prompt": [1, 2, 3], "max_tokens": 4})),
        lanes=1, page_size=4, max_pending=0)
    assert got == want
    status, headers, obj = got
    assert status == 429 and headers["Retry-After"] == "1"
    assert obj["error"] == "queue-full" and obj["rid"] == 0


def test_tenant_quota_is_429_with_retry_after(engines):
    p = _prompt(engines[1].cfg, 4)

    def script(gw, host, port, P):
        _paced(gw)
        gw.submit(p, P(max_tokens=12, tenant="A"))
        return [_view(_post(host, port, {"prompt": p.tolist(),
                                         "max_tokens": 12, "tenant": "A"})),
                _view(_post(host, port, {"prompt": p.tolist(),
                                         "max_tokens": 4, "tenant": "B"}))]

    want, got = _run(engines, script, lanes=2, page_size=4,
                     tenant_lane_quota=1)
    assert got == want
    (s_a, h_a, b_a), (s_b, _, _) = got
    assert (s_a, h_a["Retry-After"], b_a["error"]) == (429, "1",
                                                        "tenant-quota")
    assert s_b == 200


def test_page_budget_is_503_without_retry_after(engines):
    want, got = _run(engines, lambda gw, h, p, P: _view(_post(
        h, p, {"prompt": [1, 2, 3, 4], "max_tokens": 12})),
        lanes=1, page_size=4, n_pages=3)
    assert got == want
    status, headers, obj = got
    assert status == 503 and "Retry-After" not in headers
    assert obj["error"] == "page-budget"


def test_retry_after_reflects_live_queue_depth(engines):
    """One busy lane and four pending: a queue-full shed advertises
    ``Retry-After: 5`` on both gateways."""
    p = _prompt(engines[1].cfg, 4)

    def script(gw, host, port, P):
        _paced(gw)
        handles = [gw.submit(p, P(max_tokens=24))]
        _wait(lambda: gw.session.stats()["active"] == 1, msg="lane busy")
        handles += [gw.submit(p, P(max_tokens=24)) for _ in range(4)]
        out = _view(_post(host, port, {"prompt": p.tolist(),
                                       "max_tokens": 2}))
        for h in handles:
            gw.cancel(h)
        return out

    want, got = _run(engines, script, lanes=1, page_size=4, segment=1,
                     max_pending=4)
    assert got == want
    status, headers, obj = got
    assert (status, headers["Retry-After"], obj["error"]) == (429, "5",
                                                              "queue-full")


def test_malformed_bodies_are_400(engines):
    def script(gw, host, port, P):
        out = [_view(_post(host, port, body)) for body in (
            {"prompt": "text"}, {"prompt": []}, {"prompt": [1, -2]},
            {"prompt": [1], "bogus": 1}, {"prompt": [1], "max_tokens": "many"},
            {"prompt": [1, 2, 3], "max_tokens": 1000}, "not json{")]
        conn = http.client.HTTPConnection(host, port, timeout=10)
        conn.request("GET", "/v1/generate")
        r = conn.getresponse()
        out.append((r.status, json.loads(r.read())))
        conn.close()
        out.append(_view(_get(host, port, "/nope")))
        return out

    want, got = _run(engines, script, lanes=1, page_size=4)
    assert got == want
    assert [r[0] for r in got] == [400] * 7 + [405, 404]
    assert all(r[2]["error"] == "bad-request" for r in got[:7])


# ---------------------------------------------------------------------------
# /metrics
# ---------------------------------------------------------------------------
def test_metrics_exposition(engines):
    """Prefix-cached traffic, two runs of one prompt: the same series by
    name and count on both gateways, and the JAX package's checks."""
    p = _prompt(engines[1].cfg, 6)

    def script(gw, host, port, P):
        codes = [_post(host, port, {"prompt": p.tolist(),
                                    "max_tokens": 4})[0] for _ in range(2)]
        _wait(lambda: gw.session.idle and not gw._tracked, msg="idle")
        text = _get(host, port, "/metrics")[2]
        return codes, _series(text), _values(text)

    (jc, jseries, _), (codes, series, m) = _run(
        engines, script, lanes=2, page_size=4, prefix_cache=True)
    assert codes == jc == [200, 200]
    assert series == jseries
    assert m["serve_sched_admitted_total"] == 2
    assert m["serve_active_requests"] == 0 and m["serve_lanes_total"] == 2
    assert (m["serve_pool_pages_total"] == m["serve_pool_pages_free"]
            + m["serve_pool_pages_owned"] + 1)
    assert m["serve_prefix_lookups_total"] == 2
    assert m["serve_prefix_exact_hits_total"] >= 1
    assert m["gateway_ttft_seconds_count"] == 2
    buckets = sorted((float(n.split('le="')[1].rstrip('"}')
                            .replace("+Inf", "inf")), v)
                     for n, v in m.items()
                     if n.startswith("gateway_ttft_seconds_bucket"))
    assert [v for _, v in buckets] == sorted(v for _, v in buckets)
    assert buckets[-1][1] == m["gateway_ttft_seconds_count"]
    assert m["gateway_inter_token_seconds_count"] == 6
    assert m["gateway_tokens_streamed_total"] == 8
    assert m['gateway_http_requests_total{code="200",path="/v1/generate"}'] == 2
    assert m['gateway_streams_total{outcome="done"}'] == 2
    assert not any(n.startswith("serve_work") for n in m)


def test_metrics_tenant_labels_bounded(engines):
    """Three tenants through a ``max_tenants=2`` registry: two labels of
    their own, the third under ``other``, the aggregate counting all."""
    prompts = [_prompt(engines[1].cfg, 4) for _ in range(3)]

    def script(gw, host, port, P):
        codes = [_post(host, port, {"prompt": q.tolist(), "max_tokens": 2,
                                    "tenant": t})[0]
                 for q, t in zip(prompts, ("acme", "globex", "initech"))]
        text = _get(host, port, "/metrics")[2]
        return codes, _series(text), text

    (jc, jseries, _), (codes, series, text) = _run(
        engines, script, max_tenants=2, lanes=2, page_size=4)
    assert codes == jc == [200] * 3 and series == jseries
    for t in ("acme", "globex", "other"):
        assert f'gateway_ttft_by_tenant_seconds_count{{tenant="{t}"}} 1' in text
    assert "initech" not in text
    assert "gateway_ttft_seconds_count 3" in text


# ---------------------------------------------------------------------------
# lifecycle: healthz, drain, disconnect, keep-alive, HTTP/1.0
# ---------------------------------------------------------------------------
def test_healthz_and_graceful_drain(engines):
    p = _prompt(engines[1].cfg, 4)

    def script(gw, host, port, P):
        _paced(gw)
        out = [_view(_get(host, port, "/healthz"))]
        res = {}
        t = threading.Thread(target=lambda: res.setdefault("r", _post(
            host, port, {"prompt": p.tolist(), "max_tokens": 16})))
        t.start()
        _wait(lambda: gw._tracked, msg="request in flight")
        gw.begin_drain()
        out.append(_view(_get(host, port, "/healthz")))
        out.append(_view(_post(host, port, {"prompt": [1, 2],
                                            "max_tokens": 2})))
        t.join(timeout=120)
        assert not t.is_alive()
        out.append(_view(res["r"]))
        _wait(lambda: gw.drained, msg="gateway drained")
        return out

    want, got = _run(engines, script, lanes=1, page_size=4)
    assert got == want
    ok, draining, refused, stream = got
    assert ok == (200, {"Content-Type": "application/json"}, {"status": "ok"})
    assert draining[0] == 503 and draining[2] == {"status": "draining"}
    assert refused[0] == 503 and refused[2] == {"error": "draining"}
    assert refused[1]["Retry-After"] == "1"
    toks, terminals = stream[2]
    assert stream[0] == 200 and terminals[0][0] == "end"
    assert toks == [int(t) for t in engines[1].generate(p[None], 16)[0]]


def test_client_disconnect_cancels_request(engines):
    """Dropping the SSE connection mid-stream cancels the request: its
    lane and pages free, the stream outcome is ``cancelled``, and both
    sessions' books read alike afterwards."""
    p = _prompt(engines[1].cfg, 4)

    def script(gw, host, port, P):
        _paced(gw)
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("POST", "/v1/generate",
                     json.dumps({"prompt": p.tolist(), "max_tokens": 24}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        resp.fp.read(16)
        resp.fp.close()
        _wait(lambda: not gw._tracked and gw.session.idle,
              msg="request cancelled after disconnect")
        st = gw.session.stats()
        m = _values(_get(host, port, "/metrics")[2])
        return ({k: st[k] for k in ("pending", "active", "pool")},
                st["sched"]["admitted"],
                m['gateway_streams_total{outcome="cancelled"}'])

    want, got = _run(engines, script, lanes=1, page_size=4, segment=1)
    assert got == want
    books, admitted, cancelled = got
    assert books["active"] == books["pending"] == 0
    assert books["pool"]["n_owned"] == 0
    assert admitted == 1 and cancelled == 1


def _raw_get(sock, path, extra=""):
    sock.sendall(f"GET {path} HTTP/1.1\r\nHost: t\r\n{extra}\r\n".encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("server closed before response head")
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    headers = {k.strip().lower(): v.strip()
               for k, v in (ln.split(":", 1) for ln in lines[1:])}
    while len(rest) < int(headers["content-length"]):
        rest += sock.recv(4096)
    return int(lines[0].split()[1]), headers, rest.decode()


def test_keepalive_and_http10(engines):
    """Scrapes reuse one HTTP/1.1 connection (``Connection: keep-alive``
    on every response, the socket alive across requests); ``Connection:
    close`` is honoured with close + EOF; an HTTP/1.0 request gets one
    response and a closed connection. Both gateways answer byte for byte
    alike but for the latency values of /metrics."""
    def script(gw, host, port, P):
        out = []
        with socket.create_connection((host, port), timeout=30) as sock:
            for path in ("/healthz", "/metrics", "/healthz", "/metrics"):
                status, headers, body = _raw_get(sock, path)
                out.append((status, headers, _series(body)
                            if path == "/metrics" else body))
            out.append(_raw_get(sock, "/healthz", "Connection: close\r\n"))
            sock.settimeout(10)
            out.append(sock.recv(1))
        with socket.create_connection((host, port), timeout=30) as sock:
            sock.sendall(b"GET /healthz HTTP/1.0\r\nHost: t\r\n\r\n")
            buf = b""
            while True:
                chunk = sock.recv(4096)
                if not chunk:
                    break
                buf += chunk
            out.append(buf)
        return out

    want, got = _run(engines, script, lanes=2, page_size=4)
    assert got == want
    assert all(r[0] == 200 and r[1]["connection"] == "keep-alive"
               for r in got[:4])
    assert got[4][1]["connection"] == "close" and got[5] == b""
    assert b" 200 " in got[6].split(b"\r\n", 1)[0]
    assert b"connection: close" in got[6].lower()


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------
def test_watchdog_trips_on_stalled_step_driver(engines):
    """A wedged step driver: /healthz 503 degraded, the live stream ends
    with one typed ``watchdog`` error echoing its request_id, new work 503
    without Retry-After, cancels refused, the trip counted."""
    p = _prompt(engines[1].cfg, 4)

    def script(gw, host, port, P):
        _paced(gw)
        res = {}
        t = threading.Thread(target=lambda: res.setdefault("r", _post(
            host, port, {"prompt": p.tolist(), "max_tokens": 24,
                         "request_id": "wd-1"}, timeout=60)))
        t.start()
        _wait(lambda: "wd-1" in gw._live_ids, msg="request live")
        gw.session.step = lambda: time.sleep(0.5)
        _wait(lambda: gw.watchdog_tripped, msg="watchdog trip")
        assert "stalled" in gw.watchdog_reason
        status, headers, body = _get(host, port, "/healthz")
        health = json.loads(body)
        t.join(timeout=60)
        assert not t.is_alive(), "SSE stream hung after watchdog trip"
        status_s, _, text = res["r"]
        toks, terminals = _parse_sse(text)
        (ev, payload), = terminals
        assert payload.pop("detail") == gw.watchdog_reason
        refused = _view(_post(host, port, {"prompt": p.tolist(),
                                           "max_tokens": 2}))
        m = _values(_get(host, port, "/metrics")[2])
        return (status, health.pop("detail") is not None, health, status_s,
                ev, {k: v for k, v in payload.items() if k != "tokens"},
                refused, gw.cancel(None), m["gateway_watchdog_trips_total"])

    want, got = _run(engines, script, lanes=1, page_size=4, segment=1,
                     watchdog_timeout=0.25)
    assert got == want
    assert got == (503, True, {"status": "degraded", "reason": "watchdog"},
                   200, "error", {"status": "failed", "reason": "watchdog",
                                  "request_id": "wd-1"},
                   (503, {"Content-Type": "application/json"},
                    {"error": "degraded"}), False, 1.0)


def test_watchdog_trips_immediately_on_step_crash(engines):
    p = _prompt(engines[1].cfg, 4)

    def script(gw, host, port, P):
        def boom():
            raise RuntimeError("induced step crash")

        gw.session.step = boom
        gw.submit(p, P(max_tokens=2))
        _wait(lambda: gw.watchdog_tripped, msg="trip on crash")
        assert isinstance(gw._step_error, RuntimeError)
        return gw.watchdog_reason, _view(_get(host, port, "/healthz"))

    want, got = _run(engines, script, lanes=1, page_size=4,
                     watchdog_timeout=30.0)
    assert got == want
    reason, (status, _, body) = got
    assert "induced step crash" in reason
    assert status == 503 and body["reason"] == "watchdog"


# ---------------------------------------------------------------------------
# public names, body validation
# ---------------------------------------------------------------------------
def test_public_names_are_the_references():
    import repro.gateway as J
    import repro_torch.gateway as T

    assert set(J.__all__) | {"DuplicateRequestId"} == set(T.__all__)
    assert all(hasattr(T, n) for n in T.__all__)
    assert T.TTFT_BUCKETS == J.TTFT_BUCKETS
    assert T.ITL_BUCKETS == J.ITL_BUCKETS
    assert issubclass(T.DuplicateRequestId, ValueError)


def test_parse_generate_body_matches_jax():
    good = {"prompt": [1, 2, 3], "max_tokens": 7, "temperature": 0.5,
            "seed": 9, "stop_token": 2, "deadline_ms": 100, "priority": 3,
            "tenant": "acme", "stream": True, "request_id": "cli-1"}
    for body in (good, {"prompt": [4]}):
        prompt, params, rid = parse_generate_body(body)
        jprompt, jparams, jrid = j_parse(body)
        assert prompt.dtype == jprompt.dtype == np.int32
        np.testing.assert_array_equal(prompt, jprompt)
        assert vars(params) == vars(jparams) and rid == jrid
    assert parse_generate_body(good)[1] == SamplingParams(
        max_tokens=7, temperature=0.5, seed=9, stop_token=2,
        deadline_ms=100.0, priority=3, tenant="acme")
    for bad in ("x", {}, {"prompt": [0.5]}, {"prompt": [1], "nope": 2},
                {"prompt": [1], "request_id": 7},
                {"prompt": [1], "request_id": ""},
                {"prompt": [1], "request_id": "x" * 129},
                {"prompt": [1], "max_tokens": "many"}):
        with pytest.raises(ValueError) as got:
            parse_generate_body(bad)
        with pytest.raises(ValueError) as want:
            j_parse(bad)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the launcher's --http
# ---------------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_once(module, extra):
    """Start ``python -m module --arch gemma2-2b --smoke --http PORT``, wait
    for /healthz 200, stream one request, SIGTERM it; returns (exit code,
    stdout, the stream's tokens and terminal events)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--arch", "gemma2-2b", "--smoke",
         "--http", str(port), *extra], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.monotonic()
        while True:
            assert proc.poll() is None, proc.communicate()
            try:
                if _get("127.0.0.1", port, "/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() - t0 < 180, "launcher never listened"
            time.sleep(0.2)
        status, _, text = _post("127.0.0.1", port,
                                {"prompt": [3, 1, 4, 1, 5], "max_tokens": 4})
        assert status == 200
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out.replace(str(port), "PORT"), _parse_sse(text)


def test_launcher_http_drains_on_sigterm():
    """``python -m repro_torch.launch.serve --arch gemma2-2b --smoke
    --device cpu --http PORT`` answers /healthz, streams a request, drains
    on SIGTERM and exits 0, printing the JAX launcher's ``[serve]`` lines
    (the launchers draw different weights, so tokens are not compared)."""
    results = {}

    def run(key, module, extra):
        results[key] = _serve_once(module, extra)

    threads = [threading.Thread(target=run, args=args) for args in (
        ("jax", "repro.launch.serve", []),
        ("torch", "repro_torch.launch.serve", ["--device", "cpu"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    (rc, out, (toks, terminals)), (jrc, jout, _) = (results["torch"],
                                                    results["jax"])
    assert rc == jrc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve]")]
    assert lines == [ln for ln in jout.splitlines()
                     if ln.startswith("[serve]")]
    assert lines == [
        "[serve] gateway listening on http://127.0.0.1:PORT (4 lanes, "
        "page_size=16, segment=2) — SIGTERM/Ctrl-C drains gracefully",
        "[serve] gateway drained; exiting"]
    assert len(toks) == 4 and terminals[0][0] == "end"
