"""HTTP/SSE serving gateway over the hardened admission core.

The port of the JAX package's ``gateway/server.py``: the same endpoints,
status codes, headers, SSE framing and JSON bodies. A stdlib-asyncio
network front door for ``ServeSession`` — no runtime dependencies beyond
torch/numpy, because the gateway is deliberately TRANSPORT-THIN: every
scheduling, quota, deadline, and containment decision already lives in
serve/, so this layer only maps bytes to the session API and back. That
thinness is load-bearing for correctness: a greedy request's SSE token
stream is pinned identical to the in-process ``RequestHandle.tokens()``
stream and to the JAX gateway's (tests/test_torch_gateway.py), which could
not hold if the gateway did any token-level work of its own.

Endpoints
---------
``POST /v1/generate``
    JSON body ``{"prompt": [token ids], "max_tokens": n,
    "temperature": t, "seed": s, "stop_token": k, "deadline_ms": ms,
    "priority": p, "tenant": "name", "stream": true}`` →
    ``session.submit()``. The response is a Server-Sent-Events stream
    mapping 1:1 onto the request's token stream: one ``token`` event per
    emitted token (``data:`` is the bare token id), then exactly one
    terminal event — ``end`` (done/cancelled) or ``error`` (expired /
    failed / shed-after-queueing, ``data`` carrying the machine-readable
    reason string from ``Request.fail_reason``). ``"stream": false``
    waits and returns one JSON body instead (same terminal fields).

    Typed admission rejections never start a stream: the ``ShedError``
    reason maps through the ONE serve-wide table (serve/reasons.py) to a
    stable status — ``queue-full``/``tenant-quota``/``deadline`` → 429
    with ``Retry-After``, ``page-budget`` → 503 — with the reason echoed
    in a JSON body. For ``queue-full``/``host-budget`` the Retry-After
    is LIVE: derived from queue depth via ``stats()`` (capped), not a
    constant. Malformed bodies and never-fitting capacity violations
    (``ValueError`` from submit validation) are 400s.

    An optional ``"request_id"`` (client idempotency token) is echoed in
    the terminal payload; re-submitting an id while the original is
    still live returns 409 with the original's server rid instead of
    double-running the work.

``GET /metrics``
    Prometheus text (version 0.0.4): gateway HTTP/stream counters, TTFT
    and inter-token histograms observed by the step driver, plus the
    live serve-level counters scraped from ``ServeSession.stats()`` —
    scheduler lifecycle, queue/lane occupancy, pool-page occupancy,
    prefix-cache hit rates. See gateway/metrics.py for the series.

``GET /healthz``
    200 ``{"status": "ok"}`` while serving; 503 ``{"status":
    "draining"}`` once drain begins (load balancers eject the instance);
    503 ``{"status": "degraded", "reason": "watchdog"}`` after the step
    watchdog trips — a stalled/crashed ``session.step()`` loop flips
    health, refuses new submits, and terminates every live stream with a
    typed ``watchdog`` SSE error instead of leaving clients hung.

Graceful drain: SIGTERM (or ``Gateway.begin_drain()``) stops admitting —
new ``/v1/generate`` requests get 503 ``draining`` — while in-flight
lanes run to completion and their SSE streams finish normally; the
process exits only when the session is idle and every stream has closed.

Concurrency model
-----------------
A step blocks its thread: torch's eager dispatch runs on it, and the
token harvest at the end of every segment (and the first-token sample of
every admission) synchronises with the device, so the session cannot live
on the event loop: a dedicated STEP THREAD drives ``session.step()`` under
the gateway lock (submits from the event-loop thread interleave between
segments), records TTFT/inter-token observations (the step driver is the
only place first-token times are visible), and wakes the event loop via
``call_soon_threadsafe`` after every step so SSE writers flush new tokens
with segment latency, not poll latency. The session, its pool and the
engine's tensors are made on the caller's thread and used on the step
thread; CUDA's current device is per host thread, so the step thread
first makes the engine's device its own. Handle READS
(``tokens_so_far``, ``status``) are deliberately lock-free: both are
GIL-atomic snapshots, and the session appends every token before it writes
a terminal status (finish, cancel, expiry, failure, containment), so a
writer that observes a terminal status has already seen every token.
"""
from __future__ import annotations

import asyncio
import json
import signal
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve import reasons
from repro_torch.serve.scheduler import (TERMINAL, RequestStatus,
                                         SamplingParams, ShedError)

from .metrics import GatewayMetrics

#: request-body fields accepted by POST /v1/generate beyond "prompt".
_PARAM_FIELDS = ("max_tokens", "temperature", "seed", "stop_token",
                 "deadline_ms", "priority", "tenant")
_MAX_BODY = 10 * 1024 * 1024


class DuplicateRequestId(ValueError):
    """A client-supplied ``request_id`` collided with one still live.
    Carries the ORIGINAL submission's server rid so the 409 response can
    point the client at the stream it already owns — the first slice of
    idempotent retry: a client that re-POSTs after a timeout learns its
    request is running instead of double-submitting work."""

    def __init__(self, request_id: str, rid: int):
        self.request_id = request_id
        self.rid = rid
        super().__init__(
            f"request_id {request_id!r} is already live (rid {rid})")


class _Track:
    """Per-request latency accounting owned by the step thread."""

    __slots__ = ("handle", "submit_t", "seen", "last_t", "tenant")

    def __init__(self, handle, submit_t: float, tenant: str = "default"):
        self.handle = handle
        self.submit_t = submit_t
        self.seen = 0
        self.last_t = submit_t
        self.tenant = tenant


def parse_generate_body(body: dict
                        ) -> Tuple[np.ndarray, SamplingParams, Optional[str]]:
    """Validate a /v1/generate JSON body into
    (prompt, SamplingParams, request_id). Raises ``ValueError`` with a
    client-facing message on any bad field — the gateway maps that to a
    400, never a stack trace. ``request_id`` is the optional
    client-supplied idempotency token (1–128 chars): echoed in the
    terminal payload, deduplicated while live (409)."""
    if not isinstance(body, dict):
        raise ValueError("body must be a JSON object")
    prompt = body.get("prompt")
    if not isinstance(prompt, list) or not prompt \
            or not all(isinstance(t, int) and t >= 0 for t in prompt):
        raise ValueError("'prompt' must be a non-empty list of token ids")
    unknown = set(body) - set(_PARAM_FIELDS) - {"prompt", "stream",
                                                "request_id"}
    if unknown:
        raise ValueError(f"unknown fields: {sorted(unknown)}")
    request_id = body.get("request_id")
    if request_id is not None:
        if not isinstance(request_id, str) or not 1 <= len(request_id) <= 128:
            raise ValueError(
                "'request_id' must be a string of 1..128 characters")
    kw = {}
    for f in _PARAM_FIELDS:
        if body.get(f) is not None:
            kw[f] = body[f]
    try:
        params = SamplingParams(**{
            k: (str(v) if k == "tenant" else
                float(v) if k in ("temperature", "deadline_ms") else int(v))
            for k, v in kw.items()})
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad sampling params: {e}") from None
    return np.asarray(prompt, np.int32), params, request_id


class Gateway:
    """Transport-agnostic gateway core: one session, one step thread, one
    metrics registry. The HTTP layer (``GatewayHTTP``) sits on this; an
    in-process driver can call ``submit`` / ``cancel`` directly."""

    def __init__(self, engine, *, metrics: Optional[GatewayMetrics] = None,
                 watchdog_timeout: float = 300.0, **session_kwargs):
        """``watchdog_timeout`` (seconds) bounds how long one
        ``session.step()`` round may run before the watchdog declares the
        step driver stalled and trips self-healing (degraded ``/healthz``,
        typed ``watchdog`` error on every live stream). The default is
        deliberately generous: a kernel is built by ``nvcc`` at its first
        launch (kernels/build.py), which inside a first step takes tens of
        seconds; the launcher builds them before it listens."""
        self.session = engine.session(**session_kwargs)
        dev = engine.device
        #: the CUDA device the step thread makes current (None off the card)
        self._cuda_index = None if dev.type != "cuda" else (
            torch.cuda.current_device() if dev.index is None else dev.index)
        self.metrics = metrics if metrics is not None else GatewayMetrics()
        self.lock = threading.RLock()
        self.draining = False
        self._tracked: Dict[int, _Track] = {}
        #: live client request_id → server rid (duplicate detection);
        #: released when the request leaves ``_harvest`` terminally.
        self._live_ids: Dict[str, int] = {}
        self._listeners = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.watchdog_timeout = float(watchdog_timeout)
        self.watchdog_tripped = False
        self.watchdog_reason: Optional[str] = None
        self._step_error: Optional[BaseException] = None
        self._beat = time.monotonic()
        self._stepper = threading.Thread(target=self._step_loop,
                                         name="gateway-step", daemon=True)
        self._stepper.start()
        self._watchdog = threading.Thread(target=self._watchdog_loop,
                                          name="gateway-watchdog",
                                          daemon=True)
        self._watchdog.start()

    # -- request lifecycle (called from the serving front-end) ---------------
    def _acquire(self) -> None:
        """Take the gateway lock WITHOUT deadlocking on a wedged step
        thread: if the watchdog trips while we wait, give up with the
        degraded error instead of joining the pile-up behind a stuck
        ``session.step()``."""
        while not self.lock.acquire(timeout=0.5):
            if self.watchdog_tripped:
                raise RuntimeError("degraded")

    def submit(self, prompt: np.ndarray, params: SamplingParams,
               request_id: Optional[str] = None):
        """Submit under the gateway lock; raises ``ShedError`` (typed,
        mapped to 429/503 by the front-end), ``DuplicateRequestId``
        (409), or ``ValueError`` (400). Draining and watchdog-degraded
        gateways refuse before touching the session."""
        if self.draining:
            raise RuntimeError("draining")
        if self.watchdog_tripped:
            raise RuntimeError("degraded")
        self._acquire()
        try:
            if request_id is not None and request_id in self._live_ids:
                self.metrics.observe_request_id_conflict()
                raise DuplicateRequestId(request_id,
                                         self._live_ids[request_id])
            try:
                handle = self.session.submit(prompt, params)
            except ShedError as e:
                self.metrics.observe_shed(e.reason, params.tenant)
                raise
            handle.client_request_id = request_id
            if request_id is not None:
                self._live_ids[request_id] = handle.rid
                self.metrics.observe_request_id()
            self._tracked[handle.rid] = _Track(handle, time.monotonic(),
                                               params.tenant)
        finally:
            self.lock.release()
        self._wake.set()
        return handle

    def retry_after(self, reason: str) -> Optional[int]:
        """Live ``Retry-After`` hint for a shed: depth-scaled from a
        ``stats()`` snapshot for ``queue-full``/``host-budget`` (how many
        admission rounds until the retry can land), the static table
        value otherwise. Never raises — a stats hiccup falls back to the
        table floor."""
        try:
            return reasons.retry_after_seconds(reason, self.session.stats())
        except Exception:                             # noqa: BLE001
            return reasons.http_for_reason(reason)[1]

    def cancel(self, handle) -> bool:
        if self.watchdog_tripped:
            return False
        self._acquire()
        try:
            ok = handle.cancel()
        finally:
            self.lock.release()
        self._wake.set()
        return ok

    def add_listener(self, cb) -> None:
        """``cb()`` runs on the STEP thread after every scheduling round
        (and once per idle wait) — front-ends bridge it onto their own
        loop (``call_soon_threadsafe``) to wake SSE writers."""
        self._listeners.append(cb)

    def begin_drain(self) -> None:
        """Stop admitting; in-flight lanes finish normally. Idempotent."""
        self.draining = True
        self._wake.set()

    @property
    def drained(self) -> bool:
        return self.draining and self.session.idle and not self._tracked

    def close(self) -> None:
        """Stop the step + watchdog threads and release the session's
        pool. In-flight requests are cancelled (``session.close``
        contract). A wedged step thread (the watchdog-trip case) cannot
        be joined — the session close is skipped rather than deadlocking
        shutdown on a lock the stuck thread still holds."""
        self._stop.set()
        self._wake.set()
        self._stepper.join(timeout=10.0)
        if self._watchdog is not None:
            self._watchdog.join(timeout=10.0)
        if self._stepper.is_alive():
            return
        with self.lock:
            self.session.close()

    # -- step driver + watchdog ----------------------------------------------
    def _step_loop(self) -> None:
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while not self._stop.is_set():
                self._beat = time.monotonic()
                with self.lock:
                    idle = self.session.idle
                    if not idle:
                        self.session.step()
                    self._harvest()
                self._beat = time.monotonic()
                for cb in self._listeners:
                    cb()
                if idle:
                    self._wake.wait(0.05)
                    self._wake.clear()
        except BaseException as e:                    # noqa: BLE001
            # a crashed step driver is a dead gateway wearing a 200:
            # record and trip NOW rather than waiting out the heartbeat
            self._step_error = e
            self._trip(f"step driver crashed: {type(e).__name__}: {e}")

    def _watchdog_loop(self) -> None:
        poll = min(max(self.watchdog_timeout / 4.0, 0.01), 1.0)
        while not self._stop.wait(poll):
            if self.watchdog_tripped:
                return
            if not self._stepper.is_alive():
                self._trip("step driver thread died")
                return
            stalled = time.monotonic() - self._beat
            if stalled > self.watchdog_timeout:
                self._trip(f"step driver stalled {stalled:.1f}s "
                           f"(timeout {self.watchdog_timeout:.1f}s)")
                return

    def _trip(self, detail: str) -> None:
        """Enter degraded mode, once: flip the health flag, bump the
        metric, and wake every front-end listener so live SSE writers
        observe the trip and terminate their streams with the typed
        ``watchdog`` error instead of hanging until client timeout."""
        if self.watchdog_tripped:
            return
        self.watchdog_tripped = True
        self.watchdog_reason = detail
        self.metrics.observe_watchdog_trip()
        for cb in self._listeners:
            try:
                cb()
            except Exception:                         # noqa: BLE001
                pass

    def _harvest(self) -> None:
        """Fold this round's progress into the latency histograms: first
        visible token → TTFT (emission-at-admission makes this prefill
        latency + queueing delay); later rounds → one inter-token
        observation per new token, the round gap split evenly across the
        round's batch (tokens inside one fused segment arrive together —
        per-token gaps within a segment are not observable, by design)."""
        now = time.monotonic()
        done = []
        for rid, t in self._tracked.items():
            n = t.handle.tokens_ready
            if n > t.seen:
                if t.seen == 0:
                    self.metrics.observe_first_token(now - t.submit_t,
                                                     t.tenant)
                    if n > 1:
                        self.metrics.observe_inter_token(0.0, n - 1)
                else:
                    self.metrics.observe_inter_token(
                        (now - t.last_t) / (n - t.seen), n - t.seen)
                t.seen, t.last_t = n, now
            if t.handle.status in TERMINAL:
                self.metrics.observe_stream_end(t.handle.status.value)
                done.append(rid)
        for rid in done:
            t = self._tracked.pop(rid)
            # duplicate detection covers LIVE requests only: once
            # terminal, the same request_id is submittable again (the
            # handle keeps its echo copy — SSE payloads stay correct)
            cid = getattr(t.handle, "client_request_id", None)
            if cid is not None and self._live_ids.get(cid) == rid:
                del self._live_ids[cid]


# --------------------------------------------------------------------------
# the asyncio HTTP/SSE front-end
# --------------------------------------------------------------------------
_REASONS_4XX = {"bad-request"}


def _http_head(code: int, ctype: str, extra: Tuple[Tuple[str, str], ...] = (),
               clen: Optional[int] = None, keep: bool = False) -> bytes:
    phrase = {200: "OK", 400: "Bad Request", 404: "Not Found",
              405: "Method Not Allowed", 409: "Conflict",
              413: "Payload Too Large", 429: "Too Many Requests",
              500: "Internal Server Error",
              503: "Service Unavailable"}.get(code, "OK")
    lines = [f"HTTP/1.1 {code} {phrase}", f"Content-Type: {ctype}",
             f"Connection: {'keep-alive' if keep else 'close'}"]
    if clen is not None:
        lines.append(f"Content-Length: {clen}")
    lines += [f"{k}: {v}" for k, v in extra]
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def _json_response(code: int, obj: dict,
                   extra: Tuple[Tuple[str, str], ...] = (),
                   keep: bool = False) -> bytes:
    body = (json.dumps(obj) + "\n").encode()
    return _http_head(code, "application/json", extra, len(body),
                      keep=keep) + body


def _sse_event(event: str, data) -> bytes:
    return f"event: {event}\ndata: {data}\n\n".encode()


class GatewayHTTP:
    """Bind a ``Gateway`` to a TCP port. ``serve_forever()`` blocks with
    SIGTERM/SIGINT wired to graceful drain (the launcher path);
    ``start_background()`` runs the loop on a daemon thread and returns
    the bound (host, port) (tests, the traffic-replay harness)."""

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0):
        self.gateway = gateway
        self.host = host
        self.port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._tick: Optional[asyncio.Event] = None
        self._stopped: Optional[asyncio.Event] = None
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()

    # -- lifecycles ----------------------------------------------------------
    async def _start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._tick = asyncio.Event()
        self._stopped = asyncio.Event()
        self.gateway.add_listener(self._fire_tick)
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._ready.set()

    def _fire_tick(self) -> None:
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(self._tick.set)
            except RuntimeError:        # loop shut down mid-call
                pass

    async def _next_tick(self, timeout: float = 0.05) -> None:
        try:
            await asyncio.wait_for(self._tick.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        self._tick.clear()

    async def _run(self, install_signals: bool) -> None:
        await self._start()
        if install_signals:
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    loop.add_signal_handler(sig, self.request_drain)
                except NotImplementedError:     # non-unix
                    pass
        await self._stopped.wait()
        self._server.close()
        await self._server.wait_closed()

    def request_drain(self) -> None:
        """Begin graceful drain and schedule shutdown once drained."""
        self.gateway.begin_drain()
        if self._loop is not None:
            asyncio.run_coroutine_threadsafe(self._drain_watch(), self._loop)

    async def _drain_watch(self) -> None:
        while not self.gateway.drained:
            await self._next_tick(0.1)
        self._stopped.set()

    def serve_forever(self) -> None:
        asyncio.run(self._run(install_signals=True))

    def start_background(self) -> Tuple[str, int]:
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._run(install_signals=False)),
            name="gateway-http", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=30.0):
            raise RuntimeError("gateway HTTP server failed to start")
        return self.host, self.port

    def stop(self) -> None:
        """Hard stop (tests): no drain — close the listener and the loop."""
        if self._loop is not None and not self._loop.is_closed():
            try:
                self._loop.call_soon_threadsafe(self._stopped.set)
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    # -- request handling ----------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        """One TCP connection, possibly many requests: HTTP/1.1 default
        keep-alive so /metrics and /healthz scrapers reuse connections.
        ``Connection: close`` (or HTTP/1.0) is honored; SSE responses
        always close — their framing is read-until-close."""
        try:
            while await self._handle_one(reader, writer):
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, asyncio.TimeoutError,
                asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _handle_one(self, reader, writer) -> bool:
        """Serve one request; True iff the connection stays open."""
        req_line = await asyncio.wait_for(reader.readline(), 30.0)
        if not req_line:
            return False
        try:
            method, path, version = req_line.decode("latin1").split(" ", 2)
        except ValueError:
            writer.write(_json_response(400, {"error": "bad-request"}))
            return False
        headers = {}
        while True:
            line = await asyncio.wait_for(reader.readline(), 30.0)
            if line in (b"\r\n", b"\n", b""):
                break
            if b":" in line:
                k, v = line.split(b":", 1)
                headers[k.decode("latin1").strip().lower()] = \
                    v.decode("latin1").strip()
        keep = version.strip().upper() == "HTTP/1.1" \
            and headers.get("connection", "").lower() != "close"
        path = path.split("?", 1)[0]
        code, keep = await self._route(method, path, headers, reader,
                                       writer, keep)
        self.gateway.metrics.observe_http(path, code)
        return keep

    async def _route(self, method, path, headers, reader, writer,
                     keep: bool) -> Tuple[int, bool]:
        if path == "/healthz" and method == "GET":
            if self.gateway.watchdog_tripped:
                writer.write(_json_response(
                    503, {"status": "degraded", "reason": "watchdog",
                          "detail": self.gateway.watchdog_reason},
                    keep=keep))
                return 503, keep
            if self.gateway.draining:
                writer.write(_json_response(503, {"status": "draining"},
                                            keep=keep))
                return 503, keep
            writer.write(_json_response(200, {"status": "ok"}, keep=keep))
            return 200, keep
        if path == "/metrics" and method == "GET":
            text = self.gateway.metrics.render(self.gateway.session.stats())
            body = text.encode()
            writer.write(_http_head(
                200, "text/plain; version=0.0.4; charset=utf-8",
                clen=len(body), keep=keep) + body)
            return 200, keep
        if path == "/v1/generate":
            if method != "POST":
                writer.write(_json_response(405, {"error": "use POST"},
                                            keep=keep))
                return 405, keep
            return await self._generate(headers, reader, writer, keep)
        writer.write(_json_response(404, {"error": f"no route {path}"},
                                    keep=keep))
        return 404, keep

    async def _generate(self, headers, reader, writer,
                        keep: bool) -> Tuple[int, bool]:
        try:
            clen = int(headers.get("content-length", "0"))
        except ValueError:
            clen = -1
        if clen <= 0 or clen > _MAX_BODY:
            code = 413 if clen > _MAX_BODY else 400
            # an unread body would desynchronize the next request's parse
            writer.write(_json_response(
                code, {"error": "body required (Content-Length)"}))
            return code, False
        raw = await asyncio.wait_for(reader.readexactly(clen), 60.0)
        try:
            body = json.loads(raw)
            prompt, params, request_id = parse_generate_body(body)
        except (json.JSONDecodeError, ValueError) as e:
            writer.write(_json_response(400, {"error": "bad-request",
                                              "detail": str(e)}, keep=keep))
            return 400, keep
        # -- admission: typed rejections map through serve/reasons.py -------
        try:
            handle = self.gateway.submit(prompt, params,
                                         request_id=request_id)
        except DuplicateRequestId as e:
            # before the ValueError arm: DuplicateRequestId IS a
            # ValueError, but it is the client's own live request, not a
            # malformed body — 409 pointing at the original stream
            writer.write(_json_response(
                409, {"error": "duplicate-request-id",
                      "request_id": e.request_id, "rid": e.rid,
                      "detail": str(e)}, keep=keep))
            return 409, keep
        except ShedError as e:
            code, _ = reasons.http_for_reason(e.reason)
            retry = self.gateway.retry_after(e.reason)
            extra = (("Retry-After", str(retry)),) if retry is not None else ()
            writer.write(_json_response(
                code, {"error": e.reason, "rid": e.rid, "detail": str(e)},
                extra, keep=keep))
            return code, keep
        except RuntimeError as e:       # draining / watchdog-degraded
            degraded = str(e) == "degraded"
            writer.write(_json_response(
                503, {"error": "degraded" if degraded else "draining"},
                () if degraded else (("Retry-After", "1"),),
                keep=keep))
            return 503, keep
        except ValueError as e:         # capacity/validation: client error
            writer.write(_json_response(400, {"error": "bad-request",
                                              "detail": str(e)}, keep=keep))
            return 400, keep
        if body.get("stream") is False:
            return await self._respond_json(handle, writer, keep), keep
        # SSE framing is read-until-close: the stream always ends the conn
        return await self._respond_sse(handle, writer), False

    @staticmethod
    def _terminal_payload(handle, sent: int) -> Tuple[str, dict]:
        """The preemption counters ride along so stream-identity consumers
        (the traffic-replay oracle gate) can tell bit-faithful streams
        from recompute-resumed ones without server-side state: swap-
        resumed streams (``preempted_swap``) ARE bit-faithful — only
        ``preempted_recompute`` > 0 voids stream identity."""
        st = handle.status
        base = {"status": st.value, "tokens": sent,
                "preempted": handle.preemptions,
                "preempted_swap": handle.preempt_swap,
                "preempted_recompute": handle.preempt_recompute}
        cid = getattr(handle, "client_request_id", None)
        if cid is not None:
            base["request_id"] = cid
        if st in (RequestStatus.DONE, RequestStatus.CANCELLED):
            return "end", base
        return "error", dict(base, reason=handle.error)

    @staticmethod
    def _watchdog_payload(handle, sent: int, gateway: Gateway
                          ) -> Tuple[str, dict]:
        """Terminal event for a stream orphaned by a step-driver trip:
        the request never reached a terminal status (its driver is gone),
        so the stream ends with the typed ``watchdog`` reason — partial
        tokens already sent stay valid, the client knows to retry against
        a healthy instance."""
        base = {"status": "failed", "tokens": sent,
                "reason": reasons.WATCHDOG,
                "detail": gateway.watchdog_reason}
        cid = getattr(handle, "client_request_id", None)
        if cid is not None:
            base["request_id"] = cid
        return "error", base

    async def _respond_sse(self, handle, writer) -> int:
        """One SSE event per token, 1:1 with ``RequestHandle.tokens()``,
        then exactly one terminal event. Client disconnect cancels the
        request — its lane and pages free immediately."""
        writer.write(_http_head(200, "text/event-stream",
                                (("Cache-Control", "no-cache"),
                                 ("X-Request-Id", str(handle.rid)))))
        sent = 0
        try:
            while True:
                st = handle.status          # status BEFORE tokens: a
                toks = handle.tokens_so_far()   # terminal status implies
                for t in toks[sent:]:           # the token list is final
                    writer.write(_sse_event("token", int(t)))
                    sent += 1
                if st in TERMINAL:
                    ev, payload = self._terminal_payload(handle, sent)
                    writer.write(_sse_event(ev, json.dumps(payload)))
                    await writer.drain()
                    return 200
                if self.gateway.watchdog_tripped:
                    # tripped AFTER the terminal check: a request that
                    # finished before the trip still ends normally above
                    ev, payload = self._watchdog_payload(
                        handle, sent, self.gateway)
                    writer.write(_sse_event(ev, json.dumps(payload)))
                    await writer.drain()
                    return 200
                await writer.drain()
                await self._next_tick()
        except (ConnectionResetError, BrokenPipeError, OSError):
            self.gateway.cancel(handle)
            raise

    async def _respond_json(self, handle, writer, keep: bool = False) -> int:
        """Non-streaming mode: wait for the terminal status, answer once."""
        try:
            while handle.status not in TERMINAL:
                if self.gateway.watchdog_tripped:
                    toks = [int(t) for t in handle.tokens_so_far()]
                    ev, payload = self._watchdog_payload(
                        handle, len(toks), self.gateway)
                    payload["tokens"] = toks
                    payload["event"] = ev
                    writer.write(_json_response(200, payload, keep=keep))
                    return 200
                await self._next_tick()
        except (ConnectionResetError, BrokenPipeError, OSError):
            self.gateway.cancel(handle)
            raise
        toks = [int(t) for t in handle.tokens_so_far()]
        ev, payload = self._terminal_payload(handle, len(toks))
        payload["tokens"] = toks
        payload["event"] = ev
        writer.write(_json_response(200, payload, keep=keep))
        return 200


def run_gateway(engine, host: str = "127.0.0.1", port: int = 8080,
                metrics_tenants: Optional[int] = None,
                **session_kwargs) -> None:
    """Launcher entry: boot a gateway over ``engine`` and serve until
    SIGTERM/SIGINT, then drain gracefully (stop admitting, finish
    in-flight lanes, close every stream) before exiting."""
    metrics = (GatewayMetrics(max_tenants=metrics_tenants)
               if metrics_tenants is not None else None)
    gw = Gateway(engine, metrics=metrics, **session_kwargs)
    http = GatewayHTTP(gw, host=host, port=port)
    try:
        http.serve_forever()
    finally:
        gw.close()
