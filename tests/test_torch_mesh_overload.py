"""Overload, shard loss and the launcher on the port's serve mesh, in gloo
worlds of 2 (and 4) processes: the JAX package's
``tests/test_mesh_serve.py`` overload and shard-loss cases, the mesh's
refusal of the contiguous ``generate``, and ``launch.serve --shards N``.

The scheduler runs once, on rank 0, so its decisions cannot fork across
shards: a page budget the pool can never meet sheds at submit, a tenant
at its page quota sheds, a deadline is swept unmeetable at the next step,
and the admitted request streams the unsharded engine's tokens. An armed
``shard_loss`` fails every active lane with ``shard-lost:shard0``, the pool
audits clean, ``stats()["mesh"]`` turns unhealthy and stays so, and the
next request still streams the unsharded engine's tokens. Smoke gemma2-2b
in fp32 with its own ``lm_init`` weights (``n_kv_heads`` 4 at world 4).
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from test_torch_mesh_serve import run_world

ROOT = Path(__file__).resolve().parents[1]

_SETUP = """
import torch
from repro_torch.configs import get_smoke
from repro_torch.models import lm_init
from repro_torch.serve import (FaultInjector, RequestStatus, SamplingParams,
                               ServeEngine, ShedError)

cfg = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
if WORLD > cfg.kv_heads_padded():
    cfg = cfg.scaled(n_kv_heads=WORLD)
params = lm_init(cfg, torch.Generator().manual_seed(0))
eng = ServeEngine(cfg, params, max_len=32, device="cpu", mesh=MESH)
ref = ServeEngine(cfg, params, max_len=32, device="cpu")
prompt = np.arange(5, dtype=np.int32) % cfg.vocab_size
"""

_OVERLOAD = _SETUP + """
def body(eng):
    clock = [0.0]
    with eng.session(lanes=2, page_size=4, n_pages=5, segment=2,
                     tenant_page_quota=3, clock=lambda: clock[0]) as sess:
        assert sess.placement() == {0: 0, 1: 0}
        # a page budget the 4-page pool can never meet: shed at submit
        try:
            sess.submit(np.zeros(20, np.int32), SamplingParams(max_tokens=8))
            raise AssertionError("page-budget shed did not fire")
        except ShedError as e:
            assert e.reason == "page-budget", e.reason
        # tenant a at its quota of 3 pages: one more page sheds
        h_a = sess.submit(prompt, SamplingParams(max_tokens=8, tenant="a"))
        try:
            sess.submit(np.arange(2, dtype=np.int32),
                        SamplingParams(max_tokens=2, tenant="a"))
            raise AssertionError("tenant quota did not fire")
        except ShedError as e:
            assert e.reason == "tenant-quota", e.reason
        # a deadline swept unmeetable at the next step: shed, no compute
        clock[0] = 100.0
        h_d = sess.submit(prompt, SamplingParams(max_tokens=4,
                                                 deadline_ms=5.0))
        clock[0] = 200.0
        sess.run_until_idle()
        assert h_d.status is RequestStatus.SHED and h_d.error == "deadline"
        assert h_a.status is RequestStatus.DONE, h_a.status
        got = h_a.tokens_so_far()
        assert sess.stats()["mesh"] == {"shards": WORLD,
                                        "shard_loss_events": 0, "lost": [],
                                        "healthy": True}
    assert got == ref.generate(prompt[None], 8)[0].tolist(), got
    for call in (eng.generate, eng.generate_eager):
        try:
            call(prompt[None], 4)
            raise AssertionError(f"{call.__name__} served on the mesh")
        except NotImplementedError as e:
            assert "session()/generate_batch()" in str(e)
    print("OVERLOAD", json.dumps(got))


served(eng, body)
"""

_SHARD_LOSS = _SETUP + """
def body(eng):
    p2 = (np.arange(8, dtype=np.int32) * 3 + 1) % cfg.vocab_size
    inj = FaultInjector({"shard_loss": [0]})
    with eng.session(lanes=2, page_size=4, segment=2, audit=True,
                     faults=inj) as sess:
        h1 = sess.submit(prompt, SamplingParams(max_tokens=6))
        h2 = sess.submit(p2, SamplingParams(max_tokens=6))
        sess.run_until_idle()
        assert inj.fired == [("shard_loss", 0)], inj.fired
        for h in (h1, h2):
            assert h.status is RequestStatus.FAILED, h.status
            assert h.error == "shard-lost:shard0", h.error
        sess.audit()
        st = sess.stats()["mesh"]
        assert st == {"shards": WORLD, "shard_loss_events": 1, "lost": [0],
                      "healthy": False}, st
        h3 = sess.submit(prompt, SamplingParams(max_tokens=6))
        sess.run_until_idle()
        assert h3.status is RequestStatus.DONE, h3.status
        got = h3.tokens_so_far()
        assert sess.stats()["mesh"]["healthy"] is False
    assert got == ref.generate(prompt[None], 6)[0].tolist(), got
    print("SHARD_LOSS", json.dumps(got))


served(eng, body)
"""


@pytest.mark.parametrize("world", [2, 4])
def test_overload_semantics_survive_sharding(world, tmp_path):
    """Typed page-budget and tenant-quota sheds at submit, the deadline
    shed by the step sweep, each decided once by rank 0's scheduler, and
    the admitted stream identical to the unsharded engine's; ``generate``
    and ``generate_eager`` refused at more than one shard."""
    out = run_world(world, _OVERLOAD, tmp_path)
    assert len(json.loads(out.split("OVERLOAD ")[1])) == 8


@pytest.mark.parametrize("world", [2, 4])
def test_shard_loss_fails_fast_and_reports_degraded_mesh(world, tmp_path):
    out = run_world(world, _SHARD_LOSS, tmp_path)
    assert len(json.loads(out.split("SHARD_LOSS ")[1])) == 6


# ---------------------------------------------------------------------------
# the launcher: --shards N starts the other ranks itself
# ---------------------------------------------------------------------------
_ARGS = ["--arch", "gemma2-2b", "--smoke", "--requests", "4", "--lanes", "2",
         "--gen", "6", "--prompt-len", "12", "--device", "cpu"]


def _launch(*extra, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *_ARGS, *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def _streams(text):
    """{request: its tokens} from ``--stream``'s "[serve] reqI +[...]"
    lines."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith("[serve] req") and " +[" in ln:
            i = int(ln.split()[1][3:])
            out.setdefault(i, []).extend(
                json.loads(ln.split(" +", 1)[1].split(" (")[0]))
    return out


def test_launcher_shards_serve_the_single_device_streams():
    """``--shards 2 --stream`` serves through two processes (this one and
    the rank it starts) and exits 0, its streams those of the single-device
    launcher; ``--continuous`` too; without --stream/--continuous the flag
    is refused, as in the JAX launcher."""
    one = _launch("--stream")
    two = _launch("--shards", "2", "--stream")
    assert one.returncode == 0 and two.returncode == 0, two.stderr[-3000:]
    assert "[serve] tensor-parallel mesh: 2 shards over cpu" in two.stdout
    assert _streams(two.stdout) == _streams(one.stdout) != {}
    cont = _launch("--shards", "2", "--continuous")
    assert cont.returncode == 0, cont.stderr[-3000:]
    first = next(ln for ln in cont.stdout.splitlines()
                 if ln.startswith("[serve] request 0:"))
    assert json.loads(first.split(":", 1)[1])[:6] == _streams(one.stdout)[0]
    bad = _launch("--shards", "2")
    assert bad.returncode != 0 and "--shards requires --stream" in bad.stderr


def test_launcher_refuses_more_shards_than_cards():
    """On CUDA a rank takes one card: more shards than visible cards exit
    non-zero with the oversubscription message, before any rank starts
    (here: no card at all)."""
    res = _launch("--shards", "2", "--stream", "--device", "cuda", timeout=60)
    assert res.returncode != 0
    assert "CUDA devices are visible" in res.stderr or \
        "torch.cuda.is_available() is False" in res.stderr, res.stderr


def _get(port, path):
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    c.request("GET", path)
    r = c.getresponse()
    return r.status, r.read().decode()


def test_launcher_http_over_a_mesh_serves_mesh_metrics():
    """``--shards 2 --stream --http PORT``: the gateway on rank 0 streams a
    request through the mesh, /metrics carries the mesh series (2 shards,
    healthy), and SIGTERM drains both ranks to exit 0."""
    import http.client
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *_ARGS,
         "--shards", "2", "--stream", "--http", str(port)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.monotonic()
        while True:
            assert proc.poll() is None, proc.communicate()
            try:
                if _get(port, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() - t0 < 120, "launcher never listened"
            time.sleep(0.2)
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("POST", "/v1/generate", json.dumps(
            {"prompt": [3, 1, 4, 1, 5], "max_tokens": 4}))
        r = c.getresponse()
        body = r.read().decode()
        assert r.status == 200 and body.count("event: token") == 4, body
        status, metrics = _get(port, "/metrics")
        assert status == 200
        assert "serve_mesh_shards_total 2" in metrics
        assert "serve_mesh_healthy 1" in metrics
        assert "serve_mesh_shard_loss_events_total 0" in metrics
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert out.splitlines()[-1] == "[serve] gateway drained; exiting"
