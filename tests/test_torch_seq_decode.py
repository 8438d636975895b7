"""The seq-sharded contiguous decode against the JAX package's unsharded
``lm_decode_step`` (its ``tests/test_distributed.py::
test_shardmap_flash_decode_matches_local``, whose sharded run fails in
this container, so the reference is its unsharded decode).

A gloo world of 8 is a (data 2, model 4) training mesh; under
``use_sharding_constraints`` with ``batch_axes=("data",)`` and
``cache_seq_axes=("model",)`` each rank holds its slices of the params
(the JAX package's placement, ``launch.shardings.train_param_specs``:
FSDP over "data", the heads, d_ff and vocab over "model", k/v replicated
over the 4 ranks; ``lm_decode_step(shardings=)``), its batch row of the
cache and a slab of a quarter of its 64 rows, gathers the token's q heads
over "model", writes the new token's row only if ``pos`` lands in its
slab, reads its slab from the slab's global offset and combines the
softmax statistics across the four slabs (one MAX and two SUM
all-reduces a layer). gemma2-2b's smoke config (fp32, local layers of
window 32 across slab edges, global layers) decodes one token over a
random cache in bf16 and in int8 with per-row scales, at pos 5 (slab 0)
and 40 (slab 2, with 8-row decode chunks inside the slab). Every rank's
logits must equal the unsharded port's rows within 1e-5 (fp32 sums
reassociated across the slabs) and the JAX package's within 1e-4 (the
tolerance the port's contiguous decode is held to in
``tests/test_torch_dense_archs.py``); every rank's cache slab after the
step must equal the same rows of the unsharded port's cache bit for bit,
the newly written row within a bf16 ulp (an int8 row within one count):
the rank projects its own batch row alone, a GEMM of another shape.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import cache_init as jax_cache_init
from repro.models import lm_decode_step as jax_decode
from repro.models import lm_init as jax_lm_init
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.models import lm_decode_step

ROOT = Path(__file__).resolve().parents[1]
B, S, DP, SP = 2, 64, 2, 4
PORT_ATOL, REF_ATOL = 1e-5, 1e-4
# the written row: within a bf16 ulp (2^-7) of the unsharded port's, an
# int8 row within one count
ROW_RTOL = 2.0 ** -7
CASES = {
    # name: (cache, pos, decode_chunk)
    "bf16-pos5": ("bf16", 5, 2048),
    "bf16-pos40-chunk8": ("bf16", 40, 8),
    "int8-pos40": ("int8", 40, 2048),
}

_PREAMBLE = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=sys.argv[3], rank=RANK,
                        world_size=WORLD)
"""


def run_world(n: int, script: str, tmp_path, *args: str,
              timeout: float = 150) -> str:
    """Run ``script`` (after ``_PREAMBLE``) as a gloo world of ``n``
    processes over a ``file://`` store under ``tmp_path``, ``args`` from
    ``sys.argv[4]`` on; every rank must exit 0. Returns rank 0's stdout."""
    src = tmp_path / f"world{n}.py"
    # every rank leaves the world together, its meshes closed first: a
    # group object still held once the world is destroyed is torn down at
    # the interpreter's exit, where gloo's threads can abort the process
    src.write_text(_PREAMBLE + textwrap.dedent(script)
                   + "\ndist.barrier()\ndist.destroy_process_group()\n")
    store = tmp_path / f"store{n}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(src), str(r), str(n), f"file://{store}", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {n}:\n{err[-4000:]}"
    return outs[0][0]


# every rank: its batch row and cache slab of each case, one decode step;
# rank 0 gathers every rank's logits and slabs into one .npz a case
_DECODE = """
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.distributed.placement import named, place
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.shardings import kv_replicated, train_param_specs
from repro_torch.models import lm_decode_step

mesh = make_local_mesh(4, "cpu")
d, m = mesh.coords["data"], mesh.coords["model"]
for case in json.loads(sys.argv[4]):
    for k in mesh.counts:
        mesh.counts[k] = 0
    cfg = get_smoke("gemma2-2b").scaled(
        dtype=torch.float32, use_sharding_constraints=True,
        batch_axes=("data",), cache_seq_axes=("model",),
        kv_cache_quant=case["cache"] == "int8",
        decode_chunk=case["chunk"])
    inp = np.load(case["inp"])
    params = {}
    for key in inp.files:
        if key.startswith("p/"):
            *head, leaf = key[2:].split("/")
            node = params
            for k in head:
                node = node.setdefault(k, {})
            node[leaf] = inp[key]
    params = bridge.params_from_numpy(params, "cpu")
    sh = named(mesh, train_param_specs(params, replicate_kv=kv_replicated(
        cfg, mesh.shape["model"])))
    params = place(params, sh)
    b = inp["tok"].shape[0] // 2
    blocks = {}
    for key in inp.files:
        if key.startswith("c/"):
            _, bi, name = key.split("/")
            t = torch.from_numpy(inp[key])
            if name in ("k", "v") and case["cache"] == "bf16":
                t = t.to(torch.bfloat16)
            rows = t.shape[2] // 4
            blocks.setdefault(bi, {})[name] = \\
                t[:, d * b:(d + 1) * b, m * rows:(m + 1) * rows].clone()
    tok = torch.from_numpy(inp["tok"][d * b:(d + 1) * b])
    logits, cache = lm_decode_step(cfg, params, {"blocks": blocks,
                                                 "pos": case["pos"]}, tok,
                                   shardings=sh)
    every = [None] * WORLD
    dist.all_gather_object(every, {
        "d": d, "m": m, "logits": logits.numpy(),
        "cache": {f"{bi}/{n}": t.float().numpy()
                  for bi, leaves in cache["blocks"].items()
                  for n, t in leaves.items()}})
    if RANK == 0:
        out = {}
        for r in every:
            out[f"logits/{r['d']}/{r['m']}"] = r["logits"]
            for k, v in r["cache"].items():
                out[f"cache/{r['d']}/{r['m']}/{k}"] = v
        np.savez(case["out"], **out)
        print(json.dumps({"name": case["name"],
                          "seq_combines": mesh.counts["seq_combines"]}))
mesh.close()
"""


def _jax_cfg(cache, chunk, **kw):
    return jax_smoke("gemma2-2b").scaled(
        dtype=jnp.float32, kv_cache_quant=cache == "int8",
        decode_chunk=chunk, **kw)


def _random_cache(cfg_j, cache, rng):
    """The JAX package's cache tree filled with random rows (fp32 values
    rounded to bf16, or int8 rows with positive per-row scales)."""
    c, _ = jax_cache_init(cfg_j, B, S)
    out = {}
    for bi, leaves in c["blocks"].items():
        out[bi] = {}
        for name, x in leaves.items():
            if name in ("k", "v") and cache == "int8":
                out[bi][name] = rng.integers(-127, 128, x.shape, np.int8)
            elif name in ("k", "v"):
                v = 0.5 * rng.standard_normal(x.shape).astype(np.float32)
                out[bi][name] = torch.from_numpy(v).to(torch.bfloat16) \
                    .float().numpy()
            else:                              # int8 rows' scales
                out[bi][name] = (0.004 + 0.004 * rng.random(x.shape)) \
                    .astype(np.float32)
    return out


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_decode")
    rng = np.random.default_rng(0)
    params_j, _ = jax_lm_init(jax.random.PRNGKey(0), _jax_cfg("bf16", 2048))
    params_np = jax.tree.map(np.asarray, params_j)
    tok = rng.integers(0, 128, (B, 1)).astype(np.int32)
    cases, inputs = [], {}
    for name, (cache, pos, chunk) in CASES.items():
        blocks = _random_cache(_jax_cfg(cache, chunk), cache, rng)
        flat = {"tok": tok}
        flat.update({f"c/{bi}/{n}": v for bi, leaves in blocks.items()
                     for n, v in leaves.items()})

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + k + "/")
                else:
                    flat[prefix + k] = v
        walk(params_np, "p/")
        np.savez(tmp / f"{name}-in.npz", **flat)
        inputs[name] = blocks
        cases.append(dict(name=name, cache=cache, pos=pos, chunk=chunk,
                          inp=str(tmp / f"{name}-in.npz"),
                          out=str(tmp / f"{name}-out.npz")))
    out = run_world(DP * SP, _DECODE, tmp, json.dumps(cases), timeout=200)
    counts = {json.loads(ln)["name"]: json.loads(ln)["seq_combines"]
              for ln in out.strip().splitlines()}
    got = {c["name"]: dict(np.load(c["out"])) for c in cases}
    return params_np, tok, inputs, got, counts


@pytest.mark.parametrize("name", list(CASES))
def test_seq_sharded_decode_matches_the_unsharded_decodes(decoded, name):
    params_np, tok, inputs, got, counts = decoded
    cache, pos, chunk = CASES[name]
    blocks = inputs[name]
    # the JAX package's unsharded decode
    cfg_j = _jax_cfg(cache, chunk)
    cj = {"blocks": {bi: {n: jnp.asarray(v).astype(jnp.bfloat16)
                          if cache == "bf16" and n in ("k", "v")
                          else jnp.asarray(v) for n, v in leaves.items()}
                     for bi, leaves in blocks.items()},
          "pos": jnp.asarray(pos, jnp.int32)}
    ref, _ = jax.jit(lambda p, c, t: jax_decode(cfg_j, p, c, t))(
        jax.tree.map(jnp.asarray, params_np), cj, jnp.asarray(tok))
    ref = np.asarray(ref, np.float32)
    # the port's unsharded decode
    cfg_t = get_smoke("gemma2-2b").scaled(
        dtype=torch.float32, kv_cache_quant=cache == "int8",
        decode_chunk=chunk)
    ct = {"blocks": {bi: {n: torch.from_numpy(v.copy()).to(torch.bfloat16)
                          if cache == "bf16" and n in ("k", "v")
                          else torch.from_numpy(v.copy())
                          for n, v in leaves.items()}
                     for bi, leaves in blocks.items()}, "pos": pos}
    params_t = bridge.params_from_numpy(params_np, "cpu")
    port, ct = lm_decode_step(cfg_t, params_t, ct, torch.from_numpy(tok))
    port = port.numpy()
    rows = S // SP
    for d in range(DP):
        for m in range(SP):
            lg = got[name][f"logits/{d}/{m}"]
            np.testing.assert_allclose(lg, port[d:d + 1], rtol=0,
                                       atol=PORT_ATOL)
            np.testing.assert_allclose(lg, ref[d:d + 1], rtol=0,
                                       atol=REF_ATOL)
            for bi, leaves in ct["blocks"].items():
                for n, t in leaves.items():
                    want = t[:, d:d + 1, m * rows:(m + 1) * rows].float()
                    have = torch.from_numpy(
                        got[name][f"cache/{d}/{m}/{bi}/{n}"])
                    new = pos - m * rows
                    keep = [i for i in range(rows) if i != new]
                    assert torch.equal(have[:, :, keep], want[:, :, keep]), \
                        (name, d, m, bi, n)
                    if 0 <= new < rows:
                        # the new row: this rank projected its batch row
                        # alone, a GEMM of another shape than the
                        # unsharded batch's
                        torch.testing.assert_close(
                            have[:, :, new], want[:, :, new], rtol=ROW_RTOL,
                            atol=1.0 if n in ("k", "v") and cache == "int8"
                            else 0.0)
    # one MAX and two SUM all-reduces for each of the 4 attention layers
    assert counts[name] == 3 * 4
