"""Async, atomic, checksummed checkpoints in the JAX package's on-disk
format (``checkpoint/manager.py``), so each package restores the other's.

Layout per step:
    <dir>/step_000000123.tmp/        (written)
    <dir>/step_000000123/            (atomic rename on completion)
        manifest.json                ({"step", "leaves": {key: entry}})
        leaf_000000.npy ...          (row-major leaves, numbered in key order)

* Keys are tree paths joined by "/": a dict key as itself, a NamedTuple
  field as "." + its name (JAX's ``GetAttrKey``), so the optimizer state
  reads ``opt/.boolean/.accum/blocks/...`` and ``opt/.adam/.step``; ``None``
  leaves are absent.
* int8 ±1 leaves are bit-packed 8:1 with ``np.packbits`` (``packed_boolean``);
  bf16 leaves are stored as their uint16 bits (``bf16_as_u16``) under the
  dtype name "bfloat16".
* Every leaf's crc32 covers the exact ``.npy`` bytes written; restore
  verifies it before deserialising and raises ``CheckpointCorruption``.
* Device→host copies happen at ``save_pytree``; file I/O runs on a
  background thread. Keep-3 pruning follows each commit.
"""
from __future__ import annotations

import io
import json
import shutil
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

SEP = "/"


class CheckpointCorruption(RuntimeError):
    """A leaf's on-disk bytes fail their manifest checksum. Typed so a
    restore caller can tell a damaged checkpoint from a programming error;
    it is never swallowed into a partially restored tree."""

    def __init__(self, step: int, key: str, fname: str,
                 want: int, got: int):
        self.step = step
        self.key = key
        self.file = fname
        super().__init__(
            f"checkpoint step {step}: leaf {key!r} ({fname}) checksum "
            f"mismatch (manifest crc32={want:#010x}, bytes={got:#010x}) "
            "— refusing to deserialize corrupted weights")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()) -> dict:
    """{key: tensor} in JAX's flatten order (dicts by sorted key)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {SEP.join(prefix): tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, prefix + (k,)))
    return flat


def _rebuild(tree, values: dict, prefix=()):
    """``tree`` with each tensor leaf replaced by ``values[key]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), values,
                                     prefix + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, values, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return values[SEP.join(prefix)]


def _to_numpy(t: torch.Tensor):
    """-> (host array, manifest dtype name); bf16 as its uint16 bits."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _pack_bool(arr: np.ndarray):
    return np.packbits((arr.reshape(-1) > 0).astype(np.uint8))


def _unpack_bool(bits: np.ndarray, shape, size):
    vals = np.unpackbits(bits, count=size).astype(np.int8)
    return (vals * 2 - 1).reshape(shape)


def save_pytree(tree, directory, step: int,
                sync: bool = False) -> threading.Thread:
    """Write a checkpoint; returns the writer thread (joined if sync)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:09d}"
    tmp = directory / f"step_{step:09d}.tmp"

    # device->host now; file I/O in the background
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}

    def write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": {}}
        for i, (key, (arr, dtype)) in enumerate(sorted(flat.items())):
            fname = f"leaf_{i:06d}.npy"
            entry = {"file": fname, "dtype": dtype, "shape": list(arr.shape)}
            if arr.dtype == np.int8 and arr.size and \
                    set(np.unique(arr[..., :1])) <= {-1, 1}:
                save_arr = _pack_bool(arr)
                entry["packed_boolean"] = True
            else:
                save_arr = arr
                if dtype == "bfloat16":
                    entry["bf16_as_u16"] = True
            # the crc covers the EXACT bytes that land on disk
            buf = io.BytesIO()
            np.save(buf, save_arr)
            raw = buf.getvalue()
            entry["crc32"] = zlib.crc32(raw) & 0xFFFFFFFF
            (tmp / fname).write_bytes(raw)
            manifest["leaves"][key] = entry
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # commit point
        _prune(directory, keep=3)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    if sync:
        t.join()
    return t


def _prune(directory: Path, keep: int):
    steps = sorted(d for d in directory.glob("step_*") if d.is_dir()
                   and not d.name.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(d, ignore_errors=True)
    for d in directory.glob("step_*.tmp"):
        shutil.rmtree(d, ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(d.name.split("_")[1]) for d in directory.glob("step_*")
                   if d.is_dir() and not d.name.endswith(".tmp"))
    return steps[-1] if steps else None


def _from_numpy(raw: np.ndarray, entry) -> torch.Tensor:
    if entry.get("packed_boolean"):
        arr = _unpack_bool(raw, entry["shape"], int(np.prod(entry["shape"])))
    elif entry.get("bf16_as_u16"):
        return torch.from_numpy(raw.view(np.int16).reshape(entry["shape"])) \
            .view(torch.bfloat16)
    else:
        arr = raw.reshape(entry["shape"])
    return torch.from_numpy(arr)


def restore_pytree(template, directory, step: Optional[int] = None):
    """Restore into the structure of ``template``, each leaf on its template
    leaf's device. Every leaf's raw bytes are checksum-verified against the
    manifest before ``np.load`` reads them; a mismatch raises
    ``CheckpointCorruption`` naming the step, leaf and file. (The JAX
    package's ``faults=`` ckpt-corrupt drill comes with the faults slice.)
    -> (tree, step)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    src = directory / f"step_{step:09d}"
    manifest = json.loads((src / "manifest.json").read_text())

    flat_tpl = _flatten(template)
    out = {}
    for key, entry in manifest["leaves"].items():
        if key not in flat_tpl:
            continue
        raw_bytes = (src / entry["file"]).read_bytes()
        want = entry.get("crc32")
        if want is not None:
            got = zlib.crc32(raw_bytes) & 0xFFFFFFFF
            if got != int(want):
                raise CheckpointCorruption(step, key, entry["file"],
                                           int(want), got)
        raw = np.load(io.BytesIO(raw_bytes))
        out[key] = _from_numpy(raw, entry).to(flat_tpl[key].device)

    missing = set(flat_tpl) - set(out)
    if missing:
        raise KeyError(f"checkpoint {src} missing leaves: {sorted(missing)[:5]}")
    return _rebuild(template, out), step


class CheckpointManager:
    """Keep-N async checkpointing with restore-latest; one in-flight write."""

    def __init__(self, directory, every: int = 100):
        self.directory = Path(directory)
        self.every = every
        self._inflight: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.every:
            return False
        self.wait()
        self._inflight = save_pytree(tree, self.directory, step)
        return True

    def save_now(self, step: int, tree):
        self.wait()
        save_pytree(tree, self.directory, step, sync=True)

    def wait(self):
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    def restore_latest(self, template):
        return restore_pytree(template, self.directory)

    def latest_step(self):
        return latest_step(self.directory)
