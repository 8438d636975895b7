"""Build the port's CUDA kernels and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``<repo>/build/lib<name>-<hash>.so`` at first
use; the hash is of the source text and of every header it includes with
``#include "..."`` (``csrc/hopper_gemm.cuh``), so an edited source or
header rebuilds and an unchanged one loads the library already built.
``build_all`` starts one ``nvcc`` per source, all at once. Nothing here
runs at import time: the CPU tests import every module of the port on a
host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("packed_xnor_gemv", "paged_flash_decode", "boolean_weight_bwd",
           "flash_attention", "paged_prefix_attention", "boolean_matmul",
           "packed_xnor_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _sources(path: Path, seen: List[Path]) -> List[Path]:
    """``path`` and, depth first, every local header it includes."""
    if path not in seen:
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            _sources(path.parent / inc.decode(), seen)
    return seen


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1()
    for path in _sources(src, []):
        h.update(path.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every stale source in parallel; returns {name: seconds}
    (0.0 for a library already built). Raises with nvcc's output on a
    failed build. ``nvcc``'s register/spill report for each source is kept
    beside its library as ``<lib>.log``."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        secs = {}
        for name in SOURCES:
            src, lib = _target(name)
            if lib.exists():
                secs[name] = 0.0
                continue
            tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, lib, time.perf_counter())
        failed = []
        for name, (proc, tmp, lib, t0) in procs.items():
            out, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            lib.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name} (rc {proc.returncode}) ---\n{out}")
                continue
            os.replace(tmp, lib)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    _, path = _target(name)
    if not path.exists():
        build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = _bind(name, ctypes.CDLL(str(path)))
        return _libs[name]


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill lines) for ``name``."""
    _, path = _target(name)
    log = path.with_suffix(".log")
    return log.read_text() if log.exists() else ""


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "packed_xnor_gemv": {
        "xnor_gemv": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "xnor_gemv_error_string": [_I],
    },
    "paged_flash_decode": {
        "paged_flash_decode": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                               _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                               _P],
        "paged_flash_decode_error_string": [_I],
    },
    "boolean_weight_bwd": {
        "boolean_weight_bwd": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _F, _P],
        "boolean_weight_bwd_tc": [_P, _P, _P, _I, _I, _I, _P],
        "boolean_weight_bwd_error_string": [_I],
    },
    "flash_attention": {
        "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                                _F, _P],
        "flash_attention_error_string": [_I],
    },
    "paged_prefix_attention": {
        "paged_prefix_attention": [_P] * 9 + [_I] * 14 + [_F, _F, _P],
        "paged_prefix_attention_error_string": [_I],
    },
    "boolean_matmul": {
        "boolean_matmul": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
        "boolean_matmul_transpose": [_P, _P, _I, _I, _I, _P],
        "boolean_matmul_error_string": [_I],
    },
    "packed_xnor_matmul": {
        "packed_xnor_matmul": [_P, _P, _P, _I, _I, _I, _I, _P],
        "packed_xnor_matmul_error_string": [_I],
    },
}


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_char_p if fn.endswith("error_string") else _I
    return lib


def check(name: str, fn: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = getattr(library(name), f"{fn}_error_string")(rc)
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                           f"({msg.decode() if msg else '?'})")
