"""The port stands alone: importing it loads neither JAX nor the JAX package,
no source file of it imports them, and its entry points refuse to fall back
to the CPU when a card was asked for and none is there."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm_init
from repro_torch.serve import ServeEngine

PKG = Path(repro_torch.__file__).resolve().parent
SUBMODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py") + sorted(
    "repro_torch." + ".".join(p.parent.relative_to(PKG).parts)
    for p in PKG.rglob("__init__.py") if p.parent != PKG)


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        "import repro_torch\n"
        f"for m in {SUBMODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', 'jaxlib')"
        " or m.startswith(('jax.', 'repro.', 'jaxlib.')))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(SUBMODULES) >= 20
    # the training, prefix-cache, vision, gateway, energy, serve-mesh and
    # training-mesh slices' modules are among those imported
    assert {"repro_torch.core.optimizer", "repro_torch.kernels.boolean_bwd",
            "repro_torch.train.step", "repro_torch.train.loop",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
            "repro_torch.launch.train", "repro_torch.kernels.flash_attention",
            "repro_torch.serve.prefix_cache",
            "repro_torch.kernels.boolean_matmul", "repro_torch.core.boolean_conv",
            "repro_torch.configs.bold_vgg_small", "repro_torch.vision",
            "repro_torch.vision.vgg", "repro_torch.vision.edsr",
            "repro_torch.examples.finetune_boolean_cnn",
            "repro_torch.launch.serve", "repro_torch.serve.sampling",
            "repro_torch.configs.qwen2_5_14b", "repro_torch.configs.qwen1_5_32b",
            "repro_torch.configs.qwen1_5_110b",
            "repro_torch.configs.bold_bert", "repro_torch.serve.faults",
            "repro_torch.serve.swap", "repro_torch.serve.chaos",
            "repro_torch.gateway", "repro_torch.gateway.server",
            "repro_torch.gateway.metrics", "repro_torch.energy",
            "repro_torch.energy.model", "repro_torch.distributed",
            "repro_torch.distributed.context",
            "repro_torch.distributed.serve_worker",
            "repro_torch.launch.mesh", "repro_torch.launch.shardings",
            "repro_torch.distributed.compression",
            "repro_torch.distributed.placement",
            "repro_torch.launch.shapes",
            "repro_torch.examples.quickstart", "repro_torch.examples.train_lm",
            "repro_torch.examples.serve_lm"} <= set(SUBMODULES)


IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|repro)(?!\w)", re.M)
DYNAMIC = re.compile(r"""import_module\(\s*f?["'](jax|repro)[."']""")


def test_no_source_file_imports_jax_or_the_reference():
    sources = list(PKG.rglob("*.py"))
    assert sources
    for path in sources:
        text = path.read_text()
        assert not IMPORT.search(text), f"{path} imports {IMPORT.search(text)[1]}"
        assert not DYNAMIC.search(text), path


def test_engine_default_device_refuses_a_host_without_cuda(monkeypatch):
    """``device`` defaults to "cuda"; with no card the engine raises rather
    than quietly serving on the CPU. ``device="cpu"`` is the explicit ask."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("gemma2-2b").scaled(dtype=torch.float32)
    params = lm_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, params, max_len=32, packed=True)
    eng = ServeEngine(cfg, params, max_len=32, packed=True, device="cpu")
    out = eng.generate_batch([np.arange(5, dtype=np.int32)], 3)
    assert out[0].shape == (3,) and (out[0] < cfg.vocab_size).all()


def test_train_launcher_default_device_refuses_a_host_without_cuda(monkeypatch):
    """``--device`` defaults to "cuda"; with no card the launcher raises
    before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_launcher.main(["--arch", "gemma2-2b", "--smoke", "--steps", "1"])


def test_serve_launcher_default_device_refuses_a_host_without_cuda(monkeypatch):
    """The serve launcher's ``--device`` defaults to "cuda" too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_launcher.main(["--arch", "qwen2.5-14b", "--smoke"])


@pytest.mark.parametrize("name", ["quickstart", "train_lm", "serve_lm"])
def test_examples_default_device_refuses_a_host_without_cuda(monkeypatch,
                                                             name):
    """The three LM-and-MLP examples' ``--device`` defaults to "cuda" too,
    and raises before drawing anything."""
    import importlib

    example = importlib.import_module(f"repro_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        example.main([])
