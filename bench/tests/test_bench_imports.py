"""What a run loads: never JAX or the JAX package (``repro``), compared
by whole top-level module names; the references load nothing of the
port either."""
import subprocess
import sys

from bench.harness import ROOT, forbidden_modules

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {src!r})
import importlib, pathlib
for m in {mods!r}:
    importlib.import_module(m)
{extra}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""


def _tops(mods, extra=""):
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), mods=mods,
                        extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, check=True)
    return set(out.stdout.split())


def test_harness_and_port_load_no_jax():
    tops = _tops(["bench.harness", "bench.systems.serve",
                  "bench.systems.train", "bench.traffic.closed_loop",
                  "bench.traffic.train_steps", "bench.trace",
                  "repro_torch.serve", "repro_torch.train"],
                 extra="from bench.harness import benchmark, load_metric\n"
                       "[load_metric(m['name']) for m in "
                       "benchmark()['end_to_end'] + benchmark()['per_layer']]")
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_references_load_nothing_of_the_port():
    tops = _tops(["bench.reference.lm", "bench.reference.train",
                  "bench.reference.numerics", "bench.weights"])
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxy", sys)
    assert forbidden_modules() == [] or set(forbidden_modules()) <= {
        "jax", "jaxlib", "flax", "repro"}
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert "repro" in forbidden_modules()


def test_no_result_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    runs nothing: the run exits non-zero and prints no result line."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "qwen14b-decode-long", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
