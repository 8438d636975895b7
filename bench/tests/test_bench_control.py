"""Each cell's control fails its check: the reference put in the port's
place in the next precision below the configuration's (float8 e4m3
activations and gradients with a per-tensor scale, for bfloat16) reads
past one of the cell's limits, on the same seed on which the port reads
within all of them. At a CPU test size here; ``bench/control.py`` runs
the same at the cell's own size on the card (PERF.md has the readings
the limits were set from)."""
import pytest
import torch

from bench.harness import Run, benchmark, execute
from bench.tests.small import cell

torch.set_num_threads(2)
CELLS = [w["name"] for w in benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_port_passes(name):
    c, cfg = cell(name)
    entry = next(w for w in benchmark()["workloads"] if w["name"] == name)
    run = Run(name, entry, c, cfg, 2**31 + 303, 1.5, False, "cpu")
    run.control = True
    out = execute(run)
    assert out["correct"] is True, out["checks"]
    limits = c["check"]["limits"]
    assert any(run.control_reading[k] > limits[k]
               for k in limits), run.control_reading
