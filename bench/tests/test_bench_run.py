"""A run of each cell at a CPU test size, through the harness without
its look for a card: the result line's schema, and ``correct`` on the
port as it is."""
import json

import pytest
import torch

from bench.harness import benchmark, local_run
from bench.tests.small import cell

torch.set_num_threads(2)
CELLS = [w["name"] for w in benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    c, cfg = cell(name)
    run, out = local_run(name, c, cfg, seed=2**31 + 101, seconds=1.5)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    e2e = {m["name"] for m in benchmark()["end_to_end"]
           if name in m.get("workloads", [name])}
    assert set(out["metrics"]) == e2e
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert out["device"]["count"] == 1
    json.dumps(out, allow_nan=False)


def test_serving_window_ends_on_a_decode_segment():
    """The closed loop's window spans whole rounds: its first step
    admits, its last decodes."""
    name = "qwen14b-decode-long"
    c, cfg = cell(name)
    run, out = local_run(name, c, cfg, seed=2**31 + 103, seconds=1.0)
    steps = [s for s in run.spans if s["name"] == "session.step"
             and run.in_window(s)]
    assert steps[-1]["info"]["decode_steps"] > 0
    assert steps[0]["info"]["decode_steps"] == 0
    assert out["correct"] is True, out["checks"]
