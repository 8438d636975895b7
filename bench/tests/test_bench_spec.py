"""BENCHMARK.json against the contract's shape, and every cell,
configuration, traffic kind, system and metric found by name."""
import importlib
import json
import re

import pytest

from bench.harness import BENCH, ROOT, benchmark, load_json, load_metric

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = benchmark()


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in SPEC["end_to_end"])


def test_names_units_and_bounds():
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({c["name"] for c in SPEC[group]}) == len(SPEC[group])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    c = load_json(BENCH / "cells" / f"{cell}.json")
    assert c["config"] == w["config"] and c["traffic"] == w["traffic"]
    assert w["chips"] == 1 and len(w["why"]) <= 200
    importlib.import_module(f"bench.traffic.{c['traffic']}")
    importlib.import_module(f"bench.systems.{c['system']}")
    cfg = next(x for x in SPEC["configs"] if x["name"] == w["config"])
    assert cfg["file"] == f"bench/configs/{w['config']}.json"
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    e2e = [m for m in SPEC["end_to_end"] if cell in m.get("workloads",
                                                          [cell])]
    assert {"setup_s"} < {m["name"] for m in e2e}
    assert any(cell in m.get("workloads", [cell]) for m in SPEC["per_layer"])


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_found_by_name(config):
    c = next(x for x in SPEC["configs"] if x["name"] == config)
    f = load_json(ROOT / c["file"])
    assert f["name"] == config and f["source"] == c["source"]
    assert f["reduced"] == c["reduced"]
    for k in c["reduced"]:
        assert f["published"][k] != f["model"][{
            "num_hidden_layers": "n_layers"}[k]]
    assert any(w["config"] == config for w in SPEC["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    SPEC["end_to_end"] + SPEC["per_layer"]])
def test_metric_found_by_name(metric):
    mod = load_metric(metric)
    assert callable(mod.read) and mod.__doc__


def test_per_layer_workloads_report_their_end_to_end_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
