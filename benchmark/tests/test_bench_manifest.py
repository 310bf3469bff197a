"""BENCHMARK.json against the benchmark's contract: names, units, keys,
the cells' metrics and the files each name leads to."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    M = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in M["end_to_end"]}


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in M["workloads"]])


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(json.dumps(M)) <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32
    for p in M["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.endswith("_torch")


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entry_keys_and_names(section, keys):
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    for e in M[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and section in ("configs", "workloads", "per_layer"):
                v = e[k]
                assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metrics_units_bounds_and_sources():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_moves_is_reported_by_every_cell_of_the_metric():
    for m in M["per_layer"]:
        e2e = E2E[m["moves"]]
        for cell in _cells_of(m):
            assert cell in _cells_of(e2e), (m["name"], cell)


def test_each_layer_is_named_alike():
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_cells_report_enough():
    for w in M["workloads"]:
        e2e = [m for m in M["end_to_end"] if w["name"] in _cells_of(m)]
        pl = [m for m in M["per_layer"] if w["name"] in _cells_of(m)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert pl, w["name"]


def test_four_chip_cells_at_most_a_quarter():
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in M["workloads"])
    assert len(four) <= max(1, len(M["workloads"]) // 4)


def test_configuration_and_traffic_pairs_once():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}


def test_every_name_leads_to_its_files():
    for c in M["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("benchmark/")
    for w in M["workloads"]:
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            t = json.load(f)
        assert os.path.exists(os.path.join(BENCH, "modes", t["mode"] + ".py"))
        with open(os.path.join(BENCH, "limits", w["name"] + ".json")) as f:
            assert json.load(f)
    for m in M["end_to_end"] + M["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py")), m["name"]


def test_files_named_from_name_characters():
    for dirpath, _, files in os.walk(BENCH):
        for fn in files:
            rel = os.path.relpath(os.path.join(dirpath, fn), ROOT)
            if "__pycache__" in rel:
                continue
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
