"""BENCHMARK.json and every file it names, against the contract's names,
units and links; and a test-only cell added as files and entries alone."""
from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.tests._bench_common import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def doc():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command(doc):
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert doc["paths"] == ["benchmark"] and 1 <= doc["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in doc["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(doc):
    names = [c["name"] for c in doc["configs"]] + [w["name"] for w in doc["workloads"]]
    names += [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    names += [w["traffic"] for w in doc["workloads"]]
    names += [k for c in doc["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in doc[kind]}) == len(doc[kind])
    metrics = doc["end_to_end"] + doc["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for text in ([c["why"] for c in doc["configs"]] + [w["why"] for w in doc["workloads"]]
                 + [m["layer"] for m in doc["per_layer"]] + [c["source"] for c in doc["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_cells_name_existing_files(doc):
    configs = {c["name"]: c for c in doc["configs"]}
    for c in doc["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in doc["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert os.path.isfile(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    used = {w["config"] for w in doc["workloads"]}
    assert used == set(configs)
    assert len({(w["config"], w["traffic"]) for w in doc["workloads"]}) == len(doc["workloads"])
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py"))


def test_every_per_layer_metric_moves_a_metric_its_cells_report(doc):
    cells = [w["name"] for w in doc["workloads"]]
    e2e = {m["name"]: m for m in doc["end_to_end"]}

    def reports(cell, name):
        return cell in e2e[name].get("workloads", cells)

    for m in doc["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(cell, m["moves"]), (m["name"], cell)
    for cell in cells:
        assert reports(cell, "setup_s")
        assert sum(reports(cell, n) for n in e2e if n != "setup_s") >= 1
        assert any(cell in m.get("workloads", cells) for m in doc["per_layer"])
    layers = {}
    for m in doc["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_a_test_only_cell_is_added_by_files_and_entries(tmp_path):
    """A configuration, a traffic mix and a per-layer metric of the tests'
    own, found by name with no harness file edited; the cell runs on the
    CPU and its metric is read."""
    import torch

    from benchmark import run
    from benchmark.tests._bench_common import tiny_spec

    spec = tiny_spec(str(tmp_path))
    with open(os.path.join(spec.bench_dir, "metrics", "requests_seen.serve.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx['requests'])\n")
    spec.doc["per_layer"].append({"name": "requests_seen.serve", "unit": "1", "better": "higher",
                                  "source": "host_clock", "layer": "device",
                                  "moves": "frames_per_s", "workloads": ["tiny-track"]})
    res = run.run_cell(spec, "tiny-track", 2**31 + 5, 1.0, True, torch.device("cpu"))
    assert res["metrics"]["requests_seen.serve"]["value"] >= 1
    assert res["correct"] and res["attempted"] >= 1
    assert list(res)[-1] == "limits"
