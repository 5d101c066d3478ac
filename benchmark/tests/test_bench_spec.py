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


# A test-only kind of traffic: its runner counts in the window and its
# check sums again; the runner, the traffic and a metric are files of the
# tests' own, and its limit comes from its traffic file.
COUNT_RUNNER = """import time


def run(ctx):
    t0 = time.perf_counter()
    n, total = 0, 0
    while time.perf_counter() - t0 < ctx["seconds"]:
        n += 1
        total += n
    return dict(total=total, readings=dict(
        kind="count", setup_s=t0 - ctx["t_start"], window_s=time.perf_counter() - t0,
        requests=n, failed=0, new_captures=0, memory_peak_bytes=0))


def judge(ctx, got, trace):
    n = got["readings"]["requests"]
    return {"sum_gap": abs(got["total"] - n * (n + 1) // 2)}, None
"""


def _add_count_kind(spec):
    """The test-only kind `tiny_count` as files and entries: the cell
    `tiny-count` on the tiny configuration, with an end-to-end metric of
    its own."""
    os.makedirs(os.path.join(spec.bench_dir, "runners"))
    with open(os.path.join(spec.bench_dir, "runners", "tiny_count.py"), "w") as f:
        f.write(COUNT_RUNNER)
    with open(os.path.join(spec.bench_dir, "traffic", "tiny-count.json"), "w") as f:
        json.dump({"kind": "tiny_count", "limits": {"sum_gap": 0}}, f)
    with open(os.path.join(spec.bench_dir, "metrics", "counts_per_s.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['requests'] / ctx['window_s']\n")
    spec.doc["workloads"].append({"name": "tiny-count", "config": "tiny", "traffic": "tiny-count",
                                  "chips": 1, "why": "test"})
    spec.doc["end_to_end"].append({"name": "counts_per_s", "unit": "1/s", "better": "higher",
                                   "bound": 0.25, "source": "host_clock",
                                   "workloads": ["tiny-count"]})


@pytest.mark.parametrize("case", ["metric", "kind"])
def test_a_test_only_cell_is_added_by_files_and_entries(tmp_path, case):
    """A configuration, a traffic mix and a per-layer metric of the tests'
    own; or a kind of traffic of their own, its runner a file; each found
    by name with no harness file edited, the cell run on the CPU and its
    metric read."""
    import torch

    from benchmark import run
    from benchmark.tests._bench_common import tiny_spec

    spec = tiny_spec(str(tmp_path))
    if case == "kind":
        _add_count_kind(spec)
        res = run.run_cell(spec, "tiny-count", 2**31 + 5, 0.2, False, torch.device("cpu"))
        assert res["metrics"]["counts_per_s"]["value"] > 0
        assert res["limits"]["sum_gap"] == {"value": 0, "limit": 0}
        assert set(res["metrics"]) == {"counts_per_s", "peak_mem_gib", "setup_s"}
    else:
        with open(os.path.join(spec.bench_dir, "metrics", "requests_seen.serve.py"), "w") as f:
            f.write("def read(ctx):\n    return float(ctx['requests'])\n")
        spec.doc["per_layer"].append({"name": "requests_seen.serve", "unit": "1",
                                      "better": "higher", "source": "host_clock",
                                      "layer": "device", "moves": "frames_per_s",
                                      "workloads": ["tiny-track"]})
        res = run.run_cell(spec, "tiny-track", 2**31 + 5, 1.0, True, torch.device("cpu"))
        assert res["metrics"]["requests_seen.serve"]["value"] >= 1
    assert res["correct"] and res["attempted"] >= 1
    assert list(res)[-1] == "limits"


def test_an_unknown_kind_fails_before_set_up_naming_the_file(tmp_path):
    import torch

    from benchmark import run
    from benchmark.tests._bench_common import tiny_spec

    spec = tiny_spec(str(tmp_path))
    with open(os.path.join(spec.bench_dir, "traffic", "tiny-none.json"), "w") as f:
        json.dump({"kind": "no_such_kind"}, f)
    spec.doc["workloads"].append({"name": "tiny-none", "config": "tiny", "traffic": "tiny-none",
                                  "chips": 1, "why": "test"})
    with pytest.raises(FileNotFoundError, match=r"runners/no_such_kind\.py"):
        run.run_cell(spec, "tiny-none", 1, 0.1, False, torch.device("cpu"))


def test_a_traffic_file_adds_limits_and_changes_none():
    """A kind's limits: the configuration's set for it, else the set the
    traffic names under `limits_of` plus the traffic's own; a traffic file
    that names a limit the configuration's set holds is refused."""
    from benchmark.run import cell_limits

    cfg = {"limits": {"train": {"loss_gap": 0.035}, "serve": {"pose_gap_px": 0.45}}}
    assert cell_limits(cfg, {"kind": "serve"}) == {"pose_gap_px": 0.45}
    assert cell_limits(cfg, {"kind": "train_data", "limits_of": "train",
                             "limits": {"batch_image_gap": 0}}) == {
        "loss_gap": 0.035, "batch_image_gap": 0}
    assert cell_limits(cfg, {"kind": "count", "limits": {"sum_gap": 0}}) == {"sum_gap": 0}
    with pytest.raises(ValueError, match="loss_gap"):
        cell_limits(cfg, {"kind": "train_data", "limits_of": "train",
                          "limits": {"loss_gap": 1.0}})
    with pytest.raises(KeyError):
        cell_limits(cfg, {"kind": "train_data", "limits_of": "eval"})
