"""The `flow` kind (RAFT through `FlowEngine`), its check and faults, its
stamped stretch, and the `serve_multiclass` kind, on the CPU at small
sizes: the cells' files found by name through copies of the benchmark's
files with test-only configurations beside them."""
from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import stages_flow
from benchmark.tests._bench_common import BENCH, tiny_spec

# RAFT's published widths at a frame whose grid's coarsest level is 2 x 2
# (RAFT's own sampler divides by a level's size less one).
SMALL = dict(height=130, width=164, iters=3)


def _flow_spec(tmp, over=None):
    """A spec with the test-only cell `tiny-flow`: `raft-sintel` at SMALL,
    a short traffic."""
    spec = tiny_spec(tmp)
    with open(os.path.join(BENCH, "configs", "raft-sintel.json")) as f:
        cfg = json.load(f)
    cfg.update(SMALL, name="tiny-raft")
    with open(os.path.join(spec.bench_dir, "configs", "tiny-raft.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(BENCH, "traffic", "sintel-pairs.json")) as f:
        t = json.load(f)
    t.update(warmup_requests=1, warmup_seconds=0, check_sample=2, trace_requests=2,
             **(over or {}))
    with open(os.path.join(spec.bench_dir, "traffic", "tiny-pairs.json"), "w") as f:
        json.dump(t, f)
    spec.doc["configs"].append({"name": "tiny-raft", "source": "test", "why": "test",
                                "file": "benchmark/configs/tiny-raft.json", "reduced": []})
    spec.doc["workloads"].append({"name": "tiny-flow", "config": "tiny-raft",
                                  "traffic": "tiny-pairs", "chips": 1, "why": "test"})
    for m in spec.doc["end_to_end"] + spec.doc["per_layer"]:
        if "raft-sintel-b1" in m.get("workloads", ()):
            m["workloads"].append("tiny-flow")
    return spec


def test_a_flow_cell_runs_and_is_correct_on_the_cpu(tmp_path):
    """The cell's runner is found by its kind; the window's requests are
    checked against the reference (each iteration from the program's
    coordinates); the end-to-end metrics are the serving readers'."""
    from benchmark import run

    spec = _flow_spec(str(tmp_path))
    res = run.run_cell(spec, "tiny-flow", 2 ** 40 + 7, 0.5, False, torch.device("cpu"))
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "request_ms_p95", "peak_mem_gib", "setup_s"}
    n = res["numbers"]
    assert n["compared"] >= 1 and n["iter_gap_px"] > 0 and n["flow_up_gap_px"] > 0
    assert n["corr_pyramid_f32_gap"] == 0
    assert set(res["limits"]) == {"flow_up_gap_px", "iter_gap_px", "corr_pyramid_f32_gap",
                                  "failed", "new_captures"}


@pytest.mark.parametrize("fault", ["bf16_volume", "iters31", "instance_cnet", "mask_axis"])
def test_the_flow_check_fails_a_fault(tmp_path, fault):
    """A correlation pyramid kept in bf16, one iteration fewer, instance
    norm in the context encoder, or the mask's softmax over a sub-pixel
    axis: the cell is not correct."""
    from benchmark import run
    from benchmark.runners import flow

    spec = _flow_spec(str(tmp_path))
    with flow._restored():
        res = run.run_cell(spec, "tiny-flow", 2 ** 40 + 8, 0.2, False, torch.device("cpu"),
                           hooks={"fault": flow.FAULTS[fault]})
    assert not res["correct"], res["numbers"]


def test_the_flow_control_is_not_correct(tmp_path):
    """The reference with float8 convolution inputs and weights in the
    program's place fails a limit."""
    from benchmark.run import cell_limits
    from benchmark.runners import flow

    spec = _flow_spec(str(tmp_path))
    cfg, traffic = spec.config("tiny-raft"), spec.traffic("tiny-pairs")
    n = flow.control_numbers(cfg, traffic, 2 ** 40 + 9, torch.device("cpu"))
    limits = cell_limits(cfg, traffic)
    assert any(n[k] > v for k, v in limits.items()), n


def test_the_pyramid_count_is_the_f32_size_of_the_grid():
    """The configuration's f32 pyramid at Sintel's 440 x 1024: 7,040 x 9,280
    values of 4 bytes; a count of half that (a bf16 pyramid) reads 0.5, a
    missing count infinity."""
    from benchmark.runners import flow

    cfg = json.load(open(os.path.join(BENCH, "configs", "raft-sintel.json")))
    want = 4 * 7040 * (7040 + 27 * 64 + 13 * 32 + 6 * 16)
    assert flow.f32_pyramid_bytes(cfg, 1) == want
    assert flow.pyramid_gap(cfg, 1, {"a": want}) == 0
    assert flow.pyramid_gap(cfg, 1, {"a": want, "b": want // 2}) == 0.5
    assert flow.pyramid_gap(cfg, 1, {}) == float("inf")


def test_flow_stage_metrics_read_nothing_off_the_card_and_the_stretch_accounts():
    """The readers give None on the CPU; the stretch itself (one call past
    its warm-ups) reads every stage, and its stamps account."""
    cfg = json.load(open(os.path.join(BENCH, "configs", "raft-sintel.json")))
    cfg.update(SMALL)
    traffic = json.load(open(os.path.join(BENCH, "traffic", "sintel-pairs.json")))
    traffic.update(warmup_requests=1, warmup_seconds=0)
    ctx = dict(kind="serve", config=cfg, traffic=traffic, traced={"busy_s": 1})
    assert stages_flow.metric(ctx, "lookup_ms_per_frame") is None
    got = stages_flow.stretch(cfg, traffic, torch.device("cpu"), seconds=0.0)
    for name in stages_flow.STAGES:
        assert got[f"{name}_ms_per_frame"] > 0
    assert got["graph_nodes_per_frame"] is None  # no graph on the CPU
    assert got["engine_replay_host_ms"] > 0


def test_a_multiclass_cell_runs_and_is_correct_on_the_cpu(tmp_path):
    """Three classes of the tiny configuration through one engine: one
    program per class, every class checked."""
    from benchmark import run

    spec = tiny_spec(str(tmp_path))
    with open(os.path.join(BENCH, "traffic", "track-multiclass8.json")) as f:
        t = json.load(f)
    t.update(classes=3, warmup_requests=3, warmup_seconds=0, check_sample=3, trace_requests=3)
    with open(os.path.join(spec.bench_dir, "traffic", "tiny-multi.json"), "w") as f:
        json.dump(t, f)
    spec.doc["workloads"].append({"name": "tiny-multi", "config": "tiny",
                                  "traffic": "tiny-multi", "chips": 1, "why": "test"})
    for m in spec.doc["end_to_end"] + spec.doc["per_layer"]:
        if "linemod-track-multiclass" in m.get("workloads", ()):
            m["workloads"].append("tiny-multi")
    res = run.run_cell(spec, "tiny-multi", 2 ** 40 + 3, 1.0, False, torch.device("cpu"))
    assert res["correct"] and res["attempted"] >= 3
    # 3 classes x 1 sampled request x 2 render iterations
    assert res["numbers"]["compared"] == 6
    assert set(res["limits"]) == {"pose_gap_px", "flow_gap_px", "failed", "new_captures"}
