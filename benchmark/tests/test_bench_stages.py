"""The stamped stretch (`stages.py`) and the readers of the stage metrics,
on synthetic exports and on the CPU at the tiny configurations."""
from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import stages
from benchmark.tests._bench_common import BENCH, ROOT, tiny_config

NEW = {  # metric file -> (kind, key in the stretch's readings)
    **{f"{m}_ms_per_frame.{s}": ("serve", f"{m}_ms_per_frame")
       for m in ("encode", "render", "flow", "pose") for s in ("serve", "eval")},
    **{f"{m}.{s}": ("serve", m) for m in ("graph_nodes_per_frame", "device_idle_in_call_share",
                                          "engine_replay_host_ms") for s in ("serve", "eval")},
    **{f"{m}_ms_per_sample.train": ("train", f"{m}_ms_per_sample")
       for m in ("forward", "backward", "update")},
    "graph_nodes_per_sample.train": ("train", "graph_nodes_per_sample"),
    "device_idle_in_call_share.train": ("train", "device_idle_in_call_share"),
    "trainer_replay_host_ms.train": ("train", "trainer_replay_host_ms"),
}


def _span(name, start, end, parent, call):
    return {"name": name, "start_ns": start, "end_ns": end, "parent": parent, "call": call}


def _stamp(call, name, ns, replay=False):
    return {"call": call, "name": name, "replay": replay, "device_ns": ns, "ns": ns}


def _export(spans, stamps):
    from rnnpose_tpu_torch.utils import profiling

    doc = {"spans": spans, "stamps": stamps, "clock": {"error_ns": 2500.0},
           "stamps_launched": len(stamps), "stamps_expected": len(stamps),
           "stamps_dropped": 0, "stamps_mismatched": 0}
    doc["calls"] = profiling._calls(doc)
    doc["idle"] = profiling._idle(doc)
    return doc


def test_serving_readings_of_a_synthetic_export():
    """Two B=2 requests (ns = 1e-6 ms): the stages' medians over the
    requests per frame, the idle share of the stretch, the replay span's
    mean."""
    from rnnpose_tpu_torch.utils import profiling

    spans, stamps = [], []
    for k, (t, enc) in enumerate(((0, 1000), (10_000, 3000))):
        root = len(spans)
        spans += [_span("engine/refine", t, t + 200, None, k + 1),
                  _span("engine/replay", t + 50, t + 150, root, k + 1)]
        g = t + 100  # the graph's first stamp; copy-in ends at t + 60
        stamps += [_stamp(k + 1, "copy_in", t + 40), _stamp(k + 1, "end", t + 60)]
        stamps += [_stamp(k + 1, n, g + off, True) for n, off in (
            ("encode", 0), ("render", enc), ("flow", enc + 400), ("pose", enc + 700),
            ("tail", enc + 1000), ("end", enc + 1100))]
    doc = _export(spans, stamps)
    r = stages.readings(doc, [1, 2], "serve", 2, profiling)
    assert r["encode_ms_per_frame"] == pytest.approx(2000e-6 / 2)
    assert r["render_ms_per_frame"] == pytest.approx(400e-6 / 2)
    assert r["flow_ms_per_frame"] == pytest.approx(300e-6 / 2)
    assert r["pose_ms_per_frame"] == pytest.approx(300e-6 / 2)
    assert r["tail_ms_per_frame"] == pytest.approx(100e-6 / 2)
    assert r["replay_ms_per_frame"] == pytest.approx((2100 + 4100) / 2 * 1e-6 / 2)
    assert r["engine_replay_host_ms"] == pytest.approx(100e-6)
    # idle: 40 (entry) + 40 (copy-in to graph) per request, over 0 .. 10_000 + 4200
    assert r["device_idle_in_call_share"] == pytest.approx(100 * 160 / 14_200)
    assert r["clock_error_us"] == 2.5


def test_training_readings_of_a_synthetic_export():
    from rnnpose_tpu_torch.utils import profiling

    spans = [_span("trainer/step", 0, 500, None, 1), _span("trainer/replay_a", 10, 20, 0, 1),
             _span("trainer/replay_b", 30, 34, 0, 1)]
    stamps = [_stamp(1, n, t, True) for n, t in (
        ("forward", 100), ("encode", 150), ("tail", 300), ("backward", 400), ("end", 700),
        ("update", 710), ("end", 800))]
    doc = _export(spans, stamps)
    r = stages.readings(doc, [1], "train", 8, profiling)
    assert r["forward_ms_per_sample"] == pytest.approx(300e-6 / 8)
    assert r["backward_ms_per_sample"] == pytest.approx(300e-6 / 8)
    assert r["update_ms_per_sample"] == pytest.approx(90e-6 / 8)
    assert r["trainer_replay_host_ms"] == pytest.approx(14e-6)
    assert r["replay_ms_per_sample"] == pytest.approx(700e-6 / 8)
    assert r["device_idle_in_call_share"] == pytest.approx(100 * (100 + 10) / 800)


@pytest.mark.parametrize("fault", ["mismatched", "dropped", "unexpected"])
def test_stamps_that_do_not_account_give_no_stage_metric(fault):
    """A stamp of another mark than expected, one the ring dropped, or one
    launched that nothing expected: `readings` gives nothing."""
    from rnnpose_tpu_torch.utils import profiling

    spans = [_span("engine/refine", 0, 200, None, 1), _span("engine/replay", 50, 150, 0, 1)]
    stamps = [_stamp(1, n, t, True) for n, t in (("encode", 100), ("tail", 150), ("end", 160))]
    doc = _export(spans, stamps)
    assert stages.readings(doc, [1], "serve", 1, profiling) is not None
    if fault == "mismatched":
        doc["stamps_mismatched"] = 1
    elif fault == "dropped":
        doc["stamps_dropped"] = 1
    else:
        doc["stamps_launched"] += 1
    assert stages.readings(doc, [1], "serve", 1, profiling) is None


def _levels(slow, settled, n_slow, n, rise=1.0):
    """Per-call ms: n_slow calls at `slow`, then `settled`, with a seeded
    0.2% jitter."""
    import random

    rnd = random.Random(7)
    return [(slow if i < n_slow else settled) * rise ** (i >= n_slow)
            * (1 + 0.002 * rnd.uniform(-1, 1)) for i in range(n)]


@pytest.mark.parametrize("case,want", [
    ((29.4, 24.9, 64, 300), 64),     # track: +18%
    ((198.0, 193.5, 30, 150), 30),   # parity: +2.3%
    ((24.9, 24.9, 0, 300), None),    # settled throughout
    ((29.4, 29.4, 0, 300), None),    # slow throughout
    ((24.9, 29.4, 40, 300), None),   # a rise is no slow start
    ((29.4, 24.9, 2, 300), None),    # too few slow calls to tell
    ((29.4, 24.9, 290, 300), None),  # too few settled calls to tell
])
def test_settle_finds_the_drop_of_a_slow_start(case, want):
    assert stages.settle(_levels(*case)) == want


def test_settle_ignores_one_slow_call():
    times = _levels(24.9, 24.9, 0, 200)
    times[2] = 40.0
    assert stages.settle(times) is None


def test_the_stretch_stops_after_stretch_calls_past_the_drop():
    """`_enough`: at least STRETCH calls; then STRETCH settled calls after a
    drop, or the seconds, whichever comes first; at least one call."""
    S = stages.STRETCH
    assert not stages._enough([], 99.0, 0.0)
    assert stages._enough([25.0], 30.0, 30.0)
    flat = _levels(29.4, 29.4, 0, 3 * S)
    assert not stages._enough(flat, 1.0, 30.0)
    drop = _levels(29.4, 24.9, 50, 50 + S)
    assert stages._enough(drop, 1.0, 30.0)
    assert not stages._enough(drop[:-stages.CHECK], 1.0, 30.0)


def test_every_new_metric_file_reads_the_stretch(monkeypatch):
    """Each stage metric's file returns its value from the stretch, only in
    a traced run of its kind on a card; one cell's readers start the
    stretch once; the entries are in BENCHMARK.json with their files."""
    from benchmark.spec import load_spec

    spec = load_spec(ROOT)
    per_layer = {m["name"]: m for m in spec.doc["per_layer"]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    started = []

    def child(cfg, traffic):
        started.append(traffic["kind"])
        return None if cfg == "broken" else {key: 1.5 for _, key in NEW.values()}

    monkeypatch.setattr(stages, "_in_child", child)
    monkeypatch.setattr(stages, "_DONE", {})
    for name, (kind, key) in NEW.items():
        assert name in per_layer and os.path.isfile(os.path.join(BENCH, "metrics", f"{name}.py"))
        read = spec.reader(name)
        cell = dict(config="cfg", traffic={"kind": kind})
        assert read(dict(cell, kind=kind, traced={"busy_s": 1.0})) == 1.5
        other = "train" if kind == "serve" else "serve"
        assert read(dict(cell, kind=other, traced={"busy_s": 1.0})) is None
        assert read(dict(cell, kind=kind)) is None
        assert read(dict(cell, config="broken", kind=kind, traced={"busy_s": 1.0})) is None
    assert sorted(started) == ["serve", "serve", "train", "train"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert spec.reader("encode_ms_per_frame.serve")(
        dict(config="new", traffic={"kind": "serve"}, kind="serve",
             traced={"busy_s": 1.0})) is None
    assert len(started) == 4


def _traffic(name, **over):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        t = json.load(f)
    t.update(over)
    return t


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_the_stretch_runs_on_the_cpu(kind, monkeypatch):
    """The whole stretch at the tiny configuration on the CPU, cut to its
    first call by `seconds`: every reading is there (no graph, so no node
    count; no drop, so no slow call)."""
    monkeypatch.setattr(stages, "CHECK", 1)
    cfg = tiny_config("tiny")
    traffic = (_traffic("track", batch=1, warmup_requests=1) if kind == "serve"
               else _traffic("train8", batch=2, pool=2, num_corr=64))
    got = stages.stretch(cfg, traffic, torch.device("cpu"), seconds=0.0)
    assert got["slow_calls"] == 0 and got["slow_share"] == 0.0
    keys = {k for (kd, k) in NEW.values() if kd == kind}
    assert keys <= set(got)
    nodes = "graph_nodes_per_frame" if kind == "serve" else "graph_nodes_per_sample"
    assert got[nodes] is None
    for k in keys - {nodes}:
        assert got[k] >= 0, k


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    from rnnpose_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "Tracer")
    assert stages.stretch(tiny_config("tiny"), _traffic("track"), torch.device("cpu")) is None
    assert stages._in_child(tiny_config("tiny"), _traffic("track")) is None


def test_the_stretch_runs_in_a_process_of_its_own():
    """`python -m benchmark.stages CONFIG TRAFFIC SECONDS` (what a traced run
    on the card starts, there without SECONDS) prints the readings as its
    last stdout line."""
    import subprocess
    import sys

    traffic = _traffic("track", batch=1, warmup_requests=1)
    argv = [sys.executable, "-m", "benchmark.stages", json.dumps(tiny_config("tiny")),
            json.dumps(traffic), "0"]
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=600,
                         check=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert {k for (kd, k) in NEW.values() if kd == "serve"} <= set(got)
    assert got["encode_ms_per_frame"] > 0 and "stamped calls" in out.stderr
