"""Shared helpers of the benchmark's CPU tests: a tiny configuration and
a spec over a copy of the benchmark's data with test-only entries."""
from __future__ import annotations

import copy
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# The port's `tiny` scene (`tools/measure_fps.SCENES["tiny"]`).
TINY = dict(image_size=96, zoom_crop_size=48, fx=150.0, fy=150.0, num_verts=256,
            num_faces=512, subdivisions=2, kp_layers=2, kp_dl=0.03, kp_first_feats_dim=16,
            kp_gnn_feats_dim=16, corr_levels=3, raster_chunk=64, render_iters=2, gru_iters=2)


def tiny_config(name: str, parity: bool = False) -> dict:
    with open(os.path.join(BENCH, "configs", "rnnpose-linemod-parity.json" if parity
                           else "rnnpose-linemod.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, name=name)
    return cfg


def tiny_spec(tmp, traffic_over=None, limits=None):
    """A Spec whose cells run the tiny configurations: the benchmark's
    traffic and metric files copied with test-only entries beside them
    (`tiny-*` traffic, `tiny` configurations), and BENCHMARK.json's metric
    entries extended to the test cells."""
    from benchmark.spec import Spec

    bench = os.path.join(tmp, "benchmark")
    shutil.copytree(os.path.join(BENCH, "traffic"), os.path.join(bench, "traffic"))
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(bench, "metrics"))
    os.makedirs(os.path.join(bench, "configs"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    doc = copy.deepcopy(doc)
    cells = {"tiny-track": ("tiny", "tiny-track"), "tiny-parity": ("tiny-parity", "tiny-batch"),
             "tiny-train": ("tiny", "tiny-train")}
    for name, parity in (("tiny", False), ("tiny-parity", True)):
        cfg = tiny_config(name, parity)
        if limits:
            cfg["limits"] = limits
        with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
            json.dump(cfg, f)
        doc["configs"].append({"name": name, "source": "test", "file":
                               f"benchmark/configs/{name}.json", "reduced": [], "why": "test"})
    for name, base in (("tiny-track", "track"), ("tiny-batch", "batch8"), ("tiny-train", "train8")):
        with open(os.path.join(BENCH, "traffic", f"{base}.json")) as f:
            t = json.load(f)
        t.update(batch=2 if base != "track" else 1, warmup_requests=1, trace_requests=2,
                 trace_steps=2, check_steps=2, replay_steps=2, pool=4, num_corr=64, check_sample=2)
        t.update((traffic_over or {}).get(name, {}))
        with open(os.path.join(bench, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
    # Each test cell reports what the cell it mirrors reports.
    mirrors = {"tiny-track": "linemod-track-b1", "tiny-parity": "parity-eval-b8",
               "tiny-train": "linemod-train-b8"}
    for cell, (config, traffic) in cells.items():
        doc["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                                 "why": "test"})
        for m in doc["end_to_end"] + doc["per_layer"]:
            if mirrors[cell] in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)
    return Spec(tmp, doc, bench)
