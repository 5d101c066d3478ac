"""The `train_data` kind at a tiny size on the CPU (64 x 48 frames under a
scaled camera, the tiny configuration, B=2):

* the benchmark's frozen writer and the program's `make_synthetic_linemod`
  write the same files from one seed;
* a whole run past the harness's look for a chip: the program's loaded
  batches equal the frozen reference's read of the same (frame, position)
  pairs, and `correct` comes out true;
* the same run with the timed path broken underneath (two samples of a
  batch swapped, the augmentation position shifted by one, and the
  training faults of `faults.py`) comes out not correct;
* the control (bf16 images, float8 convolutions) fails the cell's limits,
  here and, on a card, at the cell's own size;
* the writer and the reference's sample path import nothing of the
  program.
"""
from __future__ import annotations

import filecmp
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import faults, gen_linemod, run
from benchmark.runners import train_data
from benchmark.tests._bench_common import BENCH, ROOT, tiny_config, tiny_spec

CPU = torch.device("cpu")
SEED = 2**31 + 91
CAMERA = dict(height=48, width=64, fx=57.24114, fy=57.357043, cx=32.52611, cy=24.204899)
# The entries a train-data cell takes in BENCHMARK.json: the training
# metrics its readings fill, and the loader's wait.
TRAIN_METRICS = ("train_samples_per_s", "trainer_host_ms.train", "device_ms_per_sample.train",
                 "mfu.train", "raster_roofline.train", "device_idle_share.train")
LOADER_WAIT = {"name": "loader_wait_ms.train_data", "unit": "ms", "better": "lower",
               "source": "host_clock",
               "layer": "data pipeline, data/loader (PrefetchLoader: sample_at, collate_samples)",
               "moves": "train_samples_per_s", "workloads": ["tiny-train-data"]}


def data_spec(tmp):
    """tiny_spec with the cell `tiny-train-data`: the tiny configuration
    under `train-data8` cut to 8 frames at 64 x 48, B=2. The dataset
    normalises the model cloud to a unit extent; under the tiny
    configuration's 3 cm voxel the towers' output over the symmetric
    icosphere is all but constant, and their gradients are rounding noise
    blown up by the normalisation (~1e21 in both the program and the
    reference), so this configuration takes a 25 cm voxel."""
    spec = tiny_spec(tmp)
    cfg = dict(tiny_config("tiny-data"), kp_dl=0.25)
    with open(os.path.join(spec.bench_dir, "configs", "tiny-data.json"), "w") as f:
        json.dump(cfg, f)
    spec.doc["configs"].append({"name": "tiny-data", "source": "test", "reduced": [],
                                "file": "benchmark/configs/tiny-data.json", "why": "test"})
    with open(os.path.join(BENCH, "traffic", "train-data8.json")) as f:
        t = json.load(f)
    t["data"].update(CAMERA, frames=8, eval_frames=1, batch=4)
    t.update(batch=2, num_corr=64, check_steps=2, replay_steps=2, trace_steps=2,
             check_sample=2, preprocess={"correspondence_radius": 0.05})
    with open(os.path.join(spec.bench_dir, "traffic", "tiny-train-data.json"), "w") as f:
        json.dump(t, f)
    spec.doc["workloads"].append({"name": "tiny-train-data", "config": "tiny-data",
                                  "traffic": "tiny-train-data", "chips": 1, "why": "test"})
    for m in spec.doc["end_to_end"] + spec.doc["per_layer"]:
        if m["name"] in TRAIN_METRICS:
            m["workloads"].append("tiny-train-data")
    spec.doc["per_layer"].append(LOADER_WAIT)
    return spec


def test_the_frozen_writer_writes_the_programs_files(tmp_path):
    from rnnpose_tpu_torch.tools.make_synthetic_linemod import main as write

    args = dict(CAMERA, frames=5, eval_frames=2, seed=11, batch=4)
    a, b = str(tmp_path / "program"), str(tmp_path / "frozen")
    write(["--out", a, "--device", "cpu"] + [x for k, v in args.items()
                                             for x in (f"--{k}", str(v))])
    gen_linemod.write(b, dict(gen_linemod.DEFAULTS, **args), "cpu")
    names = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    assert len(names) == 19
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".yml"):  # the config names its own directory
            assert open(pa).read().replace(a, "R") == open(pb).read().replace(b, "R")
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name


CASES = [(None, None, True), ("swap", None, False), ("shift", None, False)] + [
    (None, f, False) for f in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("data_fault,fault,correct", CASES,
                         ids=[d or f or "sound" for d, f, _ in CASES])
def test_a_run_reads_the_references_batches_and_a_broken_path_is_not_correct(
        tmp_path, data_fault, fault, correct):
    torch.manual_seed(0)
    hooks = {}
    if data_fault:
        hooks["data_fault"] = train_data.FAULTS[data_fault]
    if fault:
        hooks["fault"] = faults.TRAINING[fault]
    res = run.run_cell(data_spec(str(tmp_path)), "tiny-train-data", SEED, 0.5, False, CPU,
                       hooks=hooks)
    assert res["correct"] is correct, res["limits"]
    batch = {k: v for k, v in res["limits"].items() if k.startswith("batch_")}
    assert len(batch) == 6 and res["numbers"]["compared_batches"] >= 5
    if correct:
        assert res["attempted"] >= 1 and res["metrics"]["train_samples_per_s"]["value"] > 0
        assert all(v["value"] <= v["limit"] for v in batch.values()), batch
    elif data_fault:
        assert batch["batch_image_gap"]["value"] > 0, batch


def test_a_traced_run_reads_the_loader_wait(tmp_path):
    res = run.run_cell(data_spec(str(tmp_path)), "tiny-train-data", SEED + 1, 0.3, True, CPU)
    assert res["correct"], res["limits"]
    assert res["metrics"]["loader_wait_ms.train_data"]["value"] >= 0
    assert "mfu.train" in res["metrics"] and "trainer_host_ms.train" in res["metrics"]


def test_the_control_fails_at_the_tiny_size(tmp_path):
    spec = data_spec(str(tmp_path))
    c = spec.cell("tiny-train-data")
    cfg, traffic = spec.config(c["config"]), spec.traffic(c["traffic"])
    numbers = train_data.control_numbers(cfg, traffic, SEED + 2, CPU)
    limits = run.cell_limits(cfg, traffic)
    assert numbers["batch_image_gap"] > limits["batch_image_gap"], numbers
    assert any(numbers[k] > v for k, v in limits.items() if not k.startswith("batch_")), numbers


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    from benchmark.spec import load_spec

    spec = load_spec(ROOT)
    cfg, traffic = spec.config("rnnpose-linemod"), spec.traffic("train-data8")
    numbers = train_data.control_numbers(cfg, traffic, 2**31 + 11, torch.device("cuda", 0))
    assert any(numbers[k] > v for k, v in run.cell_limits(cfg, traffic).items()), numbers


def test_the_writer_and_the_reference_read_import_nothing_of_the_program():
    code = ("import sys, benchmark.gen_linemod, benchmark.reference.data.linemod;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert "rnnpose_tpu_torch" not in eval(out) and "rnnpose_tpu" not in eval(out)
