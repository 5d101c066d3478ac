"""The port's instrument tools on the CPU, at tiny sizes:

* `tools/numerics_check --device cpu --full`: cpu against cpu runs every op
  of the JAX tool's list, and none FAILs (every |difference| 0);
* `tools/ablate_inner_step`: every sub-op timed, alone and as `--scan`
  chains;
* `tools/parse_trace`: on a trace written by `utils/profiling.trace` its
  device sum and event count equal `utils/profiling.device_busy`'s on the
  same profile (none on the CPU); on a hand-written Chrome trace, the
  annotation rule, the host-op attribution, `family` and the launch count;
* `tools/overfit_check`: a 3-step run in both eval modes returns finite ADDs
  and prints its `OVERFIT_CHECK_RESULT` line;
* `tools/measure_fps` and `tools/budget_frontier` at the tiny scene, the
  frontier over a LINEMOD-format fixture and a port checkpoint, with
  `--skip_fps` and without.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)

NUMERICS_OPS = {"se3_expm", "se3_logm(expm)", "se3_inverse", "se3_increment (expm @ T)",
                "compose+transform_points", "pose_transform_coords", "LM reprojection_optim",
                "ADD metric", "ADD-S metric", "rasterize 1024f@128^2 (zbuf)",
                "fused raster+attrs 1024f@128^2", "FULL eval forward (fp32, Ti_pred)"}


def test_numerics_check_cpu_against_cpu():
    from rnnpose_tpu_torch.tools.numerics_check import main

    summary = main(["--device", "cpu", "--full"])
    assert set(summary["ops"]) == NUMERICS_OPS
    assert summary["failures"] == []
    assert all(r["ok"] and r["max_abs"] == 0.0 for r in summary["ops"].values())
    assert set(summary["tf32_before"]) == {"matmul.allow_tf32", "cudnn.allow_tf32"}


def test_numerics_check_raises_without_a_card(monkeypatch):
    from rnnpose_tpu_torch.tools.numerics_check import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([])


@pytest.mark.parametrize("scan", [0, 2])
def test_ablate_inner_step_on_cpu(scan, capsys):
    from rnnpose_tpu_torch.tools.ablate_inner_step import main

    summary = main(["--device", "cpu", "--batch", "2", "--size", "64", "--iters", "2",
                    "--scan", str(scan)])
    out = capsys.readouterr().out
    assert "corr lookup r=4 bandmm" in out and "n/a" in out
    comps = summary["components"]
    assert all(t["host_ms"] > 0 and t["device_ms"] is None for t in comps.values())
    if scan:
        assert set(summary["per_iter_ms"]) == {
            "corr lookup r=4", "update block (no mask head)", "update block +mask head",
            "LM 1-step @ 8^2", "sim weight lr-only", "sim weight + resize",
            "FULL inner step (composed)"}
        assert math.isfinite(summary["sum_of_parts_ms"]) and summary["composed_ms"] > 0
    else:
        assert len(comps) == 7


def test_parse_trace_agrees_with_device_busy_on_a_profile(tmp_path, capsys):
    from rnnpose_tpu_torch.tools import parse_trace
    from rnnpose_tpu_torch.utils.profiling import annotate, device_busy, trace

    with trace(str(tmp_path / "t")) as prof:
        with annotate("step"):
            x = torch.randn(64, 64)
            (x @ x).relu().sum()
    busy_ms, busy_n = device_busy(prof)
    agg = parse_trace.aggregate(str(tmp_path))
    assert agg["trace"] == str(tmp_path / "t" / "trace.json")
    assert (agg["device_ms"], agg["device_events"]) == (busy_ms, busy_n)
    summary = parse_trace.main([str(tmp_path / "t" / "trace.json"), "--top", "5"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    with pytest.raises(FileNotFoundError):
        parse_trace.aggregate(str(tmp_path / "empty"))


def test_parse_trace_rules_on_a_written_trace(tmp_path):
    from rnnpose_tpu_torch.tools import parse_trace

    def ev(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0,
                "args": args}

    gemm = "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128_32x3_nn>(Params)"
    add = ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>"
           ", at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>)")
    events = [
        ev("user_annotation", "train_step/forward", 0, 100, **{"External id": 1}),
        ev("gpu_user_annotation", "train_step/forward", 0, 90),
        ev("cpu_op", "aten::mm", 1, 10, **{"External id": 2}),
        ev("cpu_op", "aten::add", 20, 5, **{"External id": 3}),
        ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=7, **{"External id": 2}),
        ev("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=8, **{"External id": 3}),
        ev("cuda_driver", "cuLaunchKernelEx", 30, 1, correlation=9),
        ev("cuda_runtime", "cudaMemcpyAsync", 40, 1, correlation=10),
        ev("kernel", gemm, 5, 250.0, correlation=7, **{"External id": 2}),
        ev("kernel", add, 260, 4.5, correlation=8, **{"External id": 3}),
        ev("kernel", "rnnpose_raster_rows_attrs_kernel", 270, 12.0, correlation=9),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 300, 3.0, correlation=10),
        ev("gpu_memset", "Memset (Device)", 310, 0.5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events + [{"ph": "i", "name": "marker"}]}))
    agg = parse_trace.aggregate(str(path))
    assert agg["device_events"] == 5 and agg["launches"] == 3
    assert agg["device_ms"] == pytest.approx(0.27)
    assert agg["per_host_op"]["aten::mm"] == pytest.approx(0.25)
    assert agg["per_host_op"]["aten::add"] == pytest.approx(0.0045)
    assert agg["per_host_op"]["(no host op)"] == pytest.approx(0.0155)
    assert parse_trace.family(gemm) == "Kernel2"
    assert parse_trace.family(add) == "vectorized_elementwise_kernel"
    assert parse_trace.family("fusion.123 = f32[8] fusion(...)") == "fusion"
    assert set(agg["per_family"]) == {"Kernel2", "vectorized_elementwise_kernel",
                                      "rnnpose_raster_rows_attrs_kernel", "Memcpy DtoH",
                                      "Memset"}


TINY_OVERFIT = ["--device", "cpu", "--steps", "3", "--train_frames", "2", "--eval_frames", "1",
                "--image_size", "64", "--zoom", "32", "--num_verts", "128", "--num_faces",
                "256", "--subdivisions", "2", "--kp_layers", "2", "--kp_dl", "0.03",
                "--render_iters", "1", "--gru_iters", "1"]


@pytest.mark.parametrize("mode", ["heldout", "train_newinit"])
def test_overfit_check_smoke(mode, capsys):
    from rnnpose_tpu_torch.tools.overfit_check import main

    init_add, ref_add, losses = main(TINY_OVERFIT + ["--eval_mode", mode, "--remat", "on"])
    assert math.isfinite(init_add) and math.isfinite(ref_add) and init_add > 0
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("OVERFIT_CHECK_RESULT ")]
    assert len(line) == 1
    res = json.loads(line[0].split(" ", 1)[1])
    assert res["eval_mode"] == mode and res["steps"] == 3
    assert res["ratio"] == pytest.approx(ref_add / init_add)
    for k in ("init_add_mm", "ref_add_mm", "loss_first50", "loss_last50", "wall_s"):
        assert math.isfinite(res[k])


def test_measure_fps_tiny_on_cpu():
    from rnnpose_tpu_torch.tools.measure_fps import main, measure_fps

    fps, gflops, reps = measure_fps(2, 1, 1, "cpu", "tiny", frames=2)
    assert len(reps) == 3 and fps == max(reps) > 0 and gflops > 0
    rows = main(["--device", "cpu", "--scene", "tiny", "--frames", "2", "--batch", "1",
                 "--render_iters", "1", "--gru_iters", "1"])
    assert rows[0]["batch"] == 1 and rows[0]["fps"] > 0 and len(rows[0]["fps_runs"]) == 3


@pytest.fixture(scope="module")
def lm_fixture(tmp_path_factory):
    """A LINEMOD-format eval fixture (2 frames at 96^2, the port's writer,
    the config cut to the tiny operating point) and a port checkpoint of
    seeded random weights."""
    from rnnpose_tpu_torch.config.defaults import build_model_config, default_config
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, init_random_
    from rnnpose_tpu_torch.tools.make_synthetic_linemod import main as write
    from rnnpose_tpu_torch.train.checkpoint import save_checkpoint
    from rnnpose_tpu_torch.utils.config_io import merge_cfg

    root = tmp_path_factory.mktemp("lm_frontier")
    cfg_path = write(["--out", str(root), "--frames", "0", "--eval_frames", "2", "--height",
                      "96", "--width", "96", "--fx", "115.0", "--fy", "115.0", "--cx", "48.0",
                      "--cy", "48.0", "--object_scale", "0.05", "--distance", "0.4", "--batch",
                      "2", "--device", "cpu"])
    with open(cfg_path) as f:
        cfg = json.load(f)
    kp = {"num_layers": 2, "first_subsampling_dl": 0.02, "first_feats_dim": 16,
          "final_feats_dim": 32, "gnn_feats_dim": 16}
    cfg["basic"] = {"zoom_crop_size": [32, 32]}
    cfg["model"] = {"descriptor_net": {"keypoints_detector_3d": kp,
                                       "context_fea_extractor_3d": dict(kp, final_feats_dim=256)},
                    "motion_net": {"raster": {"chunk": 64}}}
    cfg["eval_input_reader"]["dataset"]["kwargs"]["preprocess"] = {
        "crop_size": 64, "max_verts": 256, "max_faces": 512}
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    model_cfg = build_model_config(merge_cfg([cfg_path], defaults=default_config()))
    model = init_random_(RNNPose(model_cfg), torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(str(root / "run"), {"model": model.state_dict()}, 0)
    return cfg_path, ckpt


@pytest.mark.parametrize("skip_fps", [True, False])
def test_budget_frontier_tiny_on_cpu(lm_fixture, tmp_path, skip_fps, capsys):
    from rnnpose_tpu_torch.tools.budget_frontier import main

    cfg_path, ckpt = lm_fixture
    out = str(tmp_path / "frontier.json")
    argv = ["--config_path", cfg_path, "--ckpt_path", ckpt, "--grid", "2x1,1x1", "--max_frames",
            "2", "--eval_batch", "2", "--device", "cpu", "--out", out]
    argv += ["--skip_fps"] if skip_fps else ["--fps_scene", "tiny", "--fps_frames", "1"]
    rows = main(argv)
    printed = [json.loads(x.split(" ", 1)[1]) for x in capsys.readouterr().out.splitlines()
               if x.startswith("FRONTIER ")]
    assert printed == rows
    with open(out) as f:
        assert json.load(f) == rows
    assert [(r["render_iters"], r["gru_iters"]) for r in rows] == [(2, 1), (1, 1)]
    for r in rows:
        assert r["seq_len"] == 2 and "add01" in r and np.isfinite(r["add_dist"])
        assert ("fps_b1" in r) != skip_fps
        if not skip_fps:
            assert r["fps_b1"] > 0 and r["fps_b8"] > 0 and len(r["fps_b8_runs"]) == 3
            assert r["flop_counter_gflops_per_frame_b1"] > 0
    with pytest.raises(ValueError, match="positive"):
        main(argv[:4] + ["--grid", "0x4", "--skip_fps", "--device", "cpu"])


def test_new_tools_raise_without_a_card(monkeypatch, tmp_path):
    """Each new entry point defaults to `--device cuda` and raises, naming
    `--device cpu`, where no card is visible."""
    from rnnpose_tpu_torch.tools import (ablate_inner_step, full_budget_rehearsal,
                                         measure_fps, overfit_check)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: ablate_inner_step.main([]), lambda: overfit_check.main([]),
               lambda: full_budget_rehearsal.main([]), lambda: measure_fps.main([])):
        with pytest.raises(RuntimeError, match="cpu"):
            fn()
