"""The `stereo` kind (RAFT-Stereo through `FlowEngine`), its check, faults
and control, its byte counts and its stamped stretch, on the CPU at a small
frame: the cell's files found by name through copies of the benchmark's
files with a test-only configuration beside them."""
from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import stages_stereo
from benchmark.tests._bench_common import BENCH, tiny_spec

# RAFT-Stereo's published widths at a 90 x 150 frame, padded to 96 x 160: a
# 24 x 40 grid, whose coarsest read level is 5 wide.
SMALL = dict(height=90, width=150, padded_height=96, padded_width=160, grid=[24, 40], iters=3)


def _config():
    with open(os.path.join(BENCH, "configs", "raft-stereo-middlebury.json")) as f:
        cfg = json.load(f)
    cfg.update(SMALL)
    return cfg


def _traffic(**over):
    with open(os.path.join(BENCH, "traffic", "middlebury-pairs.json")) as f:
        t = json.load(f)
    t.update(max_disp=16, warmup_requests=1, warmup_seconds=0, check_sample=2,
             trace_requests=2, **over)
    return t


def _stereo_spec(tmp):
    """A spec with the test-only cell `tiny-stereo`: `raft-stereo-middlebury`
    at SMALL, a short traffic."""
    spec = tiny_spec(tmp)
    with open(os.path.join(spec.bench_dir, "configs", "tiny-stereo.json"), "w") as f:
        json.dump(dict(_config(), name="tiny-stereo"), f)
    with open(os.path.join(spec.bench_dir, "traffic", "tiny-stereo-pairs.json"), "w") as f:
        json.dump(_traffic(), f)
    spec.doc["configs"].append({"name": "tiny-stereo", "source": "test", "why": "test",
                                "file": "benchmark/configs/tiny-stereo.json", "reduced": []})
    spec.doc["workloads"].append({"name": "tiny-stereo", "config": "tiny-stereo",
                                  "traffic": "tiny-stereo-pairs", "chips": 1, "why": "test"})
    for m in spec.doc["end_to_end"] + spec.doc["per_layer"]:
        if "raft-stereo-middlebury-b1" in m.get("workloads", ()):
            m["workloads"].append("tiny-stereo")
    return spec


def test_a_stereo_cell_runs_and_is_correct_on_the_cpu(tmp_path):
    """The cell's runner is found by its kind; the window's requests are
    checked against the reference (each iteration from the program's
    coordinates, and the volume each built from the program's features)
    under every limit; the end-to-end metrics are the serving readers'."""
    from benchmark import run

    spec = _stereo_spec(str(tmp_path))
    res = run.run_cell(spec, "tiny-stereo", 2 ** 40 + 11, 0.5, False, torch.device("cpu"))
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0, res["limits"]
    assert set(res["metrics"]) == {"frames_per_s", "request_ms_p95", "peak_mem_gib", "setup_s"}
    n = res["numbers"]
    assert n["compared"] >= 1 and n["iter_gap_px"] > 0 and n["disp_up_gap_px"] > 0
    assert n["corr_pyramid_f32_gap"] == 0 and n["corr_volume_gap"] < 1e-6
    assert set(res["limits"]) == {"disp_up_gap_px", "iter_gap_px", "corr_pyramid_f32_gap",
                                  "corr_volume_gap", "failed", "new_captures"}


@pytest.mark.parametrize("fault", ["bf16_volume", "bf16_volume_f32", "iters31", "coarse_swap",
                                   "no_interp"])
def test_the_stereo_check_fails_a_fault(tmp_path, fault):
    """A correlation volume kept in bf16, one computed in bf16 and kept in
    f32 (the f32 bytes: only `corr_volume_gap` sees it), one iteration
    fewer, gru16 run before gru32, or the coarse-to-fine interpolations
    dropped: some number reads above its limit. The limits were set at the cell's frame,
    where the swapped GRUs read 0.017-0.022 on `iter_gap_px` (limit 0.01,
    sound at most 0.0063); at this small frame the swap reads less,
    0.0096-0.0136 over three seeds, and the seed here reads 0.0136 (sound
    0.0044)."""
    from benchmark import run
    from benchmark.runners import stereo

    spec = _stereo_spec(str(tmp_path))
    with stereo._restored():
        res = run.run_cell(spec, "tiny-stereo", 2 ** 40 + 12, 0.2, False, torch.device("cpu"),
                           hooks={"fault": stereo.FAULTS[fault]})
    assert not res["correct"], res["numbers"]


def test_the_stereo_control_is_not_correct():
    """The reference with float8 convolution inputs and weights in the
    program's place fails a limit."""
    from benchmark.run import cell_limits
    from benchmark.runners import stereo

    cfg, traffic = _config(), _traffic()
    n = stereo.control_numbers(cfg, traffic, 2 ** 40 + 13, torch.device("cpu"))
    limits = cell_limits(cfg, traffic)
    assert any(n[k] > v for k, v in limits.items()), n


def test_the_volume_and_lookup_byte_counts_at_middlebury():
    """At 2880 x 1988 (padded 2016): a 504 x 720 grid, four read levels of
    720, 360, 180 and 90 f32 values a position (1.96 GB; half of it read as
    bf16 reads 0.5); a lookup reads each query's x and 10 values a level
    and writes 36 values: 111.8 MB."""
    from benchmark.runners import stereo

    with open(os.path.join(BENCH, "configs", "raft-stereo-middlebury.json")) as f:
        cfg = json.load(f)
    Q = 504 * 720
    want = 4 * Q * (720 + 360 + 180 + 90)
    assert stereo.f32_pyramid_bytes(cfg, 1) == want == 1_959_552_000
    assert stereo.pyramid_gap(cfg, 1, {"a": want}) == 0
    assert stereo.pyramid_gap(cfg, 1, {"a": want // 2}) == 0.5
    assert stereo.pyramid_gap(cfg, 1, {}) == float("inf")
    assert stereo.lookup1d_bytes(cfg, 1) == Q * (4 + 4 * 10 * 4 + 36 * 4) == 111_767_040
    ctx = dict(kind="serve", model="raft_stereo", config=cfg, batch=1,
               traced={"lookup1d": {"seconds": 32 * 66.7e-6, "launches": 32}})
    assert 49.0 < stereo.lookup1d_roofline(ctx) < 51.0
    assert stereo.lookup1d_roofline(dict(ctx, model="raft")) is None
    assert stereo.lookup1d_roofline(dict(ctx, traced={"lookup1d": {"seconds": 0.0,
                                                                   "launches": 0}})) is None


def test_the_volume_gap_reads_the_rounding_of_the_volume():
    """`volume_gap` against `CorrBlock1D` on the same features: 0 for the
    program's own f32 pyramid builder, about bf16's rounding for its values
    rounded to bf16, infinite without a volume or with a level missing."""
    from rnnpose_tpu_torch.ops import corr as corr_ops
    from benchmark.runners import stereo

    cfg = _config()
    g = torch.Generator().manual_seed(9)
    f1, f2 = (torch.randn(1, 3, 40, 256, generator=g).bfloat16() for _ in range(2))
    levels = list(corr_ops.build_corr_pyramid_1d(f1, f2, 4).levels)
    vol = dict(f1=f1, f2=f2, levels=[lv.reshape(1, 3, 40, -1) for lv in levels])
    assert stereo.volume_gap(vol, cfg) < 1e-6
    rounded = dict(vol, levels=[lv.bfloat16().float() for lv in vol["levels"]])
    assert 1e-3 < stereo.volume_gap(rounded, cfg) < 4e-3
    assert stereo.volume_gap(dict(vol, levels=vol["levels"][:3]), cfg) == float("inf")
    assert stereo.volume_gap(None, cfg) == float("inf")


def test_stereo_stage_metrics_read_nothing_off_the_card_and_the_stretch_accounts():
    """The readers give None on the CPU; the stretch itself (one call past
    its warm-ups) reads every stage, `coarse_gru` among them, and its
    stamps account."""
    cfg, traffic = _config(), _traffic()
    ctx = dict(kind="serve", model="raft_stereo", config=cfg, traffic=traffic,
               traced={"busy_s": 1})
    assert stages_stereo.metric(ctx, "coarse_gru_ms_per_frame") is None
    got = stages_stereo.stretch(cfg, traffic, torch.device("cpu"), seconds=0.0)
    for name in stages_stereo.STAGES:
        assert got[f"{name}_ms_per_frame"] > 0
    assert got["graph_nodes_per_frame"] is None  # no graph on the CPU
    assert got["engine_replay_host_ms"] > 0


def test_the_stereo_gen_moves_the_texture_along_the_rows():
    """image2 at x shows image1's texture at x + d (the x-flow is -d), up to
    the frames' own noise; the same seed gives the same pair."""
    from benchmark import gen_stereo

    g = torch.Generator().manual_seed(5)
    i1, i2, d = gen_stereo.make_pairs(2, 40, 64, 12, 0.0, g)
    assert i1.shape == i2.shape == (2, 40, 64, 3)
    for b, db in enumerate(d.tolist()):
        assert torch.equal(i2[b, :, :64 - db], i1[b, :, db:])
        assert db == 0 or not torch.equal(i2[b], i1[b])
    again = gen_stereo.make_pairs(2, 40, 64, 12, 0.0, torch.Generator().manual_seed(5))
    assert torch.equal(again[0], i1) and torch.equal(again[2], d)
