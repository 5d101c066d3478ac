"""The port's serving tools against the JAX package: `render/splat`,
`utils/visualize`, `utils/profiling`, `tools/demo` and
`tools/profile_components`.

* `splat_depth` and `splat_mask` equal JAX's on the same vertices, exactly
  (both round the projected pixel half to even and take a scatter-min).
* The `visualize` functions equal JAX's numpy ones bit for bit.
* `trace` writes a Chrome trace that holds a `Tracer.span`'s range (the tracer's
  own tests are in `test_torch_port_tracing.py`).
* `demo --device cpu` at a tiny size writes six PNGs that the port's reader
  decodes; `profile_components --device cpu` at a tiny size reports every
  component (host ms only: no device number on the CPU).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnpose_tpu.render import splat as jsplat
from rnnpose_tpu.utils import visualize as jvis
from rnnpose_tpu_torch.data.imageio import read_png
from rnnpose_tpu_torch.render import splat
from rnnpose_tpu_torch.tools import demo, profile_components
from rnnpose_tpu_torch.utils import profiling, visualize

torch.set_num_threads(1)


def _verts(B=2, V=300, seed=0):
    """Camera-frame vertices around 0.5 m, a few behind the camera or out of
    the image, with a validity mask; intrinsics of a 64 x 48 image."""
    rs = np.random.RandomState(seed)
    v = rs.uniform(-0.08, 0.08, (B, V, 3)).astype(np.float32)
    v[..., 2] += 0.5
    v[:, :5, 2] = -0.1                                     # behind the camera
    v[:, 5:10, 0] = 0.5                                    # off the image
    valid = (rs.rand(B, V) > 0.1).astype(np.float32)
    K = np.tile(np.asarray([[90.0, 95.0, 32.0, 24.0]], np.float32), (B, 1))
    return v, valid, K


@pytest.mark.parametrize("radius", [0, 1, 2])
def test_splat_depth_and_mask_equal_jax(radius):
    v, valid, K = _verts(seed=radius)
    want = np.asarray(jsplat.splat_depth(jnp.asarray(v), jnp.asarray(K), 48, 64,
                                         jnp.asarray(valid), radius))
    got = splat.splat_depth(torch.from_numpy(v), torch.from_numpy(K), 48, 64,
                            torch.from_numpy(valid), radius).numpy()
    assert got.shape == (2, 48, 64) and (got > 0).sum() > 100
    np.testing.assert_array_equal(got, want)
    mask_j = np.asarray(jsplat.splat_mask(jnp.asarray(v), jnp.asarray(K), 48, 64,
                                          radius=radius))
    mask_t = splat.splat_mask(torch.from_numpy(v), torch.from_numpy(K), 48, 64,
                              radius=radius).numpy()
    np.testing.assert_array_equal(mask_t, mask_j)


def test_visualize_flow_and_depth_equal_jax():
    rs = np.random.RandomState(1)
    flow = rs.randn(24, 32, 2).astype(np.float32) * 5
    for max_mag in (None, 3.0):
        np.testing.assert_array_equal(visualize.flow_to_color(flow, max_mag),
                                      jvis.flow_to_color(flow, max_mag))
    depth = rs.uniform(0.4, 0.8, (24, 32)).astype(np.float32)
    depth[rs.rand(24, 32) < 0.3] = 0.0
    np.testing.assert_array_equal(visualize.depth_to_color(depth), jvis.depth_to_color(depth))
    np.testing.assert_array_equal(visualize.depth_to_color(np.zeros((4, 5))),
                                  jvis.depth_to_color(np.zeros((4, 5))))


def test_visualize_points_and_overlay_equal_jax():
    rs = np.random.RandomState(2)
    img = rs.rand(40, 50, 3).astype(np.float32)
    uv = rs.uniform(-5, 55, (30, 2))
    np.testing.assert_array_equal(visualize.draw_points(img, uv, radius=2),
                                  jvis.draw_points(img, uv, radius=2))
    pts = rs.uniform(-0.05, 0.05, (500, 3)).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.01, -0.02, 0.5]
    K = np.asarray([80.0, 80.0, 25.0, 20.0], np.float32)
    np.testing.assert_array_equal(
        visualize.project_pose_overlay(img, pts, T, K, max_points=100),
        jvis.project_pose_overlay(img, pts, T, K, max_points=100))


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        with profiling.Tracer("cpu").span("serving_tools_range"):
            torch.ones(8).add_(1)
    assert prof is not None
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "serving_tools_range" for e in events)


def test_device_busy_sums_device_operations_without_annotation_spans():
    """`device_busy` on a stand-in profiler: device operations' own times
    summed (exact, in ms), the spans of user annotations and host events
    left out."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(name, device, us, annotation=False):
        return SimpleNamespace(name=name, device_type=device, self_device_time_total=us,
                               is_user_annotation=annotation)

    events = [event("train_step/forward", DeviceType.CPU, 0.0, True),
              event("train_step/forward", DeviceType.CUDA, 900.0),
              event("gemm_kernel", DeviceType.CUDA, 250.0),
              event("Memcpy HtoD", DeviceType.CUDA, 125.0),
              event("aten::mm", DeviceType.CPU, 375.0)]
    prof = SimpleNamespace(events=lambda: events)
    assert profiling.annotation_names(prof) == {"train_step/forward"}
    assert profiling.device_busy(prof) == (0.375, 2)
    assert profiling.device_busy(SimpleNamespace(events=lambda: events[:1] + events[4:])) == (
        0.0, 0)


def test_demo_writes_six_pngs(tmp_path):
    out = str(tmp_path / "demo")
    paths = demo.main(["--out_dir", out, "--device", "cpu", "--image_size", "96",
                       "--zoom", "64"])
    assert sorted(os.path.basename(p) for p in paths) == sorted(demo.OUTPUTS)
    shapes = {os.path.basename(p): read_png(p).shape for p in paths}
    assert shapes == {"poses_init-red_refined-green_gt-blue.png": (96, 96, 3),
                      "syn_img.png": (64, 64, 3), "image_crop.png": (64, 64, 3),
                      "syn_depth.png": (64, 64, 3), "flow.png": (8, 8, 3),
                      "similarity_weight.png": (64, 64, 3)}
    assert read_png(paths[1]).max() > 0   # the rendered view is not blank


def test_profile_components_reports_every_component(tmp_path):
    summary = profile_components.main([
        "--device", "cpu", "--image_size", "64", "--verts", "128", "--faces", "256",
        "--zoom", "64", "--kp_layers", "2", "--tower_width", "16", "--render_iters", "1",
        "--gru_iters", "1", "--corr_levels", "2", "--iters", "2",
        "--trace", str(tmp_path / "trace")])
    names = list(summary["components"])
    assert len(names) == 9 and names[0].startswith("rasterize") and names[-1].startswith("train")
    for t in summary["components"].values():
        assert t["host_ms"] > 0 and t["events_ms"] is None and t["device_ms"] is None
    assert os.path.exists(tmp_path / "trace" / "eval" / "trace.json")
    assert os.path.exists(tmp_path / "trace" / "train" / "trace.json")


@pytest.mark.parametrize("tool", [demo, profile_components])
def test_tools_refuse_cuda_without_a_card(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--out_dir", str(tmp_path / "never")] if tool is demo else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
    assert not (tmp_path / "never").exists()
