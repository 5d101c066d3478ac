"""The port runs as on the card's machine, which has no JAX, OpenCV, PIL or
PyYAML: fresh interpreters with `jax`, `jaxlib`, `flax`, `optax`, `orbax`,
`cv2`, `PIL` and `yaml` blocked in `sys.modules`
* import every module of `rnnpose_tpu_torch` and run a tiny eval forward on
  the CPU, with the serving defaults and with the parity preset plus
  backface culling, then the KPConv towers (`encode_3d`), the uncached
  forward, one `InferenceEngine.refine` and one `Trainer` step;
* write a tiny LINEMOD-format dataset with the port's
  `make_synthetic_linemod` (PNGs, JSON config) and run the eval CLI's `main`
  over it, once by default and once with `--parity`;
* decode the committed JPEG fixtures, then train 3 steps with the training
  CLI on a LINEMOD-format fixture whose synthetic frames take VOC JPEG
  backgrounds (2 loader threads, periodic eval), and run
  `bench_host_pipeline` at one frame;
* import the serving modules, export the tiny eval forward with
  `tools/export_model` (selftest and example), run the bundle in a consumer
  subprocess (`tools/serve_bundle.py`, which also blocks
  `rnnpose_tpu_torch`), and run `tools/demo` and `tools/profile_components`
  on the CPU;
* train one data-parallel step with the training CLI in 2 gloo processes
  (`--multihost`), each with the same modules blocked, after using the
  slice's other new modules (`ops/fps`, `render/fragments`,
  `train/metrics`);
* run the last tools: `make_configs`, `transform_pvnet_data` on a PVNet
  fixture written with the port's own codecs (JPEG, PNG), `parse_trace` on
  a trace of `utils/profiling.trace`, `numerics_check` cpu against cpu, a
  2-step `overfit_check` and `full_budget_rehearsal` at 2 x 2;
* collect and run `tests/test_torch_port_cuda.py`, the card's pytest
  entry, with `--noconftest` (every test skips without a card)."""
import os
import subprocess
import sys
import textwrap


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "yaml"):
        sys.modules[name] = None  # any import of these now raises ImportError
""")

SCRIPT = BLOCK + textwrap.dedent("""
    import dataclasses, importlib, pkgutil
    import torch
    torch.set_num_threads(1)
    import rnnpose_tpu_torch
    for mod in pkgutil.walk_packages(rnnpose_tpu_torch.__path__, "rnnpose_tpu_torch."):
        importlib.import_module(mod.name)
    from rnnpose_tpu_torch.data.synthetic import (
        SyntheticConfig, kpconv_config, make_synthetic_inputs)
    from rnnpose_tpu_torch.models.engine import InferenceEngine
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import (
        RNNPose, RNNPoseConfig, apply_parity_preset, init_random_)
    from rnnpose_tpu_torch.ops import raster_kernels as rk
    syn = SyntheticConfig(
        image_size=64, num_verts=128, num_faces=256, subdivisions=2, fx=100.0, fy=100.0)
    inputs = make_synthetic_inputs(syn)
    kp = kpconv_config(syn)
    model = RNNPose(RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, first_feats_dim=16, gnn_feats_dim=16),
        ctx_kp=dataclasses.replace(kp, first_feats_dim=16, gnn_feats_dim=16,
                                   final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(
            render_iters=1, gru_iters=1, zoom_crop_size=32, corr_levels=2, raster_chunk=64)))
    init_random_(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    V = inputs.mesh.verts.shape[0]
    d3 = torch.nn.functional.normalize(torch.randn(1, V, 32, generator=g), dim=-1)
    c3 = torch.randn(1, V, 256, generator=g)
    T = model(inputs, cached_desc3d=d3, cached_ctx3d=c3)["Ti_pred"]
    assert T.shape == (1, 4, 4) and bool(torch.isfinite(T).all())
    # The reference-exact parity preset with backface culling: the
    # non-fused raster branch and the full-res flow, LM and similarity.
    pcfg = apply_parity_preset(model.cfg)
    pcfg = dataclasses.replace(pcfg, refiner=dataclasses.replace(pcfg.refiner, backface_cull=True))
    parity = RNNPose(pcfg)
    parity.load_state_dict(model.state_dict())
    out = parity(inputs, cached_desc3d=d3, cached_ctx3d=c3)
    assert bool(torch.isfinite(out["Ti_pred"]).all())
    assert out["refiner"].flow_history.shape == (1, 1, 32, 32, 2)
    # The per-class entry point: the towers, the uncached forward, the engine.
    d3, c3 = model.encode_3d(inputs.pyramid)
    assert d3.shape == (1, V, 32) and c3.shape == (1, V, 256)
    real = inputs.pyramid.masks[0] > 0
    assert torch.allclose(d3[real].norm(dim=-1), torch.ones(()), atol=1e-5)
    assert bool((d3[~real] == 0).all()) and bool(torch.isfinite(c3).all())
    T_unc = model(inputs)["Ti_pred"]
    engine = InferenceEngine(model)
    T_eng = engine.refine("ico", inputs)["Ti_pred"]
    assert torch.equal(T_unc, T_eng) and engine.encode_3d_calls == 1
    assert bool(torch.isfinite(T_unc).all())
    # One training step: forward with autograd, losses, backward, update.
    from rnnpose_tpu_torch.train.loop import Trainer
    from rnnpose_tpu_torch.train.optim import OptimizerConfig
    batch = make_synthetic_inputs(dataclasses.replace(syn, num_corr=32), with_corr=True)
    trainer = Trainer(model, OptimizerConfig(total_steps=4))
    w0 = model.motion_net.cf_net.update_block.flow_head.conv2.weight.detach().clone()
    m = trainer.run_step(batch)
    assert float(m["skipped_nonfinite"]) == 0.0 and bool(torch.isfinite(m["loss"]))
    assert not torch.equal(w0, model.motion_net.cf_net.update_block.flow_head.conv2.weight)
    assert rk.zbuffer_sweep_rows_attrs.launches == 0  # CPU: plain versions
    assert rk.zbuffer_sweep_tiled.launches == rk.zbuffer_sweep.launches == 0
    assert (rk.zbuffer_sweep_tiled_attrs_batched.launches
            == rk.zbuffer_sweep_tiled_attrs.launches == 0)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "rnnpose_tpu", "triton")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print("NOJAX_OK")
""")

EVAL_SCRIPT = BLOCK + textwrap.dedent("""
    import json, os, tempfile
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from rnnpose_tpu_torch.tools.eval import main as evaluate
    from rnnpose_tpu_torch.tools.make_synthetic_linemod import main as write
    root = tempfile.mkdtemp()
    cfg_path = write(["--out", root, "--frames", "0", "--eval_frames", "2", "--height", "96",
                      "--width", "96", "--fx", "115.0", "--fy", "115.0", "--cx", "48.0",
                      "--cy", "48.0", "--object_scale", "0.05", "--distance", "0.4",
                      "--batch", "2", "--device", "cpu"])
    with open(cfg_path) as f:
        cfg = json.load(f)
    kp = {"num_layers": 2, "first_subsampling_dl": 0.02, "first_feats_dim": 16,
          "final_feats_dim": 32, "gnn_feats_dim": 16}
    cfg["basic"] = {"zoom_crop_size": [32, 32]}
    cfg["model"] = {"descriptor_net": {"keypoints_detector_3d": kp,
                                       "context_fea_extractor_3d": dict(kp, final_feats_dim=256)},
                    "motion_net": {"iter_count": 1, "render_iter_count": 1,
                                   "raster": {"chunk": 64}}}
    cfg["eval_input_reader"]["dataset"]["kwargs"]["preprocess"] = {
        "crop_size": 64, "max_verts": 256, "max_faces": 512}
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    for extra in ([], ["--parity"]):
        dump = os.path.join(root, "dump" + "".join(extra))
        overall = evaluate(["--config_path", cfg_path, "--device", "cpu", "--eval_batch", "2",
                            "--dump_poses", dump] + extra)
        poses = np.load(os.path.join(dump, "cat_pose_preds.npy"))
        assert poses.shape == (2, 4, 4) and np.isfinite(poses).all(), poses
        assert overall["seq_len"] == 2 and "add01" in overall and "proj5" in overall
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "rnnpose_tpu", "cv2", "PIL", "yaml")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print("NOJAX_EVAL_OK")
""")


TRAIN_SCRIPT = BLOCK + textwrap.dedent("""
    import json, math, os, tempfile
    from pathlib import Path
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, "tests")
    import _torch_port_linemod_common as L
    from rnnpose_tpu_torch.data import imageio
    from rnnpose_tpu_torch.tools.bench_host_pipeline import main as bench
    from rnnpose_tpu_torch.tools.train import main as train
    root = Path(tempfile.mkdtemp())
    for jpg in sorted(L.FIXTURES.glob("*.jpg")):
        assert imageio.read_rgb(str(jpg)).shape[-1] == 3
    cfg_path = L.write_train_fixture(root)
    run = str(root / "run")
    train(["--config_path", cfg_path, "--model_dir", run, "--device", "cpu", "--display_step",
           "1", "--loader_threads", "2", "--eval_frames", "1"])
    rows = [json.loads(line) for line in open(os.path.join(run, "log.json.lst"))]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3]
    assert all(r["skipped_nonfinite"] == 0.0 for r in rows if "loss" in r)
    evals = [r for r in rows if "eval/params_l1" in r]
    assert [r["step"] for r in evals] == [2, 3], rows
    assert all(math.isfinite(v) for r in evals for k, v in r.items() if k.startswith("eval/"))
    summary = bench(["--frames", "1", "--samples", "2", "--threads", "1", "--device", "cpu"])
    assert summary["value"] > 0
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "rnnpose_tpu", "cv2", "PIL", "yaml")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print("NOJAX_TRAIN_OK")
""")


EXPORT_SCRIPT = BLOCK + textwrap.dedent("""
    import json, os, subprocess, tempfile
    import torch
    torch.set_num_threads(1)
    from rnnpose_tpu_torch.render import splat
    from rnnpose_tpu_torch.tools import demo, export_model, profile_components
    from rnnpose_tpu_torch.utils import export, profiling, visualize
    root = tempfile.mkdtemp()
    out, example = os.path.join(root, "bundle"), os.path.join(root, "example.pt")
    manifest, summary = export_model.main([
        "--out", out, "--platform", "cpu", "--image_size", "64", "--verts", "128",
        "--faces", "256", "--zoom", "48", "--render_iters", "1", "--gru_iters", "1",
        "--corr_levels", "2", "--raster_chunk", "64", "--selftest", "--save_example", example])
    assert summary["selftest_max_abs_diff"] < 1e-5, summary
    assert summary["operator_nodes"] == {"zbuffer_sweep_rows_attrs": 1}
    res = subprocess.run([sys.executable, "rnnpose_tpu_torch/tools/serve_bundle.py", out,
                          example, "--device", "cpu"], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["max_abs_diff"] <= 1e-6
    paths = demo.main(["--out_dir", os.path.join(root, "demo"), "--device", "cpu",
                       "--image_size", "96", "--zoom", "64"])
    assert len(paths) == 6 and all(os.path.getsize(p) > 0 for p in paths)
    prof = profile_components.main([
        "--device", "cpu", "--image_size", "64", "--verts", "128", "--faces", "256",
        "--zoom", "64", "--kp_layers", "2", "--tower_width", "16", "--render_iters", "1",
        "--gru_iters", "1", "--corr_levels", "2", "--iters", "1"])
    assert len(prof["components"]) == 9
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "rnnpose_tpu", "cv2", "PIL", "yaml")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print("NOJAX_EXPORT_OK")
""")


TOOLS_SCRIPT = BLOCK + textwrap.dedent("""
    import json, os, pickle, tempfile
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from rnnpose_tpu_torch.data import imageio
    from rnnpose_tpu_torch.data.linemod_config import BLENDER_K
    from rnnpose_tpu_torch.tools import (full_budget_rehearsal, make_configs, numerics_check,
                                         overfit_check, parse_trace, transform_pvnet_data)
    from rnnpose_tpu_torch.utils.config_io import read_yaml
    from rnnpose_tpu_torch.utils.profiling import device_busy, trace
    root = tempfile.mkdtemp()
    names = make_configs.main(["--out_dir", os.path.join(root, "cfg"), "--occ"])
    assert len(names) == 13
    assert read_yaml(os.path.join(root, "cfg", names[0]))["model"]["seq_names"] == ["ape"]
    # A PVNet syn render and a fuse_single composite, written by the port.
    src = os.path.join(root, "src"); os.makedirs(os.path.join(src, "cat"))
    rs = np.random.RandomState(0)
    imageio.write_jpeg(os.path.join(src, "cat", "0.jpg"),
                       rs.randint(0, 256, (48, 64, 3)).astype(np.uint8))
    rng = np.ones((48, 64), np.float32)
    rng[20:35, 25:45] = 0.3
    np.save(os.path.join(src, "cat", "0_depth.npy"), rng)
    info = {"cat": [{"index": 0, "image_path": "cat/0.jpg", "depth_path": "cat/0_depth.npy",
                     "RT": np.eye(4)[:3]}]}
    n = transform_pvnet_data.process_syn(info, src, os.path.join(root, "out"),
                                         {"margin_ratio": 0.1, "output_size": 32})
    assert n == 1
    assert imageio.read_image(os.path.join(root, "out", "cat", "00000.jpg")).shape == (32, 32, 3)
    imageio.write_jpeg(os.path.join(src, "cat", "1_rgb.jpg"),
                       rs.randint(0, 256, (48, 64)).astype(np.uint8))
    m = np.zeros((48, 64, 3), np.uint8); m[22:30, 27:40, 2] = 1
    imageio.write_png(os.path.join(src, "cat", "1_mask.png"), m)
    with open(os.path.join(src, "cat", "1_info.pkl"), "wb") as f:
        pickle.dump(([(1, 2)], [np.eye(4)[:3]], [{"img_idx": 0}]), f)
    dep = os.path.join(root, "dep"); os.makedirs(os.path.join(dep, "cat"))
    np.save(os.path.join(dep, "cat", "0_depth.png.npy"), rng)
    info = {"cat": [{"index": 1, "image_path": "cat/1.jpg", "depth_path": ""}]}
    assert transform_pvnet_data.process_fuse(info, src, dep, os.path.join(root, "out"),
                                             None, single=True) == 1
    mask = imageio.read_png(os.path.join(root, "out", "cat", "00001_mask_visb.png"))
    assert mask.shape == (48, 64) and int(mask.sum()) == 8 * 13 * 255
    with trace(os.path.join(root, "trace")) as prof:
        (torch.randn(32, 32) @ torch.randn(32, 32)).sum()
    agg = parse_trace.aggregate(os.path.join(root, "trace"))
    assert (agg["device_ms"], agg["device_events"]) == device_busy(prof)
    summary = numerics_check.main(["--device", "cpu"])
    assert summary["failures"] == [] and len(summary["ops"]) == 11
    init_add, ref_add, losses = overfit_check.main([
        "--device", "cpu", "--steps", "2", "--train_frames", "1", "--eval_frames", "1",
        "--image_size", "64", "--zoom", "32", "--num_verts", "128", "--num_faces", "256",
        "--subdivisions", "2", "--kp_layers", "2", "--kp_dl", "0.03", "--render_iters", "1",
        "--gru_iters", "1"])
    assert np.isfinite([init_add, ref_add] + losses).all()
    res = full_budget_rehearsal.main([
        "--device", "cpu", "--image_size", "96", "--zoom", "64", "--render_iters", "2",
        "--gru_iters", "2", "--subdivisions", "2", "--verts", "256", "--faces", "512",
        "--out", os.path.join(root, "rehearsal.json")])
    assert res["flow"].shape == (4, 1, 64, 64, 2) and np.isfinite(res["total_loss"])
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax", "rnnpose_tpu", "cv2", "PIL",
                                           "yaml")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print("NOJAX_TOOLS_OK")
""")

CUDA_FILE_SCRIPT = BLOCK + textwrap.dedent("""
    import pytest
    rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q",
                      "tests/test_torch_port_cuda.py"])
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "rnnpose_tpu", "cv2", "PIL", "yaml")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    assert rc == 0, rc
    print("NOJAX_CUDA_FILE_OK")
""")


def _run(script, token):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert token in res.stdout


def test_port_imports_and_runs_without_jax():
    _run(SCRIPT, "NOJAX_OK")


def test_eval_cli_runs_without_jax_opencv_pil_or_yaml():
    _run(EVAL_SCRIPT, "NOJAX_EVAL_OK")


def test_train_cli_on_linemod_data_runs_without_jax_opencv_pil_or_yaml():
    _run(TRAIN_SCRIPT, "NOJAX_TRAIN_OK")


def test_serving_export_and_tools_run_without_jax_opencv_pil_or_yaml():
    _run(EXPORT_SCRIPT, "NOJAX_EXPORT_OK")


DP_RANK = BLOCK + textwrap.dedent("""
    import json, os
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from rnnpose_tpu_torch.render.fragments import fragment_vertices
    from rnnpose_tpu_torch.tools.train import main as train
    from rnnpose_tpu_torch.train.metrics import MetricDict
    centers, inds, frag = fragment_vertices(np.random.RandomState(0).rand(64, 3), 8)
    assert centers.shape == (8, 3) and inds[0] == 0 and frag.max() == 7
    run = sys.argv[1]
    train(["--synthetic", "--syn_image_size", "64", "--syn_zoom", "32", "--device", "cpu",
           "--steps", "1", "--model_dir", run] + sys.argv[2:])
    if "--process_id" in sys.argv and sys.argv[sys.argv.index("--process_id") + 1] == "0":
        rows = [json.loads(line) for line in open(os.path.join(run, "log.json.lst"))]
        metrics = MetricDict()
        metrics.update({k: v for k, v in rows[0].items() if k != "step"})
        assert metrics.summary()["skipped_nonfinite"] == 0.0
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "rnnpose_tpu", "cv2", "PIL", "yaml")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print("NOJAX_DP_OK")
""")


def test_data_parallel_step_runs_without_jax_opencv_pil_or_yaml(tmp_path):
    run = str(tmp_path / "run")
    from rnnpose_tpu_torch.parallel.mesh import launch_local

    outs = launch_local(lambda r, addr: [
        sys.executable, "-c", DP_RANK, run, "--multihost", "--coordinator_address", addr,
        "--num_processes", "2", "--process_id", str(r)], 2, str(tmp_path), 300,
        env={"OMP_NUM_THREADS": "1"})
    assert all("NOJAX_DP_OK" in out for out in outs), outs[0][-2000:]
    assert os.path.isfile(os.path.join(run, "rnnpose-1"))


def test_last_tools_run_without_jax_opencv_pil_or_yaml():
    _run(TOOLS_SCRIPT, "NOJAX_TOOLS_OK")


def test_card_test_file_collects_without_jax():
    """`tests/test_torch_port_cuda.py` imports no jax: pytest collects and
    runs it (every test skips here) with jax and the image libraries
    blocked."""
    _run(CUDA_FILE_SCRIPT, "NOJAX_CUDA_FILE_OK")
