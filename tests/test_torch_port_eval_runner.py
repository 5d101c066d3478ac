"""The port's evaluation entry point against the JAX package's, on the CPU,
on one LINEMOD-format fixture (written by the JAX package's
`make_synthetic_linemod`: 3 eval frames at 96^2, PoseCNN init poses) and
one set of weights (a JAX `RNNPose` init, converted with `load_jax_params`).

The tiny operating point: 64^2 crops, a 32^2 zoom crop (a 4 x 4 flow grid,
whose fourth correlation level is empty), chunk 64, 2 render x 2 GRU
iterations, 2-layer 16-wide KPConv towers, 256/512 mesh budgets;
`--eval_batch 2`, so the second chunk is one frame padded to two.

* `EvalRunner.run` in f32: refined poses within 1e-3 (the slice bound of
  tests/test_torch_port_slice.py), the same metric keys and seq_len,
  `encode_3d` once for the class; with ICP on the crop's depth too;
* `tools/eval.main` end to end in a subprocess (`--device cpu`, the serving
  defaults in bf16, the checkpoint saved by the port): its `--dump_poses`
  file against the JAX runner's poses within 2e-3 (the bf16 slice bound of
  tests/test_torch_port_slice.py), and its overall line holding every key
  of the JAX evaluator.

Both packages build the KPConv pyramid with numpy here (the native version
orders equal-distance neighbours differently). On this icosphere the KPConv
towers' exact output is 0, so `encode_3d` is f32 rounding noise in both
packages; the serving config, which weighs the similarity on the 1/8 grid,
holds the bounds, the parity preset drifts past them (ROADMAP Queue 3,
explained differences).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import rnnpose_tpu.data.pyramid as jpyr
import rnnpose_tpu_torch.data.pyramid as tpyr

pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_KP = {"num_layers": 2, "first_subsampling_dl": 0.02, "first_feats_dim": 16,
           "final_feats_dim": 32, "gnn_feats_dim": 16}
TINY_PREP = {"crop_size": 64, "num_corr": 64, "correspondence_radius": 0.05,
             "min_correspondences": 5, "max_verts": 256, "max_faces": 512}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from rnnpose_tpu.config import defaults as jdef
    from rnnpose_tpu.models.rnnpose import RNNPose as JRNNPose
    from rnnpose_tpu.tools.eval import make_frame_stream as j_stream
    from rnnpose_tpu.tools.make_synthetic_linemod import main as jwrite
    from rnnpose_tpu.utils.config_io import merge_cfg

    mp = pytest.MonkeyPatch()
    mp.setattr(jpyr, "_cpp", lambda: None)
    mp.setattr(tpyr, "_cpp", lambda: None)
    root = tmp_path_factory.mktemp("lm_eval")
    cfg_path = jwrite(["--out", str(root), "--frames", "0", "--eval_frames", "3",
                       "--height", "96", "--width", "96", "--fx", "115.0", "--fy", "115.0",
                       "--cx", "48.0", "--cy", "48.0", "--object_scale", "0.05",
                       "--distance", "0.4", "--batch", "3"])
    # The written config (YAML), cut to the tiny operating point.
    import yaml

    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    cfg["basic"] = {"zoom_crop_size": [32, 32]}
    cfg["model"] = {"descriptor_net": {"keypoints_detector_3d": TINY_KP,
                                       "context_fea_extractor_3d": dict(TINY_KP,
                                                                        final_feats_dim=256)},
                    "motion_net": {"iter_count": 2, "render_iter_count": 2,
                                   "raster": {"chunk": 64}}}
    cfg["eval_input_reader"]["dataset"]["kwargs"]["preprocess"] = TINY_PREP
    tiny_path = str(root / "tiny.yml")
    with open(tiny_path, "w") as f:
        json.dump(cfg, f)
    cfg = merge_cfg([tiny_path], defaults=jdef.default_config())
    jcfg = jdef.build_model_config(cfg)
    dataset = jdef.build_dataset(cfg, jcfg.desc_kp, is_train=False)
    first = next(j_stream(dataset, eval_batch=2))[0]
    params = jax.device_get(jax.jit(lambda k: JRNNPose(jcfg).init(k, first, train=False))(
        jax.random.PRNGKey(0)))
    yield dict(root=root, cfg_path=tiny_path, jcfg=jcfg, params=params)
    mp.undo()


def _f32(cfg):
    return dataclasses.replace(cfg, refiner=dataclasses.replace(cfg.refiner,
                                                                mixed_precision=False))


def _jax_run(s, cfg, **runner_kw):
    from rnnpose_tpu.config import defaults as jdef
    from rnnpose_tpu.models.rnnpose import RNNPose as JRNNPose
    from rnnpose_tpu.tools.eval import EvalRunner as JRunner
    from rnnpose_tpu.tools.eval import make_frame_stream as j_stream
    from rnnpose_tpu.utils.config_io import merge_cfg

    ds = jdef.build_dataset(merge_cfg([s["cfg_path"]], defaults=jdef.default_config()),
                            cfg.desc_kp, is_train=False)
    return JRunner(JRNNPose(cfg), **runner_kw).run(
        s["params"], j_stream(ds, eval_batch=2), collect_poses=True)


def _port_model(s, cfg):
    """The port's model of the config file, at `cfg`'s precision, with the
    JAX weights."""
    from rnnpose_tpu_torch.config import defaults as tdef
    from rnnpose_tpu_torch.models.convert import load_jax_params
    from rnnpose_tpu_torch.models.rnnpose import RNNPose
    from rnnpose_tpu_torch.utils.config_io import merge_cfg

    tcfg = tdef.build_model_config(merge_cfg([s["cfg_path"]], defaults=tdef.default_config()))
    tcfg = dataclasses.replace(tcfg, refiner=dataclasses.replace(
        tcfg.refiner, mixed_precision=cfg.refiner.mixed_precision))
    return load_jax_params(RNNPose(tcfg), s["params"]).eval()


def test_eval_runner_matches_jax(setup):
    from rnnpose_tpu_torch.config import defaults as tdef
    from rnnpose_tpu_torch.tools.eval import EvalRunner, make_frame_stream
    from rnnpose_tpu_torch.utils.config_io import merge_cfg

    jcfg = _f32(setup["jcfg"])
    res_j, overall_j, poses_j = _jax_run(setup, jcfg)
    model = _port_model(setup, jcfg)
    cfg = merge_cfg([setup["cfg_path"]], defaults=tdef.default_config())
    ds = tdef.build_dataset(cfg, model.cfg.desc_kp, is_train=False)
    for icp in (False, True):
        runner = EvalRunner(model, icp=icp, icp_iters=3, icp_corr_dist=0.05, icp_points=256)
        res_t, overall_t, poses_t = runner.run(make_frame_stream(ds, eval_batch=2),
                                               collect_poses=True)
        assert runner.engine.encode_3d_calls == 1
        assert poses_t.keys() == poses_j.keys() == {"cat"}
        assert poses_t["cat"].shape == (3, 4, 4)
        np.testing.assert_allclose(poses_t["cat"], poses_j["cat"], atol=1e-3)
        assert set(overall_t) >= set(overall_j) and overall_t["seq_len"] == 3
        if not icp:
            assert res_t["cat"].keys() == res_j["cat"].keys()
            np.testing.assert_allclose(overall_t["add_dist"], overall_j["add_dist"], atol=2e-3)
            T_init = np.stack([ds[i]["T_init"] for i in range(3)])
            assert np.abs(poses_t["cat"] - T_init).max() > 1e-3  # it refined


def test_eval_cli_in_a_subprocess_matches_jax(setup, tmp_path):
    from rnnpose_tpu_torch.train.checkpoint import save_checkpoint

    model = _port_model(setup, setup["jcfg"])
    ckpt = save_checkpoint(str(tmp_path / "run"), {"model": model.state_dict()}, 0)
    dump = tmp_path / "dump"
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        import rnnpose_tpu_torch.data.pyramid as pyr
        pyr._cpp = lambda: None  # the numpy pyramid, as the JAX side runs it
        from rnnpose_tpu_torch.tools.eval import main
        main(sys.argv[1:])
    """)
    res = subprocess.run(
        [sys.executable, "-c", code, "--config_path", setup["cfg_path"], "--ckpt_path", ckpt,
         "--device", "cpu", "--eval_batch", "2", "--dump_poses", str(dump)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "parity=off render_iters=2 gru_iters=2 device=cpu" in res.stdout
    overall = json.loads(res.stdout.strip().splitlines()[-1])
    res_j, overall_j, poses_j = _jax_run(setup, setup["jcfg"])
    assert set(overall) >= set(overall_j) | {"host_read_ms", "host_collate_ms", "forward_ms"}
    assert overall["seq_len"] == 3
    poses = np.load(dump / "cat_pose_preds.npy")
    np.testing.assert_allclose(poses, poses_j["cat"], atol=2e-3)


def test_evaluate_frames_matches_jax(setup):
    """`tools/eval.evaluate_frames`, the one-shot runner, against the JAX
    package's (f32): the same per-class and overall keys, seq_len 3 and
    add_dist within the runner's bound (2e-3)."""
    from rnnpose_tpu.config import defaults as jdef
    from rnnpose_tpu.models.rnnpose import RNNPose as JRNNPose
    from rnnpose_tpu.tools.eval import evaluate_frames as j_evaluate
    from rnnpose_tpu.tools.eval import make_frame_stream as j_stream
    from rnnpose_tpu.utils.config_io import merge_cfg as j_merge
    from rnnpose_tpu_torch.config import defaults as tdef
    from rnnpose_tpu_torch.tools.eval import evaluate_frames, make_frame_stream
    from rnnpose_tpu_torch.utils.config_io import merge_cfg

    jcfg = _f32(setup["jcfg"])
    jds = jdef.build_dataset(j_merge([setup["cfg_path"]], defaults=jdef.default_config()),
                             jcfg.desc_kp, is_train=False)
    res_j, overall_j = j_evaluate(JRNNPose(jcfg), setup["params"], j_stream(jds, eval_batch=2))
    model = _port_model(setup, jcfg)
    ds = tdef.build_dataset(merge_cfg([setup["cfg_path"]], defaults=tdef.default_config()),
                            model.cfg.desc_kp, is_train=False)
    res_t, overall_t = evaluate_frames(model, make_frame_stream(ds, eval_batch=2))
    assert res_t.keys() == res_j.keys() == {"cat"}
    assert res_t["cat"].keys() == res_j["cat"].keys()
    assert set(overall_t) >= set(overall_j) and overall_t["seq_len"] == overall_j["seq_len"] == 3
    np.testing.assert_allclose(overall_t["add_dist"], overall_j["add_dist"], atol=2e-3)
