"""The port's training CLI (`rnnpose_tpu_torch.tools.train --synthetic`) on
the CPU at the small fixture (`--syn_image_size 64 --syn_zoom 32`), and its
checkpoint manifest.

* Resume: 4 steps uninterrupted equal 2 steps, `--stop_after 2`, `--resume`
  and 2 more, bit for bit (model, optimizer state and step), the pattern of
  `tests/test_resume_equivalence.py`.
* A run writes `checkpoints.json`, `log.txt` and `log.json.lst`; a
  `model_dir` that holds checkpoints is refused without `--resume`; the XLA
  options are reported as ignored; the dataset path refuses an empty
  training set before writing anything; `--multihost` with neither the
  launch flags nor torchrun's environment raises, naming both; without a
  card the default device raises, naming `--device cpu`.
* The manifest keeps the newest `max_to_keep` step-suffixed checkpoints.
* The host-side modules against the JAX package's: the default config and
  the typed configs built from it (and from a YAML override); a
  reference-layout state dict loads strictly.
"""
import dataclasses
import json
import os

import pytest
import torch
import yaml

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from rnnpose_tpu_torch.tools.train import main as train_main
from rnnpose_tpu_torch.train import checkpoint as ckpt

SMALL = ["--synthetic", "--syn_image_size", "64", "--syn_zoom", "32", "--device", "cpu"]


def _config(tmp_path, **train_config):
    path = str(tmp_path / "cfg.yml")
    with open(path, "w") as f:
        yaml.safe_dump({"train_config": train_config}, f)
    return ["--config_path", path]


def _assert_equal(a, b, where):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_resume_is_bitwise(tmp_path):
    common = SMALL + _config(tmp_path, steps=4, steps_per_eval=2) + ["--display_step", "1"]
    dir_a, dir_b = str(tmp_path / "uninterrupted"), str(tmp_path / "killed")
    train_main(common + ["--model_dir", dir_a])
    # The kill: the same 4-step schedule left after the step-2 checkpoint.
    train_main(common + ["--model_dir", dir_b, "--stop_after", "2"])
    assert ckpt.restore_checkpoint(ckpt.latest_checkpoint(dir_b))["step"] == 2
    train_main(common + ["--model_dir", dir_b, "--resume"])
    a = ckpt.restore_checkpoint(ckpt.latest_checkpoint(dir_a))
    b = ckpt.restore_checkpoint(ckpt.latest_checkpoint(dir_b))
    assert a["step"] == b["step"] == 4 and a["optimizer"]["count"] == 4
    _assert_equal(a, b, "checkpoint")
    with open(os.path.join(dir_b, "log.txt")) as f:
        assert "restored checkpoint at step 2" in f.read()


def test_run_files_and_refusals(tmp_path):
    run = str(tmp_path / "run")
    train_main(SMALL + ["--steps", "2", "--model_dir", run, "--cost_analysis"])
    for name in ("checkpoints.json", "log.txt", "log.json.lst", "config_resolved.yml"):
        assert os.path.isfile(os.path.join(run, name)), name
    with open(os.path.join(run, "checkpoints.json")) as f:
        assert json.load(f) == {"latest_ckpt": "rnnpose-2", "all_ckpts": ["rnnpose-2"]}
    with open(os.path.join(run, "log.json.lst")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1]
    assert {"loss", "grad_norm", "skipped_nonfinite", "recall"} <= set(rows[0])
    with open(os.path.join(run, "log.txt")) as f:
        assert "--cost_analysis is an XLA option: ignored" in f.read()
    with pytest.raises(RuntimeError, match="pass --resume"):
        train_main(SMALL + ["--steps", "2", "--model_dir", run])
    # The dataset path (the default config names no info files) refuses an
    # empty training set before it writes anything.
    with pytest.raises(ValueError, match="training dataset holds no frame"):
        train_main(["--model_dir", str(tmp_path / "data"), "--device", "cpu"])
    assert not (tmp_path / "data").exists()
    with pytest.raises(ValueError, match="no rendezvous.*--coordinator_address.*torchrun"):
        train_main(SMALL + ["--model_dir", str(tmp_path / "mh"), "--multihost"])
    assert not (tmp_path / "mh").exists()


def test_manifest_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    assert ckpt.try_restore_latest(d) is None
    for step in range(1, 5):
        ckpt.save_checkpoint(d, {"model": {"w": torch.full((2,), float(step))}}, step,
                             max_to_keep=2)
    with open(os.path.join(d, "checkpoints.json")) as f:
        assert json.load(f) == {"latest_ckpt": "rnnpose-4",
                                "all_ckpts": ["rnnpose-3", "rnnpose-4"]}
    assert sorted(n for n in os.listdir(d) if n.startswith("rnnpose")) == [
        "rnnpose-3", "rnnpose-4"]
    state = ckpt.try_restore_latest(d)
    assert state["step"] == 4 and torch.equal(state["model"]["w"], torch.full((2,), 4.0))


def test_configs_match_jax(tmp_path):
    from rnnpose_tpu.config import defaults as jdef
    from rnnpose_tpu.utils import config_io as jio
    from rnnpose_tpu_torch.config import defaults as tdef
    from rnnpose_tpu_torch.utils import config_io as tio

    assert tdef.default_config() == jdef.default_config()
    over = {"model": {"motion_net": {"iter_count": 2, "with_corr_weight": False}},
            "train_config": {"steps": 77, "freeze_patterns": ["hybrid/desc2d/"]}}
    path = str(tmp_path / "over.yml")
    with open(path, "w") as f:
        yaml.safe_dump(over, f)
    for paths in ([], [path]):
        cj = jio.merge_cfg(paths, defaults=jdef.default_config())
        ct = tio.merge_cfg(paths, defaults=tdef.default_config())
        assert ct == cj
        assert (dataclasses.asdict(tdef.build_model_config(ct))
                == dataclasses.asdict(jdef.build_model_config(cj)))
        assert (dataclasses.asdict(tdef.build_optimizer_config(ct))
                == dataclasses.asdict(jdef.build_optimizer_config(cj)))
    with open(path, "w") as f:
        yaml.safe_dump({"train_config": {"stepz": 1}}, f)
    with pytest.raises(KeyError, match="train_config.stepz"):
        tio.merge_cfg([path], defaults=tdef.default_config())
    # The dataset of the defaults (no info files) holds no frame in either
    # package.
    kp = tdef.build_model_config(ct).desc_kp
    assert len(tdef.build_dataset(ct, kp, is_train=True)) == 0
    assert len(jdef.build_dataset(cj, jdef.build_model_config(cj).desc_kp, is_train=False)) == 0


def test_reference_state_dict_loads_strictly(tmp_path):
    from rnnpose_tpu_torch.models.convert import load_reference_state_dict
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_

    def model(seed):
        cfg = RNNPoseConfig(refiner=RefinerConfig(render_iters=1, gru_iters=1))
        return init_random_(RNNPose(cfg), torch.Generator().manual_seed(seed))

    src = model(0)
    sd = dict(src.state_dict(), global_step=torch.tensor(5),
              **{"hybrid_desc_net.descriptor3D.epsilon": torch.tensor(1e-6)})
    path = str(tmp_path / "ref.tckpt")
    torch.save({"state_dict": sd}, path)
    dst = load_reference_state_dict(model(1), path)
    _assert_equal(dst.state_dict(), src.state_dict(), "state_dict")
    sd.pop("motion_net.sigma.0")
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="sigma"):
        load_reference_state_dict(model(1), path)


def test_without_a_card_it_raises_unless_device_cpu(tmp_path, monkeypatch):
    """The default device is `cuda`: where no card is visible the CLI
    raises, naming `--device cpu`, before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = tmp_path / "run"
    args = [a for a in SMALL if a not in ("--device", "cpu")] + ["--model_dir", str(run)]
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_main(args + ["--steps", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_main(args + ["--steps", "1", "--device", "cuda:0"])
    assert not run.exists()
