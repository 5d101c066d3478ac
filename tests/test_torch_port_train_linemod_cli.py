"""The port's training CLI on LINEMOD-format data (`tools/train.py` without
`--synthetic`), on the CPU, at the fixture of `_torch_port_linemod_common`
(64^2 frames, every other train frame `is_syn` over VOC JPEGs).

* Bitwise resume and what does not move training: run A reads with 2
  loader threads, runs the periodic eval after each checkpoint
  (`--eval_frames 2`) and is not interrupted; run B reads synchronously,
  runs no eval (`--eval_frames 0`), stops after step 2 and resumes. Both
  reach step 3 with identical checkpoints (model, optimizer, step), every
  step applied (`skipped_nonfinite == 0`). One equality shows the thread
  count, the periodic eval and the restart change nothing.
* The periodic eval logs `eval/<key>` for every key of the JAX evaluator's
  overall line and `eval/params_l1`, the sum of |p| over the parameters of
  the checkpoint just written; it hands the model back in train mode with
  no gradient, parameter or torch RNG state changed.
* Negative counts are usage errors before anything is written.
"""
import json
import math
import os

import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import _torch_port_linemod_common as L
from rnnpose_tpu_torch.tools.train import main as train_main
from rnnpose_tpu_torch.train import checkpoint as ckpt

# The JAX evaluator's overall keys (its CLI's summary line), with the port's
# forward_ms.
EVAL_KEYS = ("add01", "add005", "add002", "proj5", "cm5deg5", "trans_err", "rot_err_deg",
             "add_dist", "add_dist_raw", "adds_dist_raw", "seq_len", "fps", "forward_ms")


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    return L.write_train_fixture(tmp_path_factory.mktemp("cli_lm"))


def _rows(run):
    with open(os.path.join(run, "log.json.lst")) as f:
        return [json.loads(line) for line in f]


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


def test_resume_threads_and_eval_leave_training_bitwise(cfg_path, tmp_path):
    common = ["--config_path", cfg_path, "--device", "cpu", "--display_step", "1"]
    run_a, run_b = str(tmp_path / "a"), str(tmp_path / "b")
    train_main(common + ["--model_dir", run_a, "--loader_threads", "2", "--eval_frames", "2",
                         "--eval_batch", "2"])
    sync = ["--loader_threads", "0", "--eval_frames", "0"]
    train_main(common + ["--model_dir", run_b, "--stop_after", "2"] + sync)
    assert ckpt.restore_checkpoint(ckpt.latest_checkpoint(run_b))["step"] == 2
    train_main(common + ["--model_dir", run_b, "--resume"] + sync)
    a = ckpt.restore_checkpoint(ckpt.latest_checkpoint(run_a))
    b = ckpt.restore_checkpoint(ckpt.latest_checkpoint(run_b))
    assert a["step"] == b["step"] == 3
    _assert_equal(a, b, "checkpoint")
    with open(os.path.join(run_a, "checkpoints.json")) as f:
        assert json.load(f)["all_ckpts"] == ["rnnpose-2", "rnnpose-3"]
    with open(os.path.join(run_b, "log.txt")) as f:
        assert "restored checkpoint at step 2" in f.read()

    train_rows = [r for r in _rows(run_a) + _rows(run_b) if "loss" in r]
    assert [r["step"] for r in train_rows] == [1, 2, 3, 1, 2, 3]
    assert all(r["skipped_nonfinite"] == 0.0 and math.isfinite(r["loss"]) for r in train_rows)

    evals = [r for r in _rows(run_a) if "eval/params_l1" in r]
    assert [r["step"] for r in evals] == [2, 3]
    assert not any("eval/params_l1" in r for r in _rows(run_b))
    for row in evals:
        missing = [k for k in EVAL_KEYS if f"eval/{k}" not in row]
        assert not missing, missing
        assert all(math.isfinite(v) for k, v in row.items() if k.startswith("eval/"))
        assert row["eval/seq_len"] == 2
    l1 = float(sum(v.abs().sum() for k, v in a["model"].items()
                   if not k.endswith("kernel_points")))
    assert evals[-1]["eval/params_l1"] == pytest.approx(l1, rel=1e-5)


def test_periodic_eval_changes_no_training_state(cfg_path):
    import argparse

    from rnnpose_tpu_torch.config.defaults import build_model_config, default_config
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, init_random_
    from rnnpose_tpu_torch.tools.train import make_periodic_eval
    from rnnpose_tpu_torch.utils.config_io import merge_cfg

    cfg = merge_cfg([cfg_path], defaults=default_config())
    model_cfg = build_model_config(cfg)
    model = init_random_(RNNPose(model_cfg), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = torch.get_rng_state()
    run = make_periodic_eval(cfg, model_cfg, model, argparse.Namespace(
        eval_frames=2, eval_batch=1), torch.device("cpu"))
    first = run()
    assert model.training and all(p.grad is None for p in model.parameters())
    assert torch.equal(rng, torch.get_rng_state())
    _assert_equal(model.state_dict(), before, "state_dict")
    assert first["eval/seq_len"] == 2
    # New weights, new features: the runner's class cache does not carry over.
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    second = run()
    assert second["eval/params_l1"] == pytest.approx(1.5 * first["eval/params_l1"], rel=1e-5)
    assert second["eval/add_dist"] != first["eval/add_dist"]


@pytest.mark.parametrize("flag", ["--loader_threads", "--eval_frames"])
def test_negative_counts_are_usage_errors(cfg_path, tmp_path, flag):
    run = tmp_path / "run"
    with pytest.raises(SystemExit):
        train_main(["--config_path", cfg_path, "--model_dir", str(run), "--device", "cpu",
                    flag, "-1"])
    with pytest.raises(SystemExit):
        train_main(["--config_path", cfg_path, "--model_dir", str(run), "--device", "cpu",
                    "--eval_batch", "0"])
    assert not run.exists()
