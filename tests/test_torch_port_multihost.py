"""The port's training and eval CLIs with `--multihost`: 2 gloo processes on
the CPU (each group under its own wall-clock limit), the port's
counterpart of `tests/test_multihost.py` and
`tests/test_sharded_cli_training.py`.

* Synthetic data at 64^2 / 32^2: both ranks train on the same batch, so
  the averaged gradient is the one-process gradient and the final
  checkpoint (model, optimizer, step) equals a 1-process run's bit for bit;
  the logged losses too. A world of one (in this process) equals the run
  without `--multihost` bit for bit, and leaves no process group behind.
* LINEMOD-format data (the fixture of `_torch_port_linemod_common`):
  `dataset_batches` gives shard r of 2 the sampler's shard r and stream
  positions k * 2 + r, disjoint between the ranks; a 2-process run with a
  periodic eval of one frame (rank 1 evaluates none) writes one set of
  files from rank 0 only and logs the gathered summary; the same run
  stopped after step 2 and resumed reaches the uninterrupted run's
  checkpoint bit for bit.
* The eval CLI in 2 processes at `--eval_batch 1` prints the metrics of the
  1-process run (rtol 1e-6) and dumps the same poses in the same order,
  with both ranks holding frames and with rank 1 holding none.
* Launch values that do not fit are usage errors before anything is
  written: `--num_processes` 0, a `--process_id` outside the world, nccl on
  the CPU, a launch flag without `--multihost`.
"""
import json
import math
import os
import socket
import sys

import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import _torch_port_linemod_common as L
from rnnpose_tpu_torch.parallel import mesh
from rnnpose_tpu_torch.tools.eval import main as eval_main
from rnnpose_tpu_torch.tools.train import main as train_main
from rnnpose_tpu_torch.train import checkpoint as ckpt

SMALL = ["--synthetic", "--syn_image_size", "64", "--syn_zoom", "32", "--device", "cpu"]
RUN_FILES = {"checkpoints.json", "config_resolved.yml", "log.txt", "log.json.lst", "summary"}


def _launch(tool, n, args):
    return lambda r, addr: [sys.executable, "-m", f"rnnpose_tpu_torch.tools.{tool}"] + args + [
        "--multihost", "--coordinator_address", addr, "--num_processes", str(n),
        "--process_id", str(r)]


def _run(argv_of, log_dir, n=2):
    """n ranks of one process group on the CPU, one thread each, under one
    time limit; their outputs."""
    return mesh.launch_local(argv_of, n, str(log_dir), 300, env={"OMP_NUM_THREADS": "1"})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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


def _latest(run):
    return ckpt.restore_checkpoint(ckpt.latest_checkpoint(run))


def test_synthetic_two_processes_equal_one_process_bitwise(tmp_path):
    common = SMALL + ["--steps", "2", "--display_step", "1"]
    two, one = str(tmp_path / "two"), str(tmp_path / "one")
    outs = _run(_launch("train", 2, common + ["--model_dir", two]), tmp_path)
    train_main(common + ["--model_dir", one])
    a, b = _latest(two), _latest(one)
    assert a["step"] == 2
    _assert_equal(a, b, "checkpoint")
    strip = ("steps_per_sec",)
    assert ([{k: v for k, v in r.items() if k not in strip} for r in _rows(two)]
            == [{k: v for k, v in r.items() if k not in strip} for r in _rows(one)])
    with open(os.path.join(two, "log.txt")) as f:
        assert "2 processes over gloo" in f.read()
    assert "step 1:" in outs[0] and "step 1:" not in outs[1]  # rank 0 alone logs


def test_world_of_one_is_the_run_without_multihost(tmp_path):
    common = SMALL + ["--steps", "2", "--display_step", "1"]
    one, plain = str(tmp_path / "one"), str(tmp_path / "plain")
    train_main(common + ["--model_dir", one, "--multihost", "--coordinator_address",
                         f"127.0.0.1:{_free_port()}", "--num_processes", "1",
                         "--process_id", "0"])
    assert not torch.distributed.is_initialized()  # the CLI leaves its group
    train_main(common + ["--model_dir", plain])
    _assert_equal(_latest(one), _latest(plain), "checkpoint")


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    return L.write_train_fixture(tmp_path_factory.mktemp("mh_lm"))


def test_dataset_shards_read_disjoint_positions(cfg_path):
    from rnnpose_tpu_torch.config.defaults import build_dataset, build_model_config, default_config
    from rnnpose_tpu_torch.data.samplers import GivenIterationSampler
    from rnnpose_tpu_torch.tools.train import dataset_batches
    from rnnpose_tpu_torch.utils.config_io import merge_cfg

    cfg = merge_cfg([cfg_path], defaults=default_config())
    ds = build_dataset(cfg, build_model_config(cfg).desc_kp, is_train=True)
    steps = cfg["train_config"]["steps"]
    seen = {}
    sample_at = ds.sample_at

    def record(idx, pos):
        seen.setdefault(shard, []).append((pos, idx))
        return sample_at(idx, pos)

    ds.sample_at = record
    images = {}
    for shard in (0, 1):
        for last_iter in (-1, 0):  # from the start, and resumed after step 1
            batches = list(dataset_batches(ds, cfg, last_iter, 0, "cpu", shard_id=shard,
                                           num_shards=2))
            assert len(batches) == steps - last_iter - 1
        images[shard] = batches[0].image
    for shard in (0, 1):
        order = GivenIterationSampler(len(ds), total_iter=steps, batch_size=1, shard_id=shard,
                                      num_shards=2).indices.tolist()
        want = [(k * 2 + shard, order[k]) for k in range(steps)]
        assert seen[shard] == want + want[1:]
    assert not {p for p, _ in seen[0]} & {p for p, _ in seen[1]}
    assert not torch.equal(images[0], images[1])


def test_two_process_linemod_run_resumes_bitwise_and_rank0_writes(cfg_path, tmp_path):
    common = ["--config_path", cfg_path, "--device", "cpu", "--display_step", "1",
              "--loader_threads", "0"]
    run_a, run_b = str(tmp_path / "a"), str(tmp_path / "b")
    outs = _run(_launch("train", 2, common + ["--model_dir", run_a, "--eval_frames", "1"]),
                tmp_path)
    stop = common + ["--model_dir", run_b, "--eval_frames", "0"]
    _run(_launch("train", 2, stop + ["--stop_after", "2"]), tmp_path)
    assert _latest(run_b)["step"] == 2
    _run(_launch("train", 2, stop + ["--resume"]), tmp_path)
    a, b = _latest(run_a), _latest(run_b)
    assert a["step"] == b["step"] == 3
    _assert_equal(a, b, "checkpoint")

    assert set(os.listdir(run_a)) == RUN_FILES | {"rnnpose-2", "rnnpose-3"}
    rows = _rows(run_a)
    steps = [r for r in rows if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(r["skipped_nonfinite"] == 0.0 and math.isfinite(r["loss"]) for r in steps)
    evals = [r for r in rows if "eval/params_l1" in r]
    assert [r["step"] for r in evals] == [2, 3]
    # One eval frame over 2 ranks: rank 1 evaluates none and still takes part.
    assert all(r["eval/seq_len"] == 1 and math.isfinite(r["eval/add_dist"]) for r in evals)
    assert "step 1:" in outs[0] and "step 1:" not in outs[1]
    with open(os.path.join(run_b, "log.txt")) as f:
        assert "restored checkpoint at step 2" in f.read()


EVAL_RANK = ("import json, sys\n"
             "from rnnpose_tpu_torch.tools.eval import main\n"
             "print('OVERALL ' + json.dumps(main(sys.argv[1:])))\n")


@pytest.mark.parametrize("max_frames", [None, 1], ids=["two_frames", "rank1_without_frames"])
def test_eval_cli_two_processes_match_one_process(cfg_path, tmp_path, max_frames):
    common = ["--config_path", cfg_path, "--device", "cpu", "--eval_batch", "1"]
    if max_frames:
        common += ["--max_frames", str(max_frames)]
    dump1, dump2 = str(tmp_path / "one"), str(tmp_path / "two")
    one = eval_main(common + ["--dump_poses", dump1])
    # The CLI's `main` in each rank, its return value at full precision
    # (the printed summary is rounded to 5 decimals).
    launch = _launch("eval", 2, common + ["--dump_poses", dump2])
    outs = _run(lambda r, addr: [sys.executable, "-c", EVAL_RANK] + launch(r, addr)[3:],
                tmp_path)
    assert "=== overall" in outs[0] and "=== overall" not in outs[1]  # rank 0 alone prints
    # Each rank's own timing of its own frames (none on a rank without).
    local = {"fps", "forward_ms", "host_read_ms", "host_collate_ms"}
    for out in outs:
        two = json.loads(out.split("OVERALL ", 1)[1].splitlines()[0])
        assert set(two) - local == set(one) - local
        for k in set(one) - local:
            np.testing.assert_allclose(two[k], one[k], rtol=1e-6, err_msg=k)
    assert two["seq_len"] == one["seq_len"] == (max_frames or 2)
    p1 = np.load(os.path.join(dump1, "cat_pose_preds.npy"))
    p2 = np.load(os.path.join(dump2, "cat_pose_preds.npy"))
    assert p1.shape == (max_frames or 2, 4, 4)
    np.testing.assert_allclose(p2, p1, rtol=0, atol=1e-6)


BAD_LAUNCHES = {
    "zero_processes": ["--multihost", "--coordinator_address", "127.0.0.1:1",
                       "--num_processes", "0", "--process_id", "0"],
    "negative_process_id": ["--multihost", "--coordinator_address", "127.0.0.1:1",
                            "--num_processes", "2", "--process_id", "-1"],
    "process_id_outside": ["--multihost", "--coordinator_address", "127.0.0.1:1",
                           "--num_processes", "2", "--process_id", "2"],
    "address_without_world": ["--multihost", "--coordinator_address", "127.0.0.1:1"],
    "nccl_on_cpu": ["--multihost", "--dist_backend", "nccl"],
    "flag_without_multihost": ["--num_processes", "2"],
}


@pytest.mark.parametrize("tool", ["train", "eval"])
@pytest.mark.parametrize("bad", list(BAD_LAUNCHES))
def test_bad_launch_values_are_refused_before_writing(tmp_path, tool, bad):
    run = tmp_path / "run"
    args = ["--device", "cpu"] + BAD_LAUNCHES[bad]
    with pytest.raises(SystemExit):
        if tool == "train":
            train_main(SMALL + ["--model_dir", str(run)] + args)
        else:
            eval_main(["--synthetic", "--dump_poses", str(run)] + args)
    assert not run.exists()
