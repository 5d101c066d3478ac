"""Faults of the port, each held repaired.

* The CLIs take no iteration value <= 0: `tools/train.py` with `--steps`,
  `--display_step` or `--stop_after` at 0 or below, and `tools/eval.py` with
  `--render_iters`, `--gru_iters`, `--max_frames`, `--eval_batch` or
  `--icp_iters` at 0 or below, exit with a usage error before anything is
  written (the JAX CLIs read 0 as "unset" or divide by it). Without a card
  the eval CLI's default device raises, naming `--device cpu`.
* The native host ops build from the port's own copy of the C++ source,
  byte-identical to the JAX package's, with `rnnpose_tpu/` absent.
* The correlation lookup reads 0 from a pyramid level pooled to zero size
  (a 4 x 4 grid, the 32^2 crop, at the default 4 levels), as the JAX
  package does; it raised IndexError before.
(The raster tile repair is in tests/test_torch_port_raster_tiles.py.)
"""
import filecmp
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from rnnpose_tpu_torch.cpp import native
from rnnpose_tpu_torch.tools.eval import main as eval_main
from rnnpose_tpu_torch.tools.train import main as train_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--synthetic", "--syn_image_size", "64", "--syn_zoom", "32", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--steps", "0", "--stop_after", "1"],
    ["--steps", "-1"],
    ["--steps", "2", "--display_step", "0"],
    ["--steps", "2", "--stop_after", "0"],
])
def test_train_cli_rejects_non_positive_iteration_flags(flags, tmp_path, capsys):
    run = tmp_path / "run"
    with pytest.raises(SystemExit) as exc:
        train_main(SMALL + flags + ["--model_dir", str(run)])
    assert exc.value.code != 0
    assert "must be a positive int" in capsys.readouterr().err
    assert not run.exists()


@pytest.mark.parametrize("flag", ["--render_iters", "--gru_iters", "--max_frames",
                                  "--eval_batch", "--icp_iters"])
@pytest.mark.parametrize("value", ["0", "-2"])
def test_eval_cli_rejects_non_positive_iteration_flags(flag, value, tmp_path, capsys):
    dump = tmp_path / "dump"
    with pytest.raises(SystemExit) as exc:
        eval_main(SMALL + [flag, value, "--dump_poses", str(dump)])
    assert exc.value.code != 0
    assert "must be a positive int" in capsys.readouterr().err
    assert not dump.exists()


def test_eval_cli_without_a_card_raises_unless_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        eval_main(["--synthetic"])


def test_native_source_is_the_ports_own_copy(tmp_path):
    jax_source = os.path.join(REPO, "rnnpose_tpu", "cpp", "native_ops.cpp")
    assert str(native.SOURCE.resolve()) == os.path.join(REPO, "rnnpose_tpu_torch", "csrc",
                                                        "native_ops.cpp")
    assert filecmp.cmp(native.SOURCE, jax_source, shallow=False), (
        "rnnpose_tpu_torch/csrc/native_ops.cpp and rnnpose_tpu/cpp/native_ops.cpp differ")
    # A tree with the port alone builds and runs the native ops.
    shutil.copytree(os.path.join(REPO, "rnnpose_tpu_torch"), tmp_path / "rnnpose_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = textwrap.dedent("""
        import numpy as np
        from rnnpose_tpu_torch.cpp import native
        assert native.available()
        pts = np.random.RandomState(0).rand(200, 3).astype(np.float32)
        sub = native.grid_subsample(pts, 0.3)
        nb = native.radius_neighbors(sub, pts, 0.2, 8)
        assert 1 <= len(sub) <= 64 and nb.shape == (len(sub), 8)
        print("NATIVE_OK", native.SOURCE)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NATIVE_OK" in res.stdout and str(tmp_path) in res.stdout


def test_corr_lookup_with_an_empty_level_matches_jax():
    import jax.numpy as jnp
    import numpy as np

    from rnnpose_tpu.ops import corr as jcorr
    from rnnpose_tpu_torch.ops import corr as tcorr

    rs = np.random.RandomState(0)
    f1, f2 = (rs.randn(2, 4, 4, 16).astype(np.float32) for _ in range(2))
    coords = (rs.rand(2, 4, 4, 2) * 4).astype(np.float32)
    pyr_t = tcorr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    assert [lv.shape[-1] for lv in pyr_t.levels] == [4, 2, 1, 0]
    out_t = tcorr.corr_lookup(pyr_t, torch.from_numpy(coords), 4).numpy()
    out_j = np.asarray(jcorr.corr_lookup(
        jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4), jnp.asarray(coords), 4))
    assert out_t.shape == out_j.shape == (2, 4, 4, 4 * 81)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    assert not out_t[..., 243:].any()
