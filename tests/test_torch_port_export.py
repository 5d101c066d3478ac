"""The serving export of the port: the `kernels` package's `torch.library`
operators, `utils/export` and `tools/export_model`, against the JAX package.

* Each `rnnpose::` operator (the five raster sweeps, the LM step, the
  correlation lookup and the instance norm) passes `torch.library.opcheck` on CPU tensors (schema, fake
  implementation, dispatch); its CPU result is the plain version's bit for
  bit, and its fake outputs have the real ones' shapes and dtypes.
* The `__graft_entry__._tiny_setup` scene at B=1, f32, render_iters=1, with
  the JAX params carried across by `load_jax_params`: the reloaded bundle's
  `Ti_pred` equals the port's direct cached forward (atol 1e-6) and agrees
  with JAX's `model.apply(..., cached_desc3d=, cached_ctx3d=)` within 1e-3
  (the bound of test_torch_port_engine.py); the graph holds exactly
  render_iters `rnnpose::zbuffer_sweep_rows_attrs` nodes, one
  `rnnpose::lm_step` node per LM step, one `rnnpose::corr_lookup` node
  per render and GRU iteration, and one `rnnpose::instance_norm` node per
  norm (15 a render iteration, 3 in SuperPoint's tail).
* The new pose is not ignored: a perturbed `T_init` moves the output, which
  equals the direct forward at that `T_init` (1e-6); the `T_init`
  placeholder has users.
* Weights are leaves: the program holds no parameter, and fed a second set
  of weights it equals a model loaded with them (1e-6); the manifest has one
  path per leaf.
* A consumer process with `rnnpose_tpu`, `rnnpose_tpu_torch`, `jax` and
  `flax` blocked runs the CPU bundle of the CLI and reproduces the saved
  expected output (1e-6), as tests/test_export.py does for the JAX artifact.
* The CLI: `--platform cpu --selftest` at a tiny size (1e-5), `--parity`
  exports `zbuffer_sweep_tiled` nodes and no rows-attrs node, values <= 0
  and `--platform cuda` without a card are refused before anything is
  written; a bundle one of whose module copies (the `kernels/` files and
  `bundle.py`) differs is refused at load, and so is a `cuda` bundle made without TF32 while TF32
  is on.
"""
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_port_common as C
from rnnpose_tpu_torch.models.convert import load_jax_params
from rnnpose_tpu_torch.models.kpconv_net import KPConvConfig
from rnnpose_tpu_torch.models.refiner import RefinerConfig
from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig
from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.kernels import corr as corr_kernel
from rnnpose_tpu_torch.kernels import lm as lm_kernel
from rnnpose_tpu_torch.kernels import norm as norm_kernel
from rnnpose_tpu_torch.kernels import raster as rk
from rnnpose_tpu_torch.tools import export_model
from rnnpose_tpu_torch.utils import bundle as bundle_fmt
from rnnpose_tpu_torch.utils import export as ex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_FILES = sorted(Path(kernels.__file__).parent.glob("*.py"))
SERVE_BUNDLE = os.path.join(REPO, "rnnpose_tpu_torch", "tools", "serve_bundle.py")
# The CLI at a tiny size (64^2 image, 128/256 mesh, 48^2 crop, one render
# and one GRU iteration).
CLI_TINY = ["--platform", "cpu", "--image_size", "64", "--verts", "128", "--faces", "256",
            "--zoom", "48", "--render_iters", "1", "--gru_iters", "1", "--corr_levels", "2",
            "--raster_chunk", "64"]


def _sweep_case(B=2, F=64, size=32, D=6, seed=0):
    """Random triangles as sweep rows (chip_smoke's `_tri_rows` layout) with
    their vertex bboxes and corner attributes."""
    from chip_smoke import _tri_rows

    rs = np.random.RandomState(seed)
    P = rs.uniform(-2.0, size + 2.0, (B * F, 3, 2))
    P = P.mean(1, keepdims=True) + (P - P.mean(1, keepdims=True)) * 0.3
    rows = _tri_rows(P, rs.uniform(0.5, 1.0, (B * F, 3)))
    rows[rs.rand(B * F) < 0.1, 12] = 0.0   # some invalid faces
    fd = torch.from_numpy(rows).reshape(B, F, 16)
    bb = torch.from_numpy(np.concatenate([P.min(1), P.max(1)], -1).astype(np.float32))
    bb = bb.reshape(B, F, 4)
    ca = torch.from_numpy(rs.randn(B, F, 3, D).astype(np.float32))
    return fd, bb, ca, size


def _op_cases():
    from chip_smoke import corr_problem, stereo_lookup_problem

    fd, bb, ca, s = _sweep_case()
    lm_args = _lm_case()
    lv, coords = corr_problem(2, 6, 9, "out_of_range", device="cpu")
    lv1, coords1 = stereo_lookup_problem(2, 6, 20, "out_of_range", device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, 7, 9).astype(np.float32))
    x = x.to(torch.bfloat16, memory_format=torch.channels_last)
    return {  # operator -> (its arguments, the plain version's output)
        "zbuffer_sweep_rows_attrs": (
            (fd, bb, ca, s, s, 32, 16), rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, s, s, 32, 16)),
        "zbuffer_sweep_tiled_attrs_batched": (
            (fd, bb, ca, s, s, 32, 16), rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, s, s, 32, 16)),
        "zbuffer_sweep_tiled_attrs": (
            (fd[0], bb[0], ca[0], s, s, 32, 8),
            rk.zbuffer_sweep_tiled_attrs_plain(fd[0], bb[0], ca[0], s, s, 32, 8)),
        "zbuffer_sweep_tiled": (
            (fd, bb, s, s, 32, 16), rk.zbuffer_sweep_tiled_plain(fd, bb, s, s, 32, 16)),
        "zbuffer_sweep": ((fd, s, s, 32), rk.zbuffer_sweep_tiled_plain(fd, None, s, s, 32)),
        "lm_step": (lm_args, (lm_kernel.lm_step_plain(*lm_args),)),
        "corr_lookup": ((lv, coords, 4), (corr_kernel.corr_lookup_plain(lv, coords, 4),)),
        "instance_norm": ((x, 1e-5, True), (norm_kernel.instance_norm_plain(x, 1e-5, True),)),
        "corr_lookup_1d": ((lv1, coords1, 4),
                           (corr_kernel.corr_lookup_1d_plain(lv1, coords1, 4),)),
    }


def _lm_case(B=2, h=6, w=6, seed=0):
    """A seeded LM step: poses near the identity, depth, targets near the
    pixel grid, weights, intrinsics, and `LMConfig`'s constants."""
    rs = np.random.RandomState(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, 3] = rs.randn(B, 3) * 0.01
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h), indexing="xy"), -1)
    target = grid[None] + rs.randn(B, h, w, 2) * 0.5
    arrays = [T, target, rs.rand(B, h, w, 2), rs.uniform(0.4, 0.7, (B, h, w)),
              np.tile([[60.0, 60.0, w / 2.0, h / 2.0]], (B, 1))]
    return tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in arrays) + (
        1e-4, 100.0, 1.0, 0.1)


def _sha256(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _outputs(x):
    return x if isinstance(x, (tuple, list)) else (x,)


@pytest.mark.parametrize("name", sorted(kernels.OPERATORS))
def test_operator_opcheck_plain_and_fake(name):
    args, plain = _op_cases()[name]
    op = getattr(torch.ops.rnnpose, name).default
    torch.library.opcheck(op, args)
    got = _outputs(op(*args))
    assert len(got) == len(plain)
    for g, p in zip(got, plain):
        assert g.dtype == p.dtype and torch.equal(g, p)   # bit for bit
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = _outputs(op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                             else [mode.from_tensor(t) for t in a] if isinstance(a, list)
                             else a for a in args)))
    assert [(tuple(f.shape), f.dtype) for f in fake] == [(tuple(p.shape), p.dtype) for p in plain]
    # The wrapper calls the operator and counts no launch on the CPU.
    before = kernels.LAUNCHES[name]
    wrapper = next(getattr(m, name) for m in (rk, lm_kernel, corr_kernel, norm_kernel)
                   if hasattr(m, name))
    out = _outputs(wrapper(*args))
    assert all(torch.equal(o, p) for o, p in zip(out, plain))
    assert kernels.LAUNCHES[name] == before


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The `_tiny_setup` scene at B=1, f32, one render iteration: the JAX
    model and its cached-forward Ti_pred, the port model with the same
    weights, its inputs and cached features, and its exported bundle,
    reloaded."""
    from __graft_entry__ import _tiny_setup
    from rnnpose_tpu.models.rnnpose import RNNPose as JRNNPose

    jmodel, jinputs = _tiny_setup(batch_size=1, train=False, render_iters=1)
    jcfg = dataclasses.replace(jmodel.cfg, refiner=dataclasses.replace(
        jmodel.cfg.refiner, mixed_precision=False))
    jmodel = JRNNPose(jcfg)
    d3, c3 = C.cached_3d(1, jinputs.mesh.verts.shape[0])
    params = jax.device_get(jax.jit(lambda k: jmodel.init(
        k, jinputs, train=False, cached_desc3d=d3, cached_ctx3d=c3))(jax.random.PRNGKey(0)))
    T_jax = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        p, x, train=False, cached_desc3d=d3, cached_ctx3d=c3)["Ti_pred"])(params, jinputs))
    cfg = RNNPoseConfig(
        desc_kp=KPConvConfig(**dataclasses.asdict(jcfg.desc_kp)),
        ctx_kp=KPConvConfig(**dataclasses.asdict(jcfg.ctx_kp)),
        refiner=RefinerConfig(**dataclasses.asdict(jcfg.refiner)),
    )
    model = load_jax_params(RNNPose(cfg), params).eval()
    inputs = C.port_inputs(jinputs)
    desc3d, ctx3d = torch.from_numpy(d3), torch.from_numpy(c3)
    exported = ex.export_eval_forward(model, inputs, desc3d, ctx3d)
    bundle = str(tmp_path_factory.mktemp("export") / "bundle")
    manifest = ex.save_exported(exported, bundle,
                                ex.serving_leaf_paths(model, inputs, desc3d, ctx3d))
    program, loaded = ex.load_exported(bundle)
    return dict(T_jax=T_jax, model=model, inputs=inputs, desc3d=desc3d, ctx3d=ctx3d,
                exported=exported, bundle=bundle, manifest=manifest, program=program,
                loaded_manifest=loaded, run=program.module())


def _nodes(t):
    """The operator nodes of the tiny scene's program: one raster sweep per
    render iteration, one LM step per render and GRU iteration and LM step,
    one lookup per render and GRU iteration, 15 instance norms per render
    iteration (the feature encoder) and 3 for SuperPoint's tail."""
    cfg = t["model"].cfg.refiner
    return {"zbuffer_sweep_rows_attrs": cfg.render_iters,
            "lm_step": cfg.render_iters * cfg.gru_iters * cfg.optim_iters,
            "corr_lookup": cfg.render_iters * cfg.gru_iters,
            "instance_norm": 15 * cfg.render_iters + 3}


def _direct(t, T_init=None, model=None):
    inputs = t["inputs"] if T_init is None else t["inputs"]._replace(T_init=T_init)
    return (model or t["model"])(inputs, cached_desc3d=t["desc3d"],
                                 cached_ctx3d=t["ctx3d"])["Ti_pred"]


def _leaves(t, model=None):
    return ex.serving_args(model or t["model"], t["inputs"], t["desc3d"], t["ctx3d"])


def test_export_matches_direct_forward_and_jax(tiny):
    got = tiny["run"](tiny["inputs"].T_init, *_leaves(tiny))
    np.testing.assert_allclose(got.numpy(), _direct(tiny).numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), tiny["T_jax"], atol=1e-3)
    assert np.abs(got.numpy() - tiny["inputs"].T_init.numpy()).max() > 1e-3  # it refined
    assert ex.operator_nodes(tiny["exported"]) == _nodes(tiny)
    assert ex.operator_nodes(tiny["program"]) == _nodes(tiny)
    structured = ex.call_exported(tiny["run"], tiny["model"], tiny["inputs"], tiny["desc3d"],
                                  tiny["ctx3d"], tiny["inputs"].T_init)
    assert torch.equal(structured, got)


def test_new_pose_is_not_ignored(tiny):
    program = tiny["program"]
    t_init = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.name == t_init)
    assert len(node.users) > 0
    rs = np.random.RandomState(0)
    T2 = tiny["inputs"].T_init + torch.from_numpy(rs.randn(1, 4, 4).astype(np.float32) * 1e-3)
    T2[:, 3] = torch.tensor([0.0, 0.0, 0.0, 1.0])
    got = tiny["run"](tiny["inputs"].T_init, *_leaves(tiny))
    got2 = tiny["run"](T2, *_leaves(tiny))
    assert (got2 - got).abs().max() > 1e-4
    np.testing.assert_allclose(got2.numpy(), _direct(tiny, T2).numpy(), atol=1e-6)


def test_weights_are_leaves(tiny):
    assert len(tiny["program"].state_dict) == 0 and len(tiny["program"].constants) < 8
    assert all(t.numel() < 1024 for t in tiny["program"].constants.values())
    other = RNNPose(tiny["model"].cfg)
    other.load_state_dict(tiny["model"].state_dict())
    with torch.no_grad():
        for name, p in other.named_parameters():
            if name.startswith("motion_net") and p.dim() >= 2:
                p.mul_(0.5)
    other.eval()
    got = tiny["run"](tiny["inputs"].T_init, *_leaves(tiny, other))
    want = _direct(tiny, model=other)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert (want - _direct(tiny)).abs().max() > 1e-4   # the weights mattered
    paths = [leaf["path"] for leaf in tiny["manifest"]["leaves"]]
    assert paths == ex.serving_leaf_paths(tiny["model"], tiny["inputs"], tiny["desc3d"],
                                          tiny["ctx3d"])
    assert len(paths) == len(_leaves(tiny)) == len(set(paths))
    n_state = len(tiny["model"].state_dict())
    assert paths[:n_state] == ["params." + k for k in tiny["model"].state_dict()]
    assert paths[-2:] == ["desc3d", "ctx3d"]
    assert "inputs.T_init" not in paths and not any("pyramid" in p for p in paths)


def test_manifest_records_the_bundle(tiny):
    m = tiny["loaded_manifest"]
    assert m == tiny["manifest"]
    assert m["signature"] == "(T_init, *leaves) -> Ti_pred" and m["device"] == "cpu"
    assert m["torch"] == torch.__version__ and m["tf32"] is False
    assert m["raster"] == {"grid": "rows", "tile": None, "branch": "fused"}
    assert m["operators"] == {"namespace": "rnnpose", "libraries": {}, "nodes": _nodes(tiny)}
    assert m["T_init"] == {"shape": [1, 4, 4], "dtype": "float32"}
    leaves = _leaves(tiny)
    assert [leaf["shape"] for leaf in m["leaves"]] == [list(t.shape) for t in leaves]
    assert [leaf["dtype"] for leaf in m["leaves"]] == [str(t.dtype)[6:] for t in leaves]
    copies = {f"kernels/{p.name}": p for p in KERNEL_FILES}
    assert m["modules"] == {"operators": {name: _sha256(p) for name, p in copies.items()},
                            "format": {"bundle.py": _sha256(bundle_fmt.__file__)}}
    for name, original in dict(copies, **{"bundle.py": Path(bundle_fmt.__file__)}).items():
        assert (Path(tiny["bundle"]) / name).read_bytes() == original.read_bytes()  # byte for byte
    assert sorted(os.listdir(tiny["bundle"])) == ["bundle.py", "kernels", "manifest.json",
                                                  "model.pt2"]
    assert sorted(os.listdir(os.path.join(tiny["bundle"], "kernels"))) == sorted(
        p.name for p in KERNEL_FILES)
    assert m["bytes"] == os.path.getsize(os.path.join(tiny["bundle"], "model.pt2"))


@pytest.mark.parametrize("module", ["bundle.py"] + [f"kernels/{p.name}" for p in KERNEL_FILES])
def test_bundle_with_another_module_copy_is_refused(tiny, tmp_path, module):
    copy = str(tmp_path / "bundle")
    shutil.copytree(tiny["bundle"], copy)
    with open(os.path.join(copy, module), "a") as f:
        f.write("\n# edited\n")
    with pytest.raises(RuntimeError, match="differs"):
        ex.load_exported(copy)


def test_cuda_bundle_is_refused_while_tf32_is_on(tiny, tmp_path, monkeypatch):
    """The artifact does not carry the forward's TF32 switch: its manifest
    does, and the loader holds the process to it instead of setting it."""
    copy = tmp_path / "bundle"
    shutil.copytree(tiny["bundle"], copy)
    manifest = json.loads((copy / "manifest.json").read_text())
    (copy / "manifest.json").write_text(json.dumps(dict(manifest, device="cuda")))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="without TF32"):
        ex.load_exported(str(copy))
    assert torch.backends.cudnn.allow_tf32   # checked, not set
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    program, loaded = ex.load_exported(str(copy))
    assert loaded["device"] == "cuda" and bundle_fmt.operator_nodes(
        program, "rnnpose") == _nodes(tiny)


@pytest.fixture(scope="module")
def cli_bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    out, example = str(root / "bundle"), str(root / "example.pt")
    manifest, summary = export_model.main(["--out", out, "--selftest", "--save_example",
                                           example] + CLI_TINY)
    return out, example, manifest, summary


def test_cli_selftest(cli_bundle):
    out, example, manifest, summary = cli_bundle
    assert summary["selftest_max_abs_diff"] < export_model.SELFTEST_TOL
    assert manifest["device"] == "cpu" and manifest["batch"] == 1
    assert summary["operator_nodes"] == {"zbuffer_sweep_rows_attrs": 1, "lm_step": 1,
                                         "corr_lookup": 1, "instance_norm": 18}
    assert not any(summary["artifact_launches"].values())   # the CPU: plain versions
    data = torch.load(example, weights_only=True)   # torch alone reads it
    leaves, expected = data["leaves"], data["expected"]
    assert data["T_init"].shape == (1, 4, 4)
    assert len(leaves) == len(manifest["leaves"]) and expected.shape == (1, 4, 4)
    assert [list(t.shape) for t in leaves] == [leaf["shape"] for leaf in manifest["leaves"]]


def test_standalone_consumer_runs_the_cli_bundle(cli_bundle):
    out, example, _, _ = cli_bundle
    proc = subprocess.run([sys.executable, SERVE_BUNDLE, out, example, "--device", "cpu"],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["max_abs_diff"] <= 1e-6 and result["finite"] and not result["leaked"]
    assert result["shape"] == [1, 4, 4] and result["manifest_device"] == "cpu"


def test_cli_parity_exports_the_culled_sweep(tmp_path):
    out = str(tmp_path / "parity")
    manifest, summary = export_model.main(["--out", out, "--parity"] + CLI_TINY)
    assert summary["operator_nodes"] == {"zbuffer_sweep_tiled": 1, "lm_step": 1,
                                         "corr_lookup": 1, "instance_norm": 18}
    assert manifest["raster"]["branch"] == "unfused" and manifest["parity"]
    assert os.path.exists(os.path.join(out, "model.pt2"))


@pytest.mark.parametrize("flag,value", [("--batch", "0"), ("--image_size", "-64"),
                                        ("--zoom", "0"), ("--render_iters", "0"),
                                        ("--gru_iters", "-1"), ("--raster_chunk", "0")])
def test_cli_refuses_non_positive_values_before_writing(tmp_path, flag, value):
    out = tmp_path / "never"
    with pytest.raises(SystemExit):
        export_model.main(["--out", str(out), "--platform", "cpu", flag, value])
    assert not out.exists()


def test_cli_cuda_without_a_card_raises_before_writing(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main(["--out", str(out)])
    assert not out.exists()


def test_a_second_copy_of_the_operator_module_defers_to_the_first(tiny):
    copy = bundle_fmt.load_ops(tiny["bundle"])
    assert copy.__name__ != kernels.__name__ and copy.raster is not rk
    assert kernels.REGISTERED and not copy.REGISTERED and copy.LIBRARY is None
    args, plain = _op_cases()["zbuffer_sweep_tiled"]
    assert all(torch.equal(a, b) for a, b in zip(copy.raster.zbuffer_sweep_tiled(*args), plain))
    with pytest.raises(RuntimeError, match="registered by another copy"):
        bundle_fmt.load(tiny["bundle"], copy)
