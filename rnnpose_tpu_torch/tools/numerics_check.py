"""Cross-device numerics: the card against exact-f32 CPU (port of
`rnnpose_tpu/tools/numerics_check.py`).

The JAX tool exists because TPU f32 contractions silently ran as bf16. On
an NVIDIA card the same risk is TF32 (`torch.backends.cuda.matmul.allow_tf32`,
`torch.backends.cudnn.allow_tf32`) or a cuBLAS/cuDNN path that rounds
differently. This tool runs identical seeded inputs through the
pose-critical ops on `--device` and on the CPU and reports the max
|difference| of each against its tolerance (the JAX tool's list and
tolerances): se3 expm, logm(expm), inverse and increment; compose +
transform; `pose_transform_coords`; the LM `reprojection_optim`; ADD and
ADD-S; `rasterize` of 1024 faces at 128^2 (the culled z/fid kernel on the
card); the fused raster + attrs (the rows-attrs kernel); with `--full` the
f32 eval forward's `Ti_pred` at 2 x 2 iterations and a 64^2 crop (seeded
random weights). It prints both TF32 flags before and after, sets none of
them (the forward turns TF32 off itself), and exits 1 on any FAIL.

Usage:
  python -m rnnpose_tpu_torch.tools.numerics_check [--full] [--tol_pose 5e-6]
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json


def _tf32_flags():
    import torch

    return {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


def _to(x, device):
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    if isinstance(x, torch.nn.Module):
        return copy.deepcopy(x).to(device)
    if hasattr(x, "to"):  # the point pyramid
        return x.to(device)
    return x


def _leaves(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x.detach().float().cpu()]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def main(argv=None):
    p = argparse.ArgumentParser(description="device against exact-f32 CPU numerics")
    p.add_argument("--full", action="store_true", help="also compare the f32 eval forward")
    p.add_argument("--tol_pose", type=float, default=5e-6,
                   help="abs tolerance of the pose-critical ops (meters/units)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device under test (default: cuda; cpu runs the CPU against itself)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..eval import metrics as M
    from ..geometry import lm as lm_lib
    from ..geometry import projective as proj
    from ..geometry import se3 as se3_lib

    dev, ref = torch.device(args.device), torch.device("cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {dev}: no CUDA device is visible; pass --device cpu "
                           "to compare the CPU with itself")
    flags_before = _tf32_flags()
    print(f"TF32 flags: {flags_before}", flush=True)
    rs = np.random.RandomState(0)
    results, failures = {}, []

    def check(name, fn, *a, tol=None):
        tol = args.tol_pose if tol is None else tol
        with torch.no_grad():
            out_ref = _leaves(fn(*_to(a, ref)))
            out = _leaves(fn(*_to(a, dev)))
        err = max(float((r - o).abs().max()) for r, o in zip(out_ref, out))
        ok = err <= tol
        print(f"{'OK ' if ok else 'FAIL'} {name:40s} max|{dev.type}-{ref.type}| = {err:.3e} "
              f"(tol {tol:g})", flush=True)
        results[name] = {"max_abs": err, "tol": tol, "ok": ok}
        if not ok:
            failures.append(name)

    t = torch.from_numpy
    xi = (rs.randn(8, 6) * 0.4).astype(np.float32)
    T = se3_lib.se3_expm(t(xi))
    T2 = se3_lib.se3_expm(t(rs.randn(8, 6).astype(np.float32) * 0.3))
    X = t((rs.randn(8, 500, 3) * 0.1 + np.array([0, 0, 0.6])).astype(np.float32))
    K = t(np.tile(np.array([[280.0, 280.0, 120.0, 120.0]], np.float32), (8, 1)))
    depth = t((rs.rand(8, 32, 32) * 0.4 + 0.4).astype(np.float32))
    tgt = t((rs.rand(8, 32, 32, 2) * 32).astype(np.float32))
    wgt = t(rs.rand(8, 32, 32, 2).astype(np.float32))
    eye8 = torch.eye(4).expand(8, 4, 4).contiguous()

    check("se3_expm", se3_lib.se3_expm, t(xi))
    check("se3_logm(expm)", lambda x: se3_lib.se3_logm(se3_lib.se3_expm(x)), t(xi))
    check("se3_inverse", se3_lib.se3_inverse, T)
    check("se3_increment (expm @ T)", se3_lib.se3_increment, T, t(xi * 0.01))
    check("compose+transform_points",
          lambda a, b, x: proj.transform_points(
              se3_lib.se3_increment(a, torch.zeros(8, 6, device=a.device)), x)
          + proj.transform_points(b, x), T, T2, X)
    check("pose_transform_coords",
          lambda tt, d, k: lm_lib.pose_transform_coords(tt, d, k)[0],
          eye8, depth, K, tol=1e-4)
    check("LM reprojection_optim",
          lambda tt, tg, w, d, k: lm_lib.reprojection_optim(tt, tg, w, d, k, 2),
          eye8, tgt, wgt, depth, K, tol=1e-4)

    pts = t((rs.randn(4, 300, 3) * 0.05).astype(np.float32))
    check("ADD metric", lambda a, b, q: M.add_error(a[:, :3, :3], a[:, :3, 3], b[:, :3, :3],
                                                    b[:, :3, 3], q), T[:4], T2[:4], pts,
          tol=1e-5)
    check("ADD-S metric", lambda a, b, q: M.adds_error(a[:, :3, :3], a[:, :3, 3],
                                                       b[:, :3, :3], b[:, :3, 3], q),
          T[:4], T2[:4], pts, tol=1e-5)

    from ..data.synthetic import SyntheticConfig, kpconv_config, make_synthetic_inputs
    from ..render.raster import rasterize, rasterize_with_vis_attrs

    syn = SyntheticConfig(image_size=128, num_verts=512, num_faces=1024, subdivisions=3,
                          kp_layers=2)
    inputs = make_synthetic_inputs(syn)
    mesh = inputs.mesh
    verts = mesh.verts[None] + torch.tensor([[0.0, 0.0, 0.6]])
    check("rasterize 1024f@128^2 (zbuf)",
          lambda v, f, k, fv: rasterize(v, f, k, 128, 128, fv, 128).zbuf,
          verts, mesh.faces, inputs.intrinsics, mesh.face_valid, tol=1e-4)
    vis = t(rs.randn(1, mesh.verts.shape[0], 6).astype(np.float32))
    check("fused raster+attrs 1024f@128^2",
          lambda v, f, k, a, fv: rasterize_with_vis_attrs(v, f, k, a, 128, 128, fv, 128)[0],
          verts, mesh.faces, inputs.intrinsics, vis, mesh.face_valid, tol=5e-3)

    if args.full:
        from ..models.refiner import RefinerConfig
        from ..models.rnnpose import RNNPose, RNNPoseConfig, init_random_

        kp = kpconv_config(syn)
        cfg = RNNPoseConfig(
            desc_kp=dataclasses.replace(kp, final_feats_dim=32),
            ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
            refiner=RefinerConfig(render_iters=2, gru_iters=2, zoom_crop_size=64,
                                  corr_levels=2, mixed_precision=False),
        )
        model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(0)).eval()
        # bf16-free full forward: what differs is geometry and f32 rounding.
        check("FULL eval forward (fp32, Ti_pred)",
              lambda m, x: m(x)["Ti_pred"], model, inputs, tol=5e-3)

    flags_after = _tf32_flags()
    print(f"TF32 flags after: {flags_after}", flush=True)
    summary = {"device": dev.type, "ref_device": ref.type, "tf32_before": flags_before,
               "tf32_after": flags_after, "ops": results, "failures": failures}
    print(json.dumps(summary), flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}", flush=True)
        raise SystemExit(1)
    print("\nall numerics checks passed", flush=True)
    return summary


if __name__ == "__main__":
    main()
