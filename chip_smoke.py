#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of RNNPose once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. build the CUDA raster kernel from `rnnpose_tpu_torch/csrc/` (nvcc);
  2. the kernel against its plain PyTorch version on the card at the main
     path's raster shapes (B=1 and B=8, 4096 faces, 240^2 crop, D=6), plus a
     sparse small-object pose and a padding-heavy mesh: face-id mismatches,
     max |dz|, max |dattrs|, and both times from CUDA events;
  3. the whole eval forward in f32 at the reference operating point, once
     through the kernel and once through the plain raster: Ti_pred agrees;
  4. serving: the default (bf16) config with seeded random weights and
     cached 3D features, 8 requests at B=1 and 4 at B=8 in a tracking chain
     re-centred on the initial pose (a fresh small rigid jitter each frame);
     poses must be finite and rigid, and the kernel's launch count must
     equal render_iters per request; ms/frame.
Then one JSON line on the kernels, the card's name and power limit from
nvidia-smi, and the final JSON line {"ok": true, "device": {...}}.

It imports nothing of JAX. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

N_REQ_B1, N_REQ_B8 = 8, 4
KERNEL_SOURCE = "rnnpose_tpu_torch/csrc/raster_rows_attrs.cu"
KERNEL_REPLACES = "rnnpose_tpu/ops/pallas_raster.py:945"
TOL_Z, TOL_ATTR, TOL_POSE = 1e-5, 1e-4, 1e-3


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _raster_case(inputs, pose, crop_pose=None, out_size=240):
    """The refiner's crop raster inputs for the mesh at `pose` seen through
    the zoom crop of `crop_pose` (default: `pose`): face_data, bbox and the
    corner RGB + camera-normal attributes (D=6)."""
    import torch

    from rnnpose_tpu_torch.geometry import projective as proj
    from rnnpose_tpu_torch.models.refiner import zoom_crop
    from rnnpose_tpu_torch.render.raster import prepare_face_data

    mesh = inputs.mesh
    h_img, w_img = inputs.image.shape[1:3]
    _, _, K_crop = zoom_crop(pose if crop_pose is None else crop_pose, mesh,
                             inputs.intrinsics, h_img, w_img, out_size, 0.4)
    verts_cam = proj.transform_points(pose, mesh.verts[None])
    uv, _ = proj.project(verts_cam, K_crop[:, None, :])
    face_data, bbox = prepare_face_data(uv, verts_cam[..., 2], mesh.faces,
                                        mesh.face_valid)
    B = pose.shape[0]
    normals = torch.einsum("bij,vj->bvi", pose[:, :3, :3], mesh.normals)
    attrs = torch.cat([mesh.colors[None].expand(B, -1, -1), normals], dim=-1)
    return face_data, bbox, attrs[:, mesh.faces].contiguous()


def _batch(inputs, n):
    """The first n items of a batch."""
    from rnnpose_tpu_torch.models.rnnpose import RNNPoseInputs

    return RNNPoseInputs(
        image=inputs.image[:n], intrinsics=inputs.intrinsics[:n],
        T_init=inputs.T_init[:n], T_gt=inputs.T_gt[:n], mesh=inputs.mesh,
        model_points=inputs.model_points[:n], point_valid=inputs.point_valid[:n],
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, make_synthetic_inputs
    from rnnpose_tpu_torch.geometry.se3 import se3_expm
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_
    from rnnpose_tpu_torch.ops import raster_kernels as rk

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    tag = f"[{name} | {smi}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {tag}", flush=True)

    # 1. Build.
    t0 = time.perf_counter()
    rk.build_raster_kernel(verbose=True)
    print(f"{tag} phase 1 build: {time.perf_counter() - t0:.2f} s", flush=True)

    # Scenes at the reference operating point (320^2 image, 2048/4096 mesh).
    syn = SyntheticConfig(image_size=320, batch_size=8, num_verts=2048,
                          num_faces=4096, subdivisions=4)
    t0 = time.perf_counter()
    scene8 = make_synthetic_inputs(syn, device=dev)
    scene1 = _batch(scene8, 1)
    pad_scene = make_synthetic_inputs(
        dataclasses.replace(syn, batch_size=1, num_verts=2048, subdivisions=2),
        device=dev)
    print(f"{tag} scenes built in {time.perf_counter() - t0:.2f} s; "
          f"mesh faces {int(scene8.mesh.face_valid.sum())}/4096 valid, "
          f"padding-heavy mesh {int(pad_scene.mesh.face_valid.sum())}/4096",
          flush=True)

    # 2. Kernel vs plain version at the main path's raster shapes.
    far = scene1.T_init.clone()
    far[:, 2, 3] *= 6.0  # the object 6x further away, in the near pose's crop
    cases = {
        "b1": _raster_case(scene1, scene1.T_init),
        "b8": _raster_case(scene8, scene8.T_init),
        "sparse_b1": _raster_case(scene1, far, crop_pose=scene1.T_init),
        "padding_heavy_b1": _raster_case(pad_scene, pad_scene.T_init),
    }
    times = {}
    max_err = 0.0
    for cname, (fd, bb, ca) in cases.items():
        args = (fd, bb, ca, 240, 240)
        zk, fk, ak = rk.zbuffer_sweep_rows_attrs(*args, chunk=128)
        zp, fp, ap = rk.zbuffer_sweep_rows_attrs_plain(*args, chunk=128)
        torch.cuda.synchronize()
        mism = int((fk != fp).sum())
        both = (fk >= 0) & (fp >= 0)
        dz = float((zk - zp).abs()[both].max()) if both.any() else 0.0
        da = float((ak - ap).abs().max())
        cover = float((fk >= 0).float().mean())
        print(f"{tag} phase 2 {cname}: B={fd.shape[0]} coverage {cover:.4f} "
              f"face_id mismatches {mism} max|dz| {dz:.3e} max|dattrs| {da:.3e}",
              flush=True)
        if mism != 0 or dz > TOL_Z or da > TOL_ATTR:
            raise AssertionError(f"kernel disagrees with the plain version ({cname})")
        max_err = max(max_err, dz, da)
        if cname in ("b1", "b8"):
            ms_k = _time_ms(lambda: rk.zbuffer_sweep_rows_attrs(*args, chunk=128), 50)
            ms_p = _time_ms(lambda: rk.zbuffer_sweep_rows_attrs_plain(*args, chunk=128), 5)
            times[cname] = (ms_k, ms_p)
            print(f"{tag} phase 2 {cname} time: kernel {ms_k:.4f} ms, "
                  f"plain {ms_p:.4f} ms", flush=True)

    # Cached per-class 3D features: seeded, of the shapes the towers emit.
    gen = torch.Generator().manual_seed(0)
    V = scene8.mesh.verts.shape[0]
    desc3d = torch.randn(8, V, 32, generator=gen)
    desc3d = (desc3d / desc3d.norm(dim=-1, keepdim=True)).to(dev)
    ctx3d = torch.randn(8, V, 256, generator=gen).to(dev)

    # 3. Whole slice in f32: kernel raster vs plain raster.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg32 = RNNPoseConfig(refiner=RefinerConfig(mixed_precision=False))
    m_kernel = init_random_(RNNPose(cfg32), torch.Generator().manual_seed(1)).to(dev)
    m_plain = RNNPose(cfg32, raster_sweep=rk.zbuffer_sweep_rows_attrs_plain).to(dev)
    m_plain.load_state_dict(m_kernel.state_dict())
    T_k = m_kernel(scene8, cached_desc3d=desc3d, cached_ctx3d=ctx3d)["Ti_pred"]
    T_p = m_plain(scene8, cached_desc3d=desc3d, cached_ctx3d=ctx3d)["Ti_pred"]
    d_pose = float((T_k - T_p).abs().max())
    print(f"{tag} phase 3 f32 slice B=8: max|Ti_pred kernel - plain| {d_pose:.3e} "
          f"(limit {TOL_POSE}); max|Ti_pred - T_init| "
          f"{float((T_k - scene8.T_init).abs().max()):.3e}", flush=True)
    if not d_pose <= TOL_POSE:
        raise AssertionError("f32 slice: kernel and plain raster disagree")
    torch.backends.cudnn.deterministic = False

    # 4. Serving with the default (bf16) config.
    cfg = RNNPoseConfig()
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(2)).to(dev)
    jit_gen = torch.Generator().manual_seed(3)

    def serve(scene, n_req):
        B = scene.image.shape[0]
        d3, c3 = desc3d[:B], ctx3d[:B]
        T_base = scene.T_init
        # Every request starts from the base pose under a fresh small rigid
        # jitter: the tracking chain re-centred on its pose each frame.
        jitters = [se3_expm(torch.randn(B, 6, generator=jit_gen) * 1e-3).to(dev)
                   for _ in range(n_req)]
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_req):
            T_in = jitters[i] @ T_base
            outs.append(model(scene._replace(T_init=T_in), cached_desc3d=d3,
                              cached_ctx3d=c3)["Ti_pred"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return torch.stack(outs), ms / n_req, ms / (n_req * B)

    serve(scene1, 1)  # warm-up: first-call allocations and cuDNN setup
    serve(scene8, 1)
    rk.zbuffer_sweep_rows_attrs.launches = 0
    T1, ms_req1, ms_f1 = serve(scene1, N_REQ_B1)
    T8, ms_req8, ms_f8 = serve(scene8, N_REQ_B8)
    launches = rk.zbuffer_sweep_rows_attrs.launches
    expect = cfg.refiner.render_iters * (N_REQ_B1 + N_REQ_B8)
    print(f"{tag} phase 4 serving B=1: {ms_req1:.3f} ms/request, "
          f"{ms_f1:.3f} ms/frame over {N_REQ_B1} requests", flush=True)
    print(f"{tag} phase 4 serving B=8: {ms_req8:.3f} ms/request, "
          f"{ms_f8:.3f} ms/frame over {N_REQ_B8} requests", flush=True)
    print(f"{tag} phase 4 raster kernel launches {launches} (expected {expect})",
          flush=True)
    for label, T, B in (("B=1", T1, 1), ("B=8", T8, 8)):
        if tuple(T.shape) != (T.shape[0], B, 4, 4) or not bool(torch.isfinite(T).all()):
            raise AssertionError(f"serving {label}: non-finite or misshaped poses")
        R = T[..., :3, :3]
        rtr = (R.transpose(-1, -2) @ R - torch.eye(3, device=dev)).abs().max()
        bottom = (T[..., 3, :] - torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)).abs().max()
        if float(rtr) > 1e-3 or float(bottom) > 1e-5:
            raise AssertionError(f"serving {label}: poses are not rigid ({float(rtr):.2e})")
    if launches != expect:
        raise AssertionError(f"raster kernel launched {launches} times, expected {expect}")

    ms_k8, ms_p8 = times["b8"]
    print(json.dumps({"kernels": [{
        "name": "zbuffer_sweep_rows_attrs", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": max_err,
        "ms": ms_k8, "plain_ms": ms_p8,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
