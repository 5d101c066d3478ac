#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of RNNPose once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. build the two CUDA raster sources of `rnnpose_tpu_torch/csrc/` (one
     nvcc each, started together);
  2. the fused rows-attrs kernel against its plain PyTorch version at the
     serving path's raster shapes (B=1 and B=8, 4096 faces, 240^2 crop,
     D=6), plus a sparse small-object pose and a padding-heavy mesh:
     face-id mismatches, max |dz|, max |dattrs|, and both times from CUDA
     events;
  3. the whole serving eval forward in f32 at the reference operating
     point, once through the kernel and once through the plain raster:
     Ti_pred agrees;
  4. serving: the default (bf16) config with seeded random weights and
     cached 3D features, 8 requests at B=1 and 4 at B=8 in a tracking chain
     re-centred on the initial pose (a fresh small rigid jitter each frame);
     poses must be finite and rigid, and the rows-attrs kernel's launch
     count must equal render_iters per request; ms/frame;
  5. the z/fid kernels (`zbuffer_sweep_tiled`: culled; `zbuffer_sweep`:
     brute force) against the plain sweep, through `rasterize` and alone:
     B=1 and B=8 at 240^2 with 4096 faces, the backface-compacted 2560 faces
     at B=8, the sparse and padding-heavy cases of phase 2 and a 232^2 crop
     (partial edge tiles); face-id mismatches, max |dz|, max |dbary|, times;
  6. the reference-exact parity forward (`apply_parity_preset`, f32) and
     the backface-culled forward at B=8, each through the kernels and
     through the plain sweep: Ti_pred agrees;
  7. parity serving: the parity preset with seeded random weights, 4
     requests at B=1 and 2 at B=8 in the tracking chain of phase 4; poses
     finite and rigid, `zbuffer_sweep_tiled` launched render_iters times
     per request and the rows-attrs kernel never; ms/frame and peak device
     memory; then the refined poses of the B=8 requests rendered through
     `rasterize(use_pallas=True)`, which must launch the brute-force kernel
     once per request and agree with the culled render.
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
from concurrent.futures import ThreadPoolExecutor

# The reference operating point: 320^2 image, 2048/4096 mesh, 240^2 crop,
# the model's default widths (REFINER holds no override).
SCENE = dict(image_size=320, num_verts=2048, num_faces=4096, subdivisions=4)
CROP = 240
REFINER = {}
N_REQ_B1, N_REQ_B8 = 8, 4
N_PAR_B1, N_PAR_B8 = 4, 2
PALLAS = "rnnpose_tpu/ops/pallas_raster.py"
KERNELS = {  # name -> (source, the TPU kernel's entry line)
    "zbuffer_sweep_rows_attrs": ("rnnpose_tpu_torch/csrc/raster_rows_attrs.cu", f"{PALLAS}:945"),
    "zbuffer_sweep_tiled": ("rnnpose_tpu_torch/csrc/raster_tiled.cu", f"{PALLAS}:222"),
    "zbuffer_sweep": ("rnnpose_tpu_torch/csrc/raster_tiled.cu", f"{PALLAS}:108"),
}
TOL_Z, TOL_ATTR, TOL_BARY, TOL_POSE = 1e-5, 1e-4, 1e-5, 1e-3


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _device():
    import torch

    return torch.device("cuda", 0)


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


def _crop_view(inputs, pose, crop_pose=None, out_size=None):
    """The mesh at `pose` in the camera frame and the intrinsics of the zoom
    crop of `crop_pose` (default: `pose`) of size `out_size` (default:
    CROP), as the refiner renders it."""
    from rnnpose_tpu_torch.geometry import projective as proj
    from rnnpose_tpu_torch.models.refiner import zoom_crop

    h_img, w_img = inputs.image.shape[1:3]
    _, _, K_crop = zoom_crop(pose if crop_pose is None else crop_pose, inputs.mesh,
                             inputs.intrinsics, h_img, w_img, out_size or CROP, 0.4)
    return proj.transform_points(pose, inputs.mesh.verts[None]), K_crop


def _sweep_inputs(mesh, verts_cam, K_crop, keep=None, compact_to=None):
    """face_data and bbox of the sweep, per-pose compacted as `rasterize`
    does when `keep` is given."""
    from rnnpose_tpu_torch.geometry import projective as proj
    from rnnpose_tpu_torch.render.raster import compact_faces, prepare_face_data

    uv, _ = proj.project(verts_cam, K_crop[:, None, :])
    valid = mesh.face_valid if keep is None else mesh.face_valid & keep
    fd, bb = prepare_face_data(uv, verts_cam[..., 2], mesh.faces, valid)
    if compact_to is not None:
        fd, bb, _ = compact_faces(fd, bb, compact_to)
    return fd, bb


def _raster_case(inputs, pose, crop_pose=None, out_size=None):
    """The refiner's fused crop raster inputs: face_data, bbox and the
    corner RGB + camera-normal attributes (D=6)."""
    import torch

    mesh = inputs.mesh
    verts_cam, K_crop = _crop_view(inputs, pose, crop_pose, out_size)
    face_data, bbox = _sweep_inputs(mesh, verts_cam, K_crop)
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


def _check_rigid(label, T, B):
    import torch

    if tuple(T.shape) != (T.shape[0], B, 4, 4) or not bool(torch.isfinite(T).all()):
        raise AssertionError(f"{label}: non-finite or misshaped poses")
    R = T[..., :3, :3]
    rtr = (R.transpose(-1, -2) @ R - torch.eye(3, device=T.device)).abs().max()
    bottom = (T[..., 3, :] - torch.tensor([0.0, 0.0, 0.0, 1.0], device=T.device)).abs().max()
    if float(rtr) > 1e-3 or float(bottom) > 1e-5:
        raise AssertionError(f"{label}: poses are not rigid ({float(rtr):.2e})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, make_synthetic_inputs
    from rnnpose_tpu_torch.geometry.se3 import se3_expm
    from rnnpose_tpu_torch.models.refiner import RefinerConfig, backface_keep
    from rnnpose_tpu_torch.models.rnnpose import (
        RNNPose, RNNPoseConfig, apply_parity_preset, init_random_)
    from rnnpose_tpu_torch.ops import raster_kernels as rk
    from rnnpose_tpu_torch.render.raster import rasterize

    dev = _device()
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    tag = f"[{name} | {smi}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {tag}", flush=True)
    wrappers = {"zbuffer_sweep_rows_attrs": rk.zbuffer_sweep_rows_attrs,
                "zbuffer_sweep_tiled": rk.zbuffer_sweep_tiled,
                "zbuffer_sweep": rk.zbuffer_sweep}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    # 1. Build both sources at once.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(rk.KERNEL_SOURCES)) as pool:
        libs = list(pool.map(lambda s: rk.build_raster_kernel(s, verbose=True),
                             rk.KERNEL_SOURCES))
    print(f"{tag} phase 1 build of {len(libs)} sources: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # Scenes at the reference operating point (320^2 image, 2048/4096 mesh).
    syn = SyntheticConfig(batch_size=8, **SCENE)
    t0 = time.perf_counter()
    scene8 = make_synthetic_inputs(syn, device=dev)
    scene1 = _batch(scene8, 1)
    pad_scene = make_synthetic_inputs(
        dataclasses.replace(syn, batch_size=1, subdivisions=2),
        device=dev)
    print(f"{tag} scenes built in {time.perf_counter() - t0:.2f} s; "
          f"mesh faces {int(scene8.mesh.face_valid.sum())}/{syn.num_faces} valid, "
          f"padding-heavy mesh {int(pad_scene.mesh.face_valid.sum())}/{syn.num_faces}",
          flush=True)

    # 2. The rows-attrs kernel vs its plain version at the serving shapes.
    far = scene1.T_init.clone()
    far[:, 2, 3] *= 6.0  # the object 6x further away, in the near pose's crop
    cases = {
        "b1": _raster_case(scene1, scene1.T_init),
        "b8": _raster_case(scene8, scene8.T_init),
        "sparse_b1": _raster_case(scene1, far, crop_pose=scene1.T_init),
        "padding_heavy_b1": _raster_case(pad_scene, pad_scene.T_init),
    }
    times = {}
    max_err = dict.fromkeys(KERNELS, 0.0)
    for cname, (fd, bb, ca) in cases.items():
        args = (fd, bb, ca, CROP, CROP)
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
        max_err["zbuffer_sweep_rows_attrs"] = max(max_err["zbuffer_sweep_rows_attrs"], dz, da)
        if cname in ("b1", "b8"):
            ms_k = _time_ms(lambda: rk.zbuffer_sweep_rows_attrs(*args, chunk=128), 50)
            ms_p = _time_ms(lambda: rk.zbuffer_sweep_rows_attrs_plain(*args, chunk=128), 5)
            times[("zbuffer_sweep_rows_attrs", cname)] = (ms_k, ms_p)
            print(f"{tag} phase 2 {cname} time: kernel {ms_k:.4f} ms, "
                  f"plain {ms_p:.4f} ms", flush=True)

    # Cached per-class 3D features: seeded, of the shapes the towers emit.
    gen = torch.Generator().manual_seed(0)
    V = scene8.mesh.verts.shape[0]
    desc3d = torch.randn(8, V, 32, generator=gen)
    desc3d = (desc3d / desc3d.norm(dim=-1, keepdim=True)).to(dev)
    ctx3d = torch.randn(8, V, 256, generator=gen).to(dev)

    def kernel_vs_plain(label, cfg, seed):
        """One forward at B=8 through the kernels and through the plain
        sweeps, same weights: max |d Ti_pred|."""
        m_kernel = init_random_(RNNPose(cfg), torch.Generator().manual_seed(seed)).to(dev)
        m_plain = RNNPose(cfg, plain_raster=True).to(dev)
        m_plain.load_state_dict(m_kernel.state_dict())
        T_k = m_kernel(scene8, cached_desc3d=desc3d, cached_ctx3d=ctx3d)["Ti_pred"]
        T_p = m_plain(scene8, cached_desc3d=desc3d, cached_ctx3d=ctx3d)["Ti_pred"]
        d_pose = float((T_k - T_p).abs().max())
        print(f"{tag} {label} B=8: max|Ti_pred kernel - plain| {d_pose:.3e} "
              f"(limit {TOL_POSE}); max|Ti_pred - T_init| "
              f"{float((T_k - scene8.T_init).abs().max()):.3e}", flush=True)
        if not d_pose <= TOL_POSE:
            raise AssertionError(f"{label}: kernel and plain raster disagree")

    # 3. Whole serving forward in f32: kernel raster vs plain raster.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg32 = RNNPoseConfig(refiner=RefinerConfig(mixed_precision=False, **REFINER))
    kernel_vs_plain("phase 3 f32 slice", cfg32, 1)
    torch.backends.cudnn.deterministic = False

    # 4. Serving with the default (bf16) config.
    cfg = RNNPoseConfig(refiner=RefinerConfig(**REFINER))
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(2)).to(dev)
    jit_gen = torch.Generator().manual_seed(3)

    def serve(model, scene, n_req):
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

    serve(model, scene1, 1)  # warm-up: first-call allocations and cuDNN setup
    serve(model, scene8, 1)
    reset_counts()
    T1, ms_req1, ms_f1 = serve(model, scene1, N_REQ_B1)
    T8, ms_req8, ms_f8 = serve(model, scene8, N_REQ_B8)
    serving_launches = {k: fn.launches for k, fn in wrappers.items()}
    expect = cfg.refiner.render_iters * (N_REQ_B1 + N_REQ_B8)
    print(f"{tag} phase 4 serving B=1: {ms_req1:.3f} ms/request, "
          f"{ms_f1:.3f} ms/frame over {N_REQ_B1} requests", flush=True)
    print(f"{tag} phase 4 serving B=8: {ms_req8:.3f} ms/request, "
          f"{ms_f8:.3f} ms/frame over {N_REQ_B8} requests", flush=True)
    print(f"{tag} phase 4 kernel launches {serving_launches} "
          f"(expected rows-attrs {expect}, others 0)", flush=True)
    _check_rigid("serving B=1", T1, 1)
    _check_rigid("serving B=8", T8, 8)
    if serving_launches != {"zbuffer_sweep_rows_attrs": expect,
                            "zbuffer_sweep_tiled": 0, "zbuffer_sweep": 0}:
        raise AssertionError(f"serving launches {serving_launches}, expected {expect}")

    # 5. The z/fid kernels vs the plain sweep, through rasterize and alone.
    mesh8 = scene8.mesh
    keep8, compact8 = backface_keep(scene8.T_init, mesh8, 128)
    vc1, K1 = _crop_view(scene1, scene1.T_init)
    vc8, K8 = _crop_view(scene8, scene8.T_init)
    vcs, Ks = _crop_view(scene1, far, crop_pose=scene1.T_init)
    vcp, Kp = _crop_view(pad_scene, pad_scene.T_init)
    vc_odd, K_odd = _crop_view(scene8, scene8.T_init, out_size=CROP - 8)
    zcases = {  # name -> (mesh, verts_cam, K_crop, size, face_keep, compact_to)
        "b1": (mesh8, vc1, K1, CROP, None, None),
        "b8": (mesh8, vc8, K8, CROP, None, None),
        "backface_b8": (mesh8, vc8, K8, CROP, keep8, compact8),
        "sparse_b1": (mesh8, vcs, Ks, CROP, None, None),
        "padding_heavy_b1": (pad_scene.mesh, vcp, Kp, CROP, None, None),
        f"crop{CROP - 8}_b8": (mesh8, vc_odd, K_odd, CROP - 8, None, None),
    }
    for cname, (mesh, vc, K, size, keep, compact_to) in zcases.items():
        kw = dict(face_valid=mesh.face_valid, chunk=128, face_keep=keep,
                  compact_to=compact_to)
        fr_p = rasterize(vc, mesh.faces, K, size, size, use_pallas=False, **kw)
        fd, bb = _sweep_inputs(mesh, vc, K, keep, compact_to)
        for kname, mode in (("zbuffer_sweep_tiled", "tiled"), ("zbuffer_sweep", True)):
            fr_k = rasterize(vc, mesh.faces, K, size, size, use_pallas=mode, **kw)
            torch.cuda.synchronize()
            mism = int((fr_k.face_id != fr_p.face_id).sum())
            dz = float((fr_k.zbuf - fr_p.zbuf).abs().max())
            db = float((fr_k.bary - fr_p.bary).abs().max())
            print(f"{tag} phase 5 {kname} {cname}: B={vc.shape[0]} F={fd.shape[1]} "
                  f"{size}^2 coverage {float((fr_k.face_id >= 0).float().mean()):.4f} "
                  f"face_id mismatches {mism} max|dz| {dz:.3e} max|dbary| {db:.3e}",
                  flush=True)
            if mism != 0 or dz > TOL_Z or db > TOL_BARY:
                raise AssertionError(f"{kname} disagrees with the plain sweep ({cname})")
            max_err[kname] = max(max_err[kname], dz, db)
        if cname in ("b1", "b8", "backface_b8"):
            ms_p = _time_ms(lambda: rk.zbuffer_sweep_tiled_plain(fd, bb, size, size, 128), 5)
            ms_t = _time_ms(lambda: rk.zbuffer_sweep_tiled(fd, bb, size, size, 128), 50)
            ms_b = _time_ms(lambda: rk.zbuffer_sweep(fd, size, size, 128), 20)
            times[("zbuffer_sweep_tiled", cname)] = (ms_t, ms_p)
            times[("zbuffer_sweep", cname)] = (ms_b, ms_p)
            print(f"{tag} phase 5 {cname} time (F={fd.shape[1]}): culled kernel "
                  f"{ms_t:.4f} ms, brute-force kernel {ms_b:.4f} ms, plain "
                  f"{ms_p:.4f} ms", flush=True)

    # 6. The parity and backface forwards in f32: kernels vs plain sweeps.
    torch.backends.cudnn.deterministic = True
    parity_cfg = apply_parity_preset(cfg)
    kernel_vs_plain("phase 6 parity forward", parity_cfg, 4)
    kernel_vs_plain("phase 6 backface forward", dataclasses.replace(
        cfg32, refiner=dataclasses.replace(cfg32.refiner, backface_cull=True)), 5)
    torch.backends.cudnn.deterministic = False

    # 7. Parity serving, then the brute-force render of its refined poses.
    pmodel = init_random_(RNNPose(parity_cfg), torch.Generator().manual_seed(6)).to(dev)
    serve(pmodel, scene1, 1)
    serve(pmodel, scene8, 1)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    P1, pms_req1, pms_f1 = serve(pmodel, scene1, N_PAR_B1)
    peak1 = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    P8, pms_req8, pms_f8 = serve(pmodel, scene8, N_PAR_B8)
    peak8 = torch.cuda.max_memory_allocated(dev)
    parity_launches = {k: fn.launches for k, fn in wrappers.items()}
    pexpect = parity_cfg.refiner.render_iters * (N_PAR_B1 + N_PAR_B8)
    for B, ms_req, ms_f, n, peak in ((1, pms_req1, pms_f1, N_PAR_B1, peak1),
                                     (8, pms_req8, pms_f8, N_PAR_B8, peak8)):
        print(f"{tag} phase 7 parity serving B={B}: {ms_req:.3f} ms/request, "
              f"{ms_f:.3f} ms/frame over {n} requests; peak device memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
    print(f"{tag} phase 7 kernel launches {parity_launches} "
          f"(expected zbuffer_sweep_tiled {pexpect}, others 0)", flush=True)
    _check_rigid("parity serving B=1", P1, 1)
    _check_rigid("parity serving B=8", P8, 8)
    if parity_launches != {"zbuffer_sweep_rows_attrs": 0,
                           "zbuffer_sweep_tiled": pexpect, "zbuffer_sweep": 0}:
        raise AssertionError(f"parity launches {parity_launches}, expected {pexpect}")

    renders = [_crop_view(scene8, T) for T in P8]
    reset_counts()
    brute = [rasterize(vc, mesh8.faces, K, CROP, CROP, face_valid=mesh8.face_valid,
                       use_pallas=True) for vc, K in renders]
    brute_launches = {k: fn.launches for k, fn in wrappers.items()}
    culled = [rasterize(vc, mesh8.faces, K, CROP, CROP, face_valid=mesh8.face_valid)
              for vc, K in renders]
    torch.cuda.synchronize()
    mism = sum(int((a.face_id != b.face_id).sum()) for a, b in zip(brute, culled))
    print(f"{tag} phase 7 brute-force render of the {len(renders)} refined B=8 "
          f"batches: launches {brute_launches}, face_id mismatches vs culled {mism}",
          flush=True)
    if brute_launches != {"zbuffer_sweep_rows_attrs": 0, "zbuffer_sweep_tiled": 0,
                          "zbuffer_sweep": len(renders)} or mism != 0:
        raise AssertionError("brute-force render: wrong launches or disagreement")

    launches = {"zbuffer_sweep_rows_attrs": serving_launches["zbuffer_sweep_rows_attrs"],
                "zbuffer_sweep_tiled": parity_launches["zbuffer_sweep_tiled"],
                "zbuffer_sweep": brute_launches["zbuffer_sweep"]}
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[k], "max_abs_err": max_err[k],
        "ms": times[(k, "b8")][0], "plain_ms": times[(k, "b8")][1],
    } for k, (src, rep) in KERNELS.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
