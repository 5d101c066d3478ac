"""The refiner at the reference's full budget on a seeded scene, its
per-iteration history written out (port of
`rnnpose_tpu/tools/full_budget_rehearsal.py`, retargeted).

The JAX tool runs the reference torch refiner and the JAX one on the same
scene at the reference operating budget and logs how they diverge per
iteration. The reference checkout is not part of this repository, so the
port's tool runs the port's `PoseRefiner` alone and writes what such a
comparison reads; `tests/test_torch_port_rehearsal.py` holds it against
the JAX package's refiner on the same scene and weights.

The scene is the JAX tool's, draw for draw (`numpy.random.RandomState(0)`):
an icosphere of `--subdivisions` (4: 2562 vertices) and radius 6 cm,
simplified to `--verts` / `--faces` and oriented outward, random vertex
colours, a random `--image_size`^2 image, the LINEMOD focal length 572.4,
the init and ground-truth poses, random context features and unit 3D and
2D descriptors. The refiner: `--render_iters` x `--gru_iters` x 1 LM, the
`--zoom` crop, f32, the similarity and the LM at full resolution, raster
chunk `--chunk`. Its weights are `--weights` (a torch state dict of the
refiner, keys bare or under `motion_net.`), or random ones from seed 0.

`--out` receives one JSON object: the per-iteration crop intrinsics
(T, B, 4), flow (T, B, S, S, 2) and relative pose (T, B, 4, 4), the final
`Ti_pred`, the training loss (`train/losses.refiner_loss` with the JAX
tool's weights 0.5 / 0.3 / 1.0) and the scene's sizes. `main` returns the
same dict with numpy arrays.

Usage:
  python -m rnnpose_tpu_torch.tools.full_budget_rehearsal --out rehearsal.json
      [--image_size 320 --zoom 240 --render_iters 3 --gru_iters 4
       --subdivisions 4 --verts 2048 --faces 4096 --chunk 128]
      [--weights refiner.pt] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time

from .train import positive_int

FOCAL = 572.4
LOSS_WEIGHTS = dict(flow_weight=0.5, reproj_weight=0.3, pcalign_weight=1.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="the refiner at the full budget, per iteration")
    p.add_argument("--image_size", type=positive_int, default=320)
    p.add_argument("--zoom", type=positive_int, default=240)
    p.add_argument("--render_iters", type=positive_int, default=3)
    p.add_argument("--gru_iters", type=positive_int, default=4)
    p.add_argument("--subdivisions", type=int, default=4)
    p.add_argument("--verts", type=positive_int, default=2048)
    p.add_argument("--faces", type=positive_int, default=4096)
    p.add_argument("--chunk", type=positive_int, default=128)
    p.add_argument("--weights", type=str, default=None,
                   help="torch state dict of the refiner (default: seeded random weights)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; pass cpu to run on the host)")
    return p.parse_args(argv)


def build_scene(image_size, subdivisions, num_verts, num_faces):
    """The JAX tool's seeded scene as numpy arrays (see the module
    docstring): image, T_init, T_gt, K (1, 4), the padded mesh (verts,
    faces, colors, vert_valid, face_valid), ctx (1, V, 256), geo3 (1, V,
    32), geo2 (1, H, W, 32), points (1, V, 3), point_valid (1, V), n, nf."""
    import numpy as np
    import torch

    from ..data.synthetic import make_icosphere
    from ..geometry.se3 import se3_expm
    from ..render import mesh as mesh_lib

    rng = np.random.RandomState(0)
    H = W = image_size
    m = make_icosphere(subdivisions, 0.06)
    m = mesh_lib.simplify_mesh(m, num_verts, num_faces)
    m = mesh_lib.orient_faces_outward(m)
    n, nf = m.num_verts, m.num_faces
    colors = rng.rand(n, 3).astype(np.float32)
    m = mesh_lib.TriMesh(m.verts, m.faces, colors)
    pm = mesh_lib.pad_mesh(m, num_verts, num_faces)
    image = rng.rand(1, H, W, 3).astype(np.float32)
    K = np.array([[FOCAL, FOCAL, W / 2.0, H / 2.0]], np.float32)

    def pose(rx, ry, tx, ty, tz):
        xi = np.array([[tx, ty, 0.0, rx, ry, 0.02]], np.float32)
        T = se3_expm(torch.from_numpy(xi)).numpy().copy()
        T[:, 2, 3] += tz
        return T.astype(np.float32)

    T_init = pose(0.05, -0.04, 0.004, -0.003, 0.5)
    T_gt = pose(0.01, 0.02, -0.002, 0.005, 0.52)
    ctx = rng.randn(1, n, 256).astype(np.float32) * 0.5
    geo3 = rng.randn(1, n, 32).astype(np.float32)
    geo3 /= np.linalg.norm(geo3, axis=-1, keepdims=True)
    geo2 = rng.randn(1, H, W, 32).astype(np.float32)
    geo2 /= np.linalg.norm(geo2, axis=-1, keepdims=True)

    def pad(a, width):
        out = np.zeros((1, num_verts, width), np.float32)
        out[:, :n] = a
        return out

    return dict(
        image=image, T_init=T_init, T_gt=T_gt, K=K, verts=pm.verts, faces=pm.faces,
        colors=pm.vert_colors, vert_valid=(np.arange(num_verts) < n).astype(np.float32),
        face_valid=np.arange(num_faces) < nf, ctx=pad(ctx, 256), geo3=pad(geo3, 32),
        geo2=geo2, points=pad(m.verts[:n], 3),
        point_valid=(np.arange(num_verts) < n).astype(np.float32)[None], n=n, nf=nf)


def run_refiner(refiner, scene, device):
    """The port's refiner on the scene: (RefinerOutputs, loss dict)."""
    import numpy as np
    import torch

    from ..models.refiner import MeshAssets
    from ..train.losses import RefinerLossConfig, refiner_loss

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    mesh = MeshAssets(verts=t(scene["verts"]), faces=t(scene["faces"].astype(np.int64)),
                      colors=t(scene["colors"]), vert_valid=t(scene["vert_valid"]),
                      face_valid=t(scene["face_valid"]), normals=None)
    with torch.no_grad():
        outs = refiner(image=t(scene["image"]), T_init=t(scene["T_init"]),
                       intrinsics=t(scene["K"]), mesh=mesh, ctx_fea_3d=t(scene["ctx"]),
                       geofea_3d=t(scene["geo3"]), geofea_2d=t(scene["geo2"]),
                       T_gt=t(scene["T_gt"]))
        loss = refiner_loss(outs, t(scene["points"]), t(scene["point_valid"]),
                            cfg=RefinerLossConfig(**LOSS_WEIGHTS),
                            gru_iters=refiner.cfg.gru_iters)
    return outs, loss


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from ..models.refiner import PoseRefiner, RefinerConfig
    from ..models.rnnpose import init_random_

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; pass "
                           "--device cpu to run on the host")
    t0 = time.perf_counter()
    scene = build_scene(args.image_size, args.subdivisions, args.verts, args.faces)
    print(f"mesh: {scene['n']} verts / {scene['nf']} faces (padded {args.verts}/{args.faces}); "
          f"scene built in {time.perf_counter() - t0:.1f} s", flush=True)
    refiner = PoseRefiner(RefinerConfig(
        render_iters=args.render_iters, gru_iters=args.gru_iters, optim_iters=1,
        zoom_crop_size=args.zoom, mixed_precision=False, corr_weight_res="full",
        lm_res="full", raster_chunk=args.chunk))
    if args.weights:
        sd = torch.load(args.weights, map_location="cpu", weights_only=True)
        refiner.load_state_dict({k.removeprefix("motion_net."): v for k, v in sd.items()})
    else:
        init_random_(refiner, torch.Generator().manual_seed(0))
    refiner = refiner.to(device).eval()
    t0 = time.perf_counter()
    outs, loss = run_refiner(refiner, scene, device)
    print(f"refiner forward and loss on {device}: {time.perf_counter() - t0:.1f} s", flush=True)

    def a(x):
        return x.detach().cpu().numpy()

    result = {
        "K_crop": a(outs.intrinsics_history), "flow": a(outs.flow_history),
        "Tij": a(outs.Tij_history), "Ti_pred": a(outs.Ti_pred),
        "total_loss": float(loss["total_loss"]),
        "moved_from_init": float(np.abs(a(outs.Ti_pred) - scene["T_init"]).max()),
        "verts": scene["n"], "faces": scene["nf"], "image_size": args.image_size,
        "zoom": args.zoom, "render_iters": args.render_iters, "gru_iters": args.gru_iters,
    }
    print(f"training loss {result['total_loss']:.6f}; pose moved from init by "
          f"{result['moved_from_init']:.3e}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: v.tolist() if isinstance(v, np.ndarray) else v
                       for k, v in result.items()}, f)
        print(f"wrote {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
