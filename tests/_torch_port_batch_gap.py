"""How far a batch of 2 renders and refines apart from its two items alone,
per form of the face setup's edge constants (`render/raster.py`).

Usage, from the repository root:

    python tests/_torch_port_batch_gap.py gap [--seeds 18,19,20] [--faces plain,xla,exact]
    python tests/_torch_port_batch_gap.py cracks [--faces plain,xla,exact] [--device cpu]

Both use the first two items of `chip_smoke.py`'s phase-11 scene (320^2,
2048 / 4096 icosphere, 240^2 crop) and, for `gap`, its training model at
full width in f32 under deterministic algorithms (phase 18a's, one model
per seed), on the card by default. The edge constant c_k of each face is
computed:
  * `plain`: x_i y_j - x_j y_i, each product rounded (the port's form);
  * `xla`: fma(x_i, y_j, -(x_j y_i)) with the doubled area fma(a0, x0,
    b0 y0) + c0, as XLA's CPU backend contracts the JAX package's code;
  * `exact`: x_i y_j - x_j y_i in f64, rounded once.
`gap` prints per seed the training loss terms of the B=2 batch against the
mean of its two B=1 parts (the gap phase 18a bounds at 1e-3), and per
render of item 0 the rendering pose's, the crop intrinsics' and the flow's
max |d| and the covered depths' max |d|. `cracks` renders the two items at
`T_init` and at six seeded twists of 1e-6 and prints, per twist, the
covered pixels whose depth moves by more than 1e-2 (a pixel that sees
another surface).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from rnnpose_tpu_torch.geometry.precise import fma  # noqa: E402
from rnnpose_tpu_torch.render import raster  # noqa: E402


def _edge_constants(form):
    def c(xi, yi, xj, yj):
        if form == "xla":
            return fma(xi, yj, -(xj * yi))
        if form == "exact":
            return fma(xi, yj, -(xj.double() * yi))
        return xi * yj - xj * yi
    return c


@contextlib.contextmanager
def face_form(form):
    """`raster._face_screen_data` with the edge constants (and, for `xla`,
    the doubled area) in `form`."""
    orig = raster._face_screen_data
    edge = _edge_constants(form)

    def screen_data(uv, z, faces, face_valid):
        ec, zf, valid, area2, fuv = orig(uv, z, faces, face_valid)
        (x0, y0), (x1, y1), (x2, y2) = ((fuv[..., k, 0], fuv[..., k, 1]) for k in range(3))
        c = torch.stack([edge(x1, y1, x2, y2), edge(x2, y2, x0, y0), edge(x0, y0, x1, y1)], -1)
        a, b = ec[..., 0], ec[..., 1]
        if form == "xla":
            area2 = fma(a[..., 0], x0, b[..., 0] * y0) + c[..., 0]
        else:
            area2 = a[..., 0] * x0 + b[..., 0] * y0 + c[..., 0]
        front = torch.all(zf > raster.proj.MIN_DEPTH, dim=-1)
        valid = face_valid & front & (torch.abs(area2) > raster._AREA_EPS)
        return torch.stack([a, b, c], -1), zf, valid, area2, fuv

    raster._face_screen_data = screen_data
    try:
        yield
    finally:
        raster._face_screen_data = orig


def _scene(dev):
    from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, make_synthetic_inputs
    from rnnpose_tpu_torch.parallel.mesh import shard_batch

    syn = SyntheticConfig(batch_size=8, **cs.SCENE)
    return syn, shard_batch(make_synthetic_inputs(syn, device=dev, with_corr=True), 8,
                            rank=0, world=4)


def gap(args, dev):
    from rnnpose_tpu_torch.data.synthetic import kpconv_config
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_
    from rnnpose_tpu_torch.parallel.mesh import shard_batch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    syn, scene2 = _scene(dev)
    kp = kpconv_config(syn)
    tower = dict(first_feats_dim=cs.TOWER_WIDTH, gnn_feats_dim=cs.TOWER_WIDTH)
    cfg = RNNPoseConfig(
        refiner=RefinerConfig(**cs.REFINER, mixed_precision=False),
        desc_kp=dataclasses.replace(kp, final_feats_dim=32, **tower),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False, **tower))
    G = cfg.refiner.gru_iters
    for seed in args.seeds:
        model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(seed)).to(dev)
        for form in args.faces:
            with face_form(form), torch.no_grad():
                both = model(scene2, train=True)
                parts = [model(shard_batch(scene2, 2, rank=r, world=2), train=True)
                         for r in range(2)]
            terms = {k: abs(float(both[k]) - (float(parts[0][k]) + float(parts[1][k])) / 2)
                     / abs((float(parts[0][k]) + float(parts[1][k])) / 2)
                     for k in ("loss", "flow_loss", "loss_3d_proj")}
            print(f"seed {seed} {form}: B=2 against the parts' mean, rel "
                  + ", ".join(f"{k} {v:.3e}" for k, v in terms.items()), flush=True)
            a, b = both["refiner"], parts[0]["refiner"]
            for r in range(cfg.refiner.render_iters):
                k = r * G
                za, zb = a.syn_depth_history[r, 0], b.syn_depth_history[r, 0]
                cov = (za > 0) & (zb > 0)

                def d(x, y):
                    return float((x - y).abs().max())

                print(f"  render {r + 1}: pose {d(a.Ti_history[k, 0], b.Ti_history[k, 0]):.3e}"
                      f", K_crop {d(a.intrinsics_history[k, 0], b.intrinsics_history[k, 0]):.3e}"
                      f", covered depth {float((za - zb).abs()[cov].max()):.3e}, flow "
                      f"{d(a.flow_history[k:k + G, 0], b.flow_history[k:k + G, 0]):.3e}",
                      flush=True)


def cracks(args, dev):
    from rnnpose_tpu_torch.geometry.se3 import se3_expm
    from rnnpose_tpu_torch.models.refiner import zoom_crop

    _, sc = _scene(dev)
    m, S = sc.mesh, cs.CROP
    h = sc.image.shape[1]

    def render(T):
        vc, _, K = zoom_crop(T, m, sc.intrinsics, h, h, S, 0.4)
        return raster.rasterize_with_vis_attrs(
            vc, m.faces, K, m.colors[None].expand(2, -1, -1), S, S, face_valid=m.face_valid,
            plain=True)[1]

    for form in args.faces:
        g = torch.Generator().manual_seed(0)
        with face_form(form):
            z0 = render(sc.T_init)
            jumps = []
            for _ in range(6):
                xi = (torch.randn(2, 6, generator=g) * 1e-6).to(dev)
                z = render(se3_expm(xi) @ sc.T_init)
                d = (z - z0).abs()[(z > 0) & (z0 > 0)]
                jumps.append((int((d > 1e-2).sum()), float(d.max())))
        print(f"{form}: per twist (pixels with |dz| > 1e-2, max |dz|) {jumps}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["gap", "cracks"])
    p.add_argument("--seeds", type=lambda s: [int(x) for x in s.split(",")],
                   default=[18, 19, 20, 21, 22, 23])
    p.add_argument("--faces", type=lambda s: s.split(","), default=["plain", "xla", "exact"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from rnnpose_tpu_torch import kernels
        from rnnpose_tpu_torch.cpp import native

        native.build()
        for src in kernels.SOURCES:
            kernels.build.build_kernel(src)
    else:
        torch.set_num_threads(min(4, os.cpu_count() or 1))
    (gap if args.mode == "gap" else cracks)(args, dev)


if __name__ == "__main__":
    main()
