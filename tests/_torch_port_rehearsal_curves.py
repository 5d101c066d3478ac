"""The full-budget rehearsal's curve per group of rounding forms, and its
spread over seeded jitters of the initial pose (CPU, f32).

Usage, from the repository root (about 10 minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu python tests/_torch_port_rehearsal_curves.py [--jitters 1,2,3]

On `tools/full_budget_rehearsal.build_scene(320, 4, 2048, 4096)` with the
JAX refiner's weights (PRNGKey(0)) converted for the port, as the `slow`
test in `test_torch_port_rehearsal.py` runs it, for the scene's own
`T_init` and for each jitter seed (`T_init` moved by `se3_expm` of a
seeded twist of 2e-3 per component), the port's refiner runs with:
  * `plain`: every rounding form in its plain torch form (each division
    and product rounded, `c / x` as torch computes it);
  * `crop_se3`: XLA's forms at the zoom crop's intrinsics and source
    coordinates and the se3 Taylor branches;
  * `all`: the port as it is (also bilinear sampling's four taps and the
    full-res similarity's sample points);
  * `xla_face`: `all` with the projection and the face setup's edge
    constants and doubled areas contracted as XLA contracts the JAX code.
Per run one line: the maxima over the 3 x 4 iterations of the crop
intrinsics' relative |d|, the flow's and the relative pose's |d| against
the JAX refiner, the final pose's |d| and the loss's relative |d|.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import torch  # noqa: E402

torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))

from rnnpose_tpu_torch.geometry import crop, projective, se3  # noqa: E402
from rnnpose_tpu_torch.geometry.precise import fma  # noqa: E402
from rnnpose_tpu_torch.models import refiner  # noqa: E402
from rnnpose_tpu_torch.ops import sampler  # noqa: E402
from rnnpose_tpu_torch.render import raster  # noqa: E402
from rnnpose_tpu_torch.tools import full_budget_rehearsal as R  # noqa: E402

RI, GI, ZOOM = 3, 4, 240


def _plain_crop_intrinsics(intrinsics, cp, out_size):
    sx = (out_size - 1) / (2.0 * cp[..., 2])
    sy = (out_size - 1) / (2.0 * cp[..., 3])
    return torch.stack([intrinsics[..., 0] * sx, intrinsics[..., 1] * sy,
                        (intrinsics[..., 2] - (cp[..., 0] - cp[..., 2])) * sx,
                        (intrinsics[..., 3] - (cp[..., 1] - cp[..., 3])) * sy], dim=-1)


def _plain_crop_source_coords(cp, out_size):
    grid = projective.coords_grid(out_size, out_size, device=cp.device)
    s = (2.0 * cp[..., 2:4]) / out_size
    origin = cp[..., :2] - cp[..., 2:4]
    return (grid[None] + 0.5) * s[:, None, None, :] + origin[:, None, None, :] - 0.5


def _plain_series(k0, p1, d1, p2, d2):
    return k0 + p1 / d1 + p2 / d2


def _plain_bilinear_sample(image, coords):
    B, H, W, C = image.shape
    out_shape = coords.shape[:-1] + (C,)
    coords = coords.reshape(B, -1, 2)
    x0, y0 = torch.floor(coords[..., 0]), torch.floor(coords[..., 1])
    wx = (coords[..., 0] - x0)[..., None]
    wy = (coords[..., 1] - y0)[..., None]
    flat = image.reshape(B, H * W, C)

    def gather(xi, yi):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = torch.where(valid, yi * W + xi, torch.zeros_like(xi)).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C))
        return vals * valid[..., None].to(image.dtype)

    out = (gather(x0, y0) * (1 - wx) * (1 - wy) + gather(x0 + 1, y0) * wx * (1 - wy)
           + gather(x0, y0 + 1) * (1 - wx) * wy + gather(x0 + 1, y0 + 1) * wx * wy)
    return out.reshape(out_shape)


def _plain_fma(a, b, c):
    return a * b + c


_project = projective.project


def _xla_project(points, intrinsics, jacobian=False):
    _, jac = _project(points, intrinsics, jacobian)
    X, Y, Z = points[..., 0], points[..., 1], points[..., 2]
    zinv = torch.where(Z > projective.MIN_DEPTH,
                       1.0 / torch.clamp(Z, min=projective.MIN_DEPTH), torch.zeros_like(Z))
    u = fma(intrinsics[..., 0] * X, zinv, intrinsics[..., 2])
    v = fma(intrinsics[..., 1] * Y, zinv, intrinsics[..., 3])
    return torch.stack([u, v], dim=-1), jac


def _xla_face_screen_data(uv, z, faces, face_valid):
    fuv, zf = uv[:, faces], z[:, faces]
    (x0, y0), (x1, y1), (x2, y2) = ((fuv[..., k, 0], fuv[..., k, 1]) for k in range(3))
    a = torch.stack([y1 - y2, y2 - y0, y0 - y1], dim=-1)
    b = torch.stack([x2 - x1, x0 - x2, x1 - x0], dim=-1)
    c = torch.stack([fma(x1, y2, -(x2 * y1)), fma(x2, y0, -(x0 * y2)),
                     fma(x0, y1, -(x1 * y0))], dim=-1)
    area2 = fma(a[..., 0], x0, b[..., 0] * y0) + c[..., 0]
    front = torch.all(zf > projective.MIN_DEPTH, dim=-1)
    valid = face_valid & front & (torch.abs(area2) > raster._AREA_EPS)
    return torch.stack([a, b, c], dim=-1), zf, valid, area2, fuv


PLAIN_CROP_SE3 = [(crop, "crop_intrinsics", _plain_crop_intrinsics),
               (sampler, "crop_source_coords", _plain_crop_source_coords),
               (se3, "_series", _plain_series)]
PLAIN_REST = [(refiner, "bilinear_sample", _plain_bilinear_sample),
              (sampler, "bilinear_sample", _plain_bilinear_sample),
              (refiner, "fma", _plain_fma)]
XLA_FACE = [(projective, "project", _xla_project),
            (raster, "_face_screen_data", _xla_face_screen_data)]
FORMS = {"plain": PLAIN_CROP_SE3 + PLAIN_REST, "crop_se3": PLAIN_REST, "all": [],
         "xla_face": XLA_FACE}


@contextlib.contextmanager
def forms(name):
    saved = [(m, n, getattr(m, n)) for m, n, _ in FORMS[name]]
    try:
        for m, n, f in FORMS[name]:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def main(argv=None):
    from test_torch_port_rehearsal import _jax_run

    from rnnpose_tpu_torch.models.convert import flax_to_state_dict
    from rnnpose_tpu_torch.models.refiner import PoseRefiner, RefinerConfig

    p = argparse.ArgumentParser()
    p.add_argument("--jitters", default="1,2,3")
    p.add_argument("--forms", default=",".join(FORMS))
    args = p.parse_args(argv)
    base = R.build_scene(320, 4, 2048, 4096)
    rows = []
    for jitter in [None] + [int(s) for s in args.jitters.split(",") if s]:
        scene = dict(base)
        if jitter is not None:
            xi = np.random.RandomState(jitter).randn(1, 6).astype(np.float32) * 2e-3
            scene["T_init"] = (se3.se3_expm(torch.from_numpy(xi)).numpy()
                               @ base["T_init"]).astype(np.float32)
        jouts, jloss, params = _jax_run(scene, RI, GI, ZOOM, 128)
        ref = PoseRefiner(RefinerConfig(
            render_iters=RI, gru_iters=GI, optim_iters=1, zoom_crop_size=ZOOM,
            mixed_precision=False, corr_weight_res="full", lm_res="full", raster_chunk=128))
        sd = flax_to_state_dict({"params": {"motion": params["params"]}})
        ref.load_state_dict({k.removeprefix("motion_net."): torch.from_numpy(np.array(v))
                             for k, v in sd.items()})
        ref.eval()
        for name in args.forms.split(","):
            with forms(name):
                outs, loss = R.run_refiner(ref, scene, torch.device("cpu"))
            K, fl, Tij = (x.numpy() for x in (outs.intrinsics_history, outs.flow_history,
                                               outs.Tij_history))
            row = dict(
                jitter=jitter, forms=name,
                K_rel=float((np.abs(K - jouts.intrinsics_history)
                             / np.abs(jouts.intrinsics_history)).max()),
                flow=float(np.abs(fl - jouts.flow_history).max()),
                Tij=float(np.abs(Tij - jouts.Tij_history).max()),
                Ti_pred=float(np.abs(outs.Ti_pred.numpy() - jouts.Ti_pred).max()),
                loss_rel=abs(float(loss["total_loss"]) - jloss) / abs(jloss),
                moved=float(np.abs(outs.Ti_pred.numpy() - scene["T_init"]).max()))
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
