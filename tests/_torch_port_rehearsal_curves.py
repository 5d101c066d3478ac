"""The full-budget rehearsal's curve per group of rounding forms, its
spread over seeded jitters of the initial pose, the JAX refiner's own
spread under a one-ulp move of the initial pose, and the port's maxima one
render iteration at a time (CPU, f32).

Usage, from the repository root:

    JAX_PLATFORMS=cpu python tests/_torch_port_rehearsal_curves.py \
        [--jitters 1,2,3] [--forms all,xla_face] [--jax_floor | --forced]

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
Per run one JSON line: the maxima over the 3 x 4 iterations of the crop
intrinsics' relative |d|, the flow's and the relative pose's |d| against
the JAX refiner, the final pose's |d| and the loss's relative |d| (about
10 minutes on 8 CPU cores for the four groups at four starts).

`--jax_floor`: the free-running JAX refiner at `T_init` against itself
with one entry of `T_init` moved by one f32 ulp (`np.nextafter` upwards):
the translation z, the rotation entry (0, 1) and the translation x; the
same maxima per moved entry (about 1 minute).

`--forced`: per start and group of forms (default `all,xla_face`), each
render iteration r of the port started from the JAX refiner's own pose
at the start of its render r, as `test_torch_port_rehearsal_forced.py`
runs it: the per-step lines and one JSON line of maxima per render
iteration; then per start and render iteration the raster check of
`raster_cracks` (the pixels whose depth differs from the JAX raster's by
more than 1e-2, with the f64 z-buffer's depth; about 4 minutes).
"""
from __future__ import annotations

import argparse
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

from _torch_port_rehearsal_common import (  # noqa: E402
    XLA_FACE, _jax_run, forced_maxima, forced_render, patched, port_refiner, raster_cracks)
from rnnpose_tpu_torch.geometry import crop, projective, se3  # noqa: E402
from rnnpose_tpu_torch.models import refiner  # noqa: E402
from rnnpose_tpu_torch.ops import sampler  # noqa: E402
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


PLAIN_CROP_SE3 = [(crop, "crop_intrinsics", _plain_crop_intrinsics),
               (sampler, "crop_source_coords", _plain_crop_source_coords),
               (se3, "_series", _plain_series)]
PLAIN_REST = [(refiner, "bilinear_sample", _plain_bilinear_sample),
              (sampler, "bilinear_sample", _plain_bilinear_sample),
              (refiner, "fma", _plain_fma)]
FORMS = {"plain": PLAIN_CROP_SE3 + PLAIN_REST, "crop_se3": PLAIN_REST, "all": [],
         "xla_face": XLA_FACE}


def forms(name):
    return patched(FORMS[name])


# The entries of T_init that `--jax_floor` moves by one f32 ulp (upwards).
ULP_ENTRIES = {"t_z": (0, 2, 3), "R_01": (0, 0, 1), "t_x": (0, 0, 3)}


def _maxima(K, flow, Tij, Ti_pred, loss, jouts, jloss):
    """The maxima the slow test checks, against the JAX run `jouts`."""
    return dict(
        K_rel=float((np.abs(K - jouts.intrinsics_history)
                     / np.abs(jouts.intrinsics_history)).max()),
        flow=float(np.abs(flow - jouts.flow_history).max()),
        Tij=float(np.abs(Tij - jouts.Tij_history).max()),
        Ti_pred=float(np.abs(Ti_pred - jouts.Ti_pred).max()),
        loss_rel=abs(loss - jloss) / abs(jloss))


def _starts(base, jitters):
    """(jitter, scene) for the scene's own T_init, then each jitter seed."""
    yield None, base
    for jitter in jitters:
        xi = np.random.RandomState(jitter).randn(1, 6).astype(np.float32) * 2e-3
        T = (se3.se3_expm(torch.from_numpy(xi)).numpy() @ base["T_init"]).astype(np.float32)
        yield jitter, dict(base, T_init=T)


def free_running(base, jitters, names):
    """The port's 3 x 4 refiner per group of forms against the JAX one."""
    rows = []
    for jitter, scene in _starts(base, jitters):
        jouts, jloss, params = _jax_run(scene, RI, GI, ZOOM, 128)
        ref = port_refiner(params, RI, GI, ZOOM, 128)
        for name in names:
            with forms(name):
                outs, loss = R.run_refiner(ref, scene, torch.device("cpu"))
            row = dict(jitter=jitter, forms=name, **_maxima(
                *(x.numpy() for x in (outs.intrinsics_history, outs.flow_history,
                                      outs.Tij_history, outs.Ti_pred)),
                float(loss["total_loss"]), jouts, jloss),
                moved=float(np.abs(outs.Ti_pred.numpy() - scene["T_init"]).max()))
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def jax_floor(base):
    """The free-running JAX refiner against itself with one entry of T_init
    moved by one f32 ulp: the spread a 1-ulp pose difference grows to."""
    jouts, jloss, params = _jax_run(base, RI, GI, ZOOM, 128)
    rows = []
    for name, idx in ULP_ENTRIES.items():
        T = base["T_init"].copy()
        T[idx] = np.nextafter(T[idx], np.float32(np.inf))
        jo, jl, _ = _jax_run(dict(base, T_init=T), RI, GI, ZOOM, 128, params=params)
        row = dict(moved=name, **_maxima(jo.intrinsics_history, jo.flow_history,
                                         jo.Tij_history, jo.Ti_pred, jl, jouts, jloss))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def forced(base, jitters, names):
    """The port one render iteration at a time from the JAX refiner's own
    poses (`test_torch_port_rehearsal_forced.py`), per start and forms."""
    rows = []
    for jitter, scene in _starts(base, jitters):
        jouts, _, params = _jax_run(scene, RI, GI, ZOOM, 128)
        ref = port_refiner(params, 1, GI, ZOOM, 128)
        for name in names:
            for r in range(RI):
                with forms(name):
                    steps, dend, _ = forced_render(ref, scene, jouts, r, GI)
                row = dict(jitter=jitter, forms=name, render=r,
                           **forced_maxima(steps, dend, r, GI))
                rows.append(row)
                print(json.dumps(row), flush=True)
        for r in range(RI):
            raster_cracks(scene, jouts, r, GI, ZOOM, 128)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--jitters", default="1,2,3")
    p.add_argument("--forms", default=None,
                   help="groups of forms (default: all four; with --forced all,xla_face)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--jax_floor", action="store_true",
                      help="the JAX refiner against itself, T_init moved by one ulp")
    mode.add_argument("--forced", action="store_true",
                      help="one render iteration at a time from the JAX refiner's poses")
    args = p.parse_args(argv)
    print(f"torch threads {torch.get_num_threads()}, cpu count {os.cpu_count()}", flush=True)
    base = R.build_scene(320, 4, 2048, 4096)
    if args.jax_floor:
        return jax_floor(base)
    jitters = [int(s) for s in args.jitters.split(",") if s]
    names = (args.forms or ("all,xla_face" if args.forced else ",".join(FORMS))).split(",")
    return (forced if args.forced else free_running)(base, jitters, names)


if __name__ == "__main__":
    main()
