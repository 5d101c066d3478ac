"""The full-budget rehearsal's two refiners on one scene: the JAX package's
(jitted, on its CPU scan raster, weights from PRNGKey(0)) and the port's
with those weights converted (`models/convert.flax_to_state_dict`), both
f32 with the similarity and the LM at full resolution.

Shared by `test_torch_port_rehearsal.py` (free-running), by
`test_torch_port_rehearsal_forced.py` (one render iteration at a time from
the JAX refiner's own poses) and by `_torch_port_rehearsal_curves.py`.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from rnnpose_tpu_torch.geometry import projective
from rnnpose_tpu_torch.geometry.precise import fma
from rnnpose_tpu_torch.render import raster
from rnnpose_tpu_torch.tools import full_budget_rehearsal as R

# The slow test's bounds (`test_torch_port_rehearsal.py`, full budget).
BOUNDS = {"K_crop rel": 1e-5, "flow px": 2e-2, "Tij": 5e-4, "end pose": 5e-4}


def _jax_run(scene, render_iters, gru_iters, zoom, chunk, params=None):
    """(JAX RefinerOutputs as numpy, loss, params) on the scene; the
    weights are initialised from PRNGKey(0) unless `params` is given."""
    import jax
    import jax.numpy as jnp

    from rnnpose_tpu.models.refiner import MeshAssets, PoseRefiner, RefinerConfig
    from rnnpose_tpu.train.losses import RefinerLossConfig, refiner_loss

    fref = PoseRefiner(RefinerConfig(
        render_iters=render_iters, gru_iters=gru_iters, optim_iters=1, zoom_crop_size=zoom,
        mixed_precision=False, corr_weight_res="full", lm_res="full", raster_chunk=chunk))
    fin = dict(
        image=jnp.asarray(scene["image"]), T_init=jnp.asarray(scene["T_init"]),
        intrinsics=jnp.asarray(scene["K"]),
        mesh=MeshAssets(verts=jnp.asarray(scene["verts"]),
                        faces=jnp.asarray(scene["faces"].astype(np.int32)),
                        colors=jnp.asarray(scene["colors"]),
                        vert_valid=jnp.asarray(scene["vert_valid"]),
                        face_valid=jnp.asarray(scene["face_valid"]), normals=None),
        ctx_fea_3d=jnp.asarray(scene["ctx"]), geofea_3d=jnp.asarray(scene["geo3"]),
        geofea_2d=jnp.asarray(scene["geo2"]), T_gt=jnp.asarray(scene["T_gt"]))
    if params is None:
        params = jax.device_get(jax.jit(lambda k: fref.init(k, **fin))(jax.random.PRNGKey(0)))
    outs = jax.jit(lambda p: fref.apply(p, **fin))(params)
    loss = refiner_loss(outs, jnp.asarray(scene["points"]), jnp.asarray(scene["point_valid"]),
                        cfg=RefinerLossConfig(**R.LOSS_WEIGHTS), gru_iters=gru_iters)
    return jax.tree.map(np.asarray, outs), float(loss["total_loss"]), params


def port_refiner(params, render_iters, gru_iters, zoom, chunk):
    """The port's refiner at the same config, holding the JAX weights."""
    from rnnpose_tpu_torch.models.convert import flax_to_state_dict
    from rnnpose_tpu_torch.models.refiner import PoseRefiner, RefinerConfig

    ref = PoseRefiner(RefinerConfig(
        render_iters=render_iters, gru_iters=gru_iters, optim_iters=1, zoom_crop_size=zoom,
        mixed_precision=False, corr_weight_res="full", lm_res="full", raster_chunk=chunk))
    sd = flax_to_state_dict({"params": {"motion": params["params"]}})
    ref.load_state_dict({k.removeprefix("motion_net."): torch.from_numpy(np.array(v))
                         for k, v in sd.items()})
    return ref.eval()


def forced_render(ref, scene, jouts, r, gru_iters):
    """The port teacher-forced at render iteration r: a one-render refiner
    `ref` starts from the JAX refiner's pose at the start of its render r
    (`Ti_history[r * gru_iters]`, `refiner.py`'s `Ti = Tij @ Ti`) and ends
    against JAX's pose at the start of render r + 1 (`Ti_pred` after the
    last). Returns (per inner step i, (K_crop max rel |d|, flow max |d|,
    Tij max |d|) against JAX's step `r * gru_iters + i`; the end pose's max
    |d|; the port's outputs)."""
    j0, j1 = r * gru_iters, (r + 1) * gru_iters
    end_ref = jouts.Ti_history[j1] if j1 < jouts.Ti_history.shape[0] else jouts.Ti_pred
    outs, _ = R.run_refiner(ref, dict(scene, T_init=jouts.Ti_history[j0]), torch.device("cpu"))
    jK = jouts.intrinsics_history[j0:j1]
    dK = (np.abs(outs.intrinsics_history.numpy() - jK) / np.abs(jK)).reshape(gru_iters, -1)
    dflow = np.abs(outs.flow_history.numpy() - jouts.flow_history[j0:j1])
    dT = np.abs(outs.Tij_history.numpy() - jouts.Tij_history[j0:j1])
    steps = [(float(dK[i].max()), float(dflow[i].max()), float(dT[i].max()))
             for i in range(gru_iters)]
    return steps, float(np.abs(outs.Ti_pred.numpy() - end_ref).max()), outs


def forced_maxima(steps, dend, r, gru_iters):
    """Print render iteration r's lines as the slow test prints its table,
    and return its maxima by quantity (the keys of BOUNDS)."""
    for i, (dK, dflow, dT) in enumerate(steps):
        print(f"{r * gru_iters + i:4d} | {dK:.3e} | {dflow:.3e} | {dT:.3e}")
    print(f"render {r}: end pose max|d| {dend:.3e}")
    return {"K_crop rel": max(s[0] for s in steps), "flow px": max(s[1] for s in steps),
            "Tij": max(s[2] for s in steps), "end pose": dend}


def raster_cracks(scene, jouts, r, gru_iters, zoom, chunk):
    """At the JAX refiner's pose of render r, on the port's zoom crop: the
    JAX raster (jitted, as its refiner runs it) and the port's. Returns
    (JAX depth, JAX face ids, the port's face ids with XLA's face forms, the
    port's face ids, the port's depth, and for each pixel whose depths
    differ by more than 1e-2 its (y, x, f64 depth): the nearest face
    covering the pixel centre, evaluated in f64 from the port's vertices)."""
    import jax

    from rnnpose_tpu.render import raster as jraster
    from rnnpose_tpu_torch.models.refiner import MeshAssets, zoom_crop

    t = torch.from_numpy
    faces, fv = scene["faces"].astype(np.int64), scene["face_valid"]
    mesh = MeshAssets(verts=t(scene["verts"]), faces=t(faces), colors=t(scene["colors"]),
                      vert_valid=t(scene["vert_valid"]), face_valid=t(fv))
    h = scene["image"].shape[1]
    verts_cam, _, K = zoom_crop(t(np.array(jouts.Ti_history[r * gru_iters])), mesh,
                                t(scene["K"]), h, h, zoom, 0.4)
    ref = jax.jit(lambda v, f, k, m: jraster.rasterize(v, f, k, zoom, zoom, m, chunk=chunk))(
        verts_cam.numpy(), faces.astype(np.int32), K.numpy(), fv)
    fid_j, z_j = np.asarray(ref.face_id)[0], np.asarray(ref.zbuf)[0]

    def port_raster():
        out = raster.rasterize(verts_cam, t(faces), K, zoom, zoom, face_valid=t(fv),
                               chunk=chunk)
        return out.face_id.numpy()[0], out.zbuf.numpy()[0]

    with patched(XLA_FACE):
        fid_x, _ = port_raster()
    fid_t, z_t = port_raster()
    uv = projective.project(verts_cam, K[:, None, :])[0][0].double().numpy()
    p = uv[faces][fv]                                             # (F, 3, 2)
    zf = verts_cam[0, :, 2].double().numpy()[faces][fv]
    cracks = []
    for y, x in np.argwhere(np.abs(z_t - z_j) > 1e-2):
        e = np.stack([p[:, i, 0] * p[:, j, 1] - p[:, j, 0] * p[:, i, 1]
                      + (p[:, i, 1] - p[:, j, 1]) * (x + 0.5) + (p[:, j, 0] - p[:, i, 0]) * (y + 0.5)
                      for i, j in ((1, 2), (2, 0), (0, 1))], -1)
        b = e / e.sum(-1, keepdims=True)
        cracks.append((y, x, np.where((b >= 0).all(-1), (b * zf).sum(-1), np.inf).min()))
    print(f"render {r}: face ids differ at {int((fid_t != fid_j).sum())} pixels, depth by more "
          f"than 1e-2 at {len(cracks)}")
    for y, x, z64 in cracks:
        print(f"  pixel ({y}, {x}): f64 depth {z64:.6f}, port face {fid_t[y, x]} depth "
              f"{z_t[y, x]:.6f}, JAX face {fid_j[y, x]} depth {z_j[y, x]:.6f}")
    return z_j, fid_j, fid_x, fid_t, z_t, cracks


def _xla_project(points, intrinsics, jacobian=False):
    """`geometry/projective.project` with u = fx X / Z + cx contracted as
    XLA's CPU backend contracts the JAX formula (`fma(fx X, 1/Z, cx)`)."""
    _, jac = _PROJECT(points, intrinsics, jacobian)
    X, Y, Z = points[..., 0], points[..., 1], points[..., 2]
    zinv = torch.where(Z > projective.MIN_DEPTH,
                       1.0 / torch.clamp(Z, min=projective.MIN_DEPTH), torch.zeros_like(Z))
    u = fma(intrinsics[..., 0] * X, zinv, intrinsics[..., 2])
    v = fma(intrinsics[..., 1] * Y, zinv, intrinsics[..., 3])
    return torch.stack([u, v], dim=-1), jac


def _xla_face_screen_data(uv, z, faces, face_valid):
    """`render/raster._face_screen_data` with the edge constants
    `x_i y_j - x_j y_i` and the doubled area contracted as XLA contracts
    the JAX formulas (one product rounded, the other inside an fma)."""
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


_PROJECT = projective.project
# The forms the port keeps uncontracted on purpose (watertight edges;
# ROADMAP Queue 3), as the jitted JAX refiner rounds them.
XLA_FACE = [(projective, "project", _xla_project),
            (raster, "_face_screen_data", _xla_face_screen_data)]


@contextlib.contextmanager
def patched(sites):
    """Replace each (module, name, function) of `sites` for the block."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in sites]
    try:
        for m, n, f in sites:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
