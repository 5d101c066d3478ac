"""The brute-force z-buffer contract (`zbuffer_sweep`: face_data alone, no
bbox) and its reach pass on the CPU.

The CUDA kernel (`csrc/raster_tiled.cu`) first derives, from each face's own
coefficients, a box that must hold every pixel centre its f32 test can cover
(`kernels/raster.brute_reach_bbox_plain` is that pass in PyTorch, the same
f64 operations), then runs the culled sweep on the boxes. Here, on seeded
random faces mixed with the adversarial kinds of `chip_smoke.adversarial_faces`
(slivers, vertices at 1e5 px, edges through pixel centres, huge, infinite
and NaN coefficients, invalid rows, depth ties across chunks, depth at
MIN_DEPTH, zero and negated edges), at 40x56, 64^2, 96^2 and 232^2:

* every pixel that the plain brute-force sweep's test covers for a face,
  taken alone so that no winner hides a miss, lies inside the face's box;
* the cull of the culled kernels (`tile_face_overlap`) over those boxes,
  then the (z, face) minimum, equals the plain brute-force sweep bit for bit;
* the plain brute-force sweep matches the JAX package's Pallas
  `zbuffer_sweep` in interpret mode: face ids equal, z within 1e-5 (the
  bounds of `test_torch_port_raster_tiled.py`). XLA's CPU backend contracts
  `x * a + y * b` into an FMA, one rounding fewer than the kernels' (and the
  plain version's) f32 test, so at a pixel centre on an edge (e = 0 up to a
  rounding) the two can disagree: this comparison leaves out the kind built
  for exactly that, half-integer vertices, which the two checks above and
  `chip_smoke.py` phase 14 on the card keep.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import chip_smoke
import rnnpose_tpu.ops.pallas_raster as PR
from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.kernels import raster as rk

# (h, w, faces per batch item, chunk); B=2.
SIZES = {"40x56": (40, 56, 128, 64), "64": (64, 64, 256, 128),
         "96": (96, 96, 256, 64), "232": (232, 232, 128, 64)}
HALF_INTEGER = 2  # the adversarial kind with edges through pixel centres


def _faces(h, w, F, seed=0, kinds=tuple(range(11))):
    """(2, F, 16) f32: seeded random triangles over the raster (depths
    0.2-1.5), an eighth of them replaced by adversarial faces."""
    rs = np.random.RandomState(seed)
    P = rs.uniform(-8.0, 8.0, (2, F, 3, 2)) + rs.uniform(0.0, 1.0, (2, F, 3, 2)) * [w, h]
    base = np.stack([chip_smoke._tri_rows(P[b], rs.uniform(0.2, 1.5, (F, 3)))
                     for b in range(2)])
    return chip_smoke.adversarial_faces(torch.from_numpy(base), h, w, seed=seed + 1,
                                        kinds=kinds)


def _coverage(fd, h, w):
    """(B, F, h, w) bool: the sweep's f32 test for each face alone, in the
    kernels' rounding (separate multiplies and adds)."""
    x, y = (c.reshape(1, 1, -1) for c in rk._pixel_centres(h, w, fd.device))
    out = []
    for f0 in range(0, fd.shape[1], 32):
        r = fd[:, f0:f0 + 32, :, None]
        e0, e1, e2, depth = (x * r[:, :, k] + y * r[:, :, k + 1] + r[:, :, k + 2]
                             for k in (0, 3, 6, 9))
        out.append((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (depth > rk.MIN_DEPTH)
                   & (r[:, :, 12] > 0.0))
    return torch.cat(out, 1).reshape(*fd.shape[:2], h, w)


def _inside(box, h, w):
    """(B, F, h, w) bool: pixel centres inside each box [x0, y0, x1, y1]."""
    xs = torch.arange(w, dtype=torch.float32) + 0.5
    ys = (torch.arange(h, dtype=torch.float32) + 0.5)[:, None]
    b = box[..., None, None]
    return (xs >= b[..., 0, :, :]) & (xs <= b[..., 2, :, :]) \
        & (ys >= b[..., 1, :, :]) & (ys <= b[..., 3, :, :])


@pytest.mark.parametrize("size", sorted(SIZES))
def test_reach_holds_every_covered_pixel(size):
    h, w, F, _ = SIZES[size]
    fd = _faces(h, w, F)
    reach = rk.brute_reach_bbox_plain(fd, h, w)
    cover = _coverage(fd, h, w)
    assert int((cover & ~_inside(reach, h, w)).sum()) == 0
    # Every kind left a trace: covered pixels, empty boxes, whole rasters.
    whole = torch.tensor([-1.0, -1.0, w + 1.0, h + 1.0])
    assert float(cover.any(1).float().mean()) > 0.5
    assert int((reach == whole).all(-1).sum()) > 0
    assert int((reach[..., 0] == rk.FAR).sum()) > 0


@pytest.mark.parametrize("size", sorted(SIZES))
def test_culled_sweep_over_reach_equals_brute_force(size):
    """The culled kernels' cull (`tile_face_overlap`: each box dilated by a
    pixel, clipped to its 32 x 32 block) over the derived boxes, then the
    (z, face) minimum over the listed faces only: the plain brute-force
    sweep, bit for bit."""
    h, w, F, chunk = SIZES[size]
    fd = _faces(h, w, F)
    reach = rk.brute_reach_bbox_plain(fd, h, w)
    rect = rk.tile_face_overlap(reach, h, w)               # (B, by, bx, F, 4)
    py, px = torch.arange(h)[:, None], torch.arange(w)[None, :]
    r = rect[:, py // rk.BLOCK, px // rk.BLOCK].permute(0, 3, 4, 1, 2)  # (B, F, 4, h, w)
    listed = (px >= r[:, :, 0]) & (px <= r[:, :, 1]) & (py >= r[:, :, 2]) & (py <= r[:, :, 3])
    x, y = (c.reshape(1, 1, h, w) for c in rk._pixel_centres(h, w, fd.device))
    depth = x * fd[..., 9, None, None] + y * fd[..., 10, None, None] + fd[..., 11, None, None]
    zc = torch.where(_coverage(fd, h, w) & listed, depth, torch.full_like(depth, rk.FAR))
    z_c, f_c = torch.min(zc, dim=1)                        # first minimum: lowest face
    f_c = torch.where(z_c < rk.FAR, f_c, torch.full_like(f_c, -1)).to(torch.int32)
    z_p, f_p = rk.zbuffer_sweep_tiled_plain(fd, None, h, w, chunk)
    assert torch.equal(f_c, f_p) and torch.equal(z_c, z_p)
    assert float((f_p >= 0).float().mean()) > 0.5


@pytest.mark.parametrize("size", sorted(SIZES))
def test_brute_force_matches_pallas_interpret(size):
    """The port's `zbuffer_sweep` on the CPU (the plain brute-force sweep)
    against the Pallas kernel in interpret mode, one mesh per call."""
    h, w, F, chunk = SIZES[size]
    kinds = tuple(k for k in range(11) if k != HALF_INTEGER)
    fd = _faces(h, w, F, seed=5, kinds=kinds)
    z_t, f_t = rk.zbuffer_sweep(fd, h, w, chunk)
    for b in range(fd.shape[0]):
        z_j, f_j = PR.zbuffer_sweep(jnp.asarray(fd[b].numpy()), h, w, chunk=chunk,
                                    interpret=True)
        np.testing.assert_array_equal(f_t[b].numpy(), np.asarray(f_j))
        np.testing.assert_allclose(z_t[b].numpy(), np.asarray(z_j), atol=1e-5)
    assert float((f_t >= 0).float().mean()) > 0.5


def _row(edges, depth=(0.0, 0.0, 0.5), valid=1.0):
    row = torch.zeros(16)
    row[:9] = torch.tensor(edges, dtype=torch.float32).flatten()
    row[9:12] = torch.tensor(depth)
    row[12] = valid
    return row


def test_reach_of_special_rows():
    """The reach's cases one by one, on a 64 x 48 raster: a right triangle
    with half-integer vertices (its box the vertices' within 1e-3 px); NaN
    coefficients, valid 0 / NaN and negated edges (empty); zero edges (no
    determinant: the whole raster); an infinite coefficient and a huge one
    (|a| w past 2^126: the whole raster)."""
    h, w = 48, 64
    P = np.array([[[10.5, 20.5], [26.5, 20.5], [10.5, 36.5]]])
    tri = torch.from_numpy(chip_smoke._tri_rows(P, np.full((1, 3), 0.5)))[0]
    rows = [tri]
    for k in (0, 4, 11):
        bad = tri.clone()
        bad[k] = float("nan")
        rows.append(bad)
    for valid in (0.0, float("nan")):
        bad = tri.clone()
        bad[12] = valid
        rows.append(bad)
    neg = tri.clone()
    neg[:9] = -neg[:9]
    rows += [neg, _row([[0, 0, 1], [0, 0, 0], [0, 0, 0]])]
    for k, v in ((1, float("inf")), (2, -float("inf")), (0, 1e37)):
        big = tri.clone()
        big[k] = v
        rows.append(big)
    reach = rk.brute_reach_bbox_plain(torch.stack(rows)[None], h, w)[0]
    torch.testing.assert_close(reach[0], torch.tensor([10.5, 20.5, 26.5, 36.5]),
                               atol=1e-3, rtol=0)
    assert bool((reach[0, :2] <= torch.tensor([10.5, 20.5])).all())
    assert bool((reach[0, 2:] >= torch.tensor([26.5, 36.5])).all())
    empty = torch.tensor([rk.FAR, rk.FAR, -rk.FAR, -rk.FAR])
    whole = torch.tensor([-1.0, -1.0, w + 1.0, h + 1.0])
    for i in range(1, 7):
        assert torch.equal(reach[i], empty), i
    for i in range(7, 11):
        assert torch.equal(reach[i], whole), i


def test_wrapper_on_cpu_runs_the_plain_brute_force_and_counts_nothing():
    h, w, F, chunk = SIZES["64"]
    fd = _faces(h, w, F)
    before = kernels.LAUNCHES["zbuffer_sweep"]
    out, plain = rk.zbuffer_sweep(fd, h, w, chunk), rk.zbuffer_sweep_tiled_plain(
        fd, None, h, w, chunk)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert kernels.LAUNCHES["zbuffer_sweep"] == before
    with pytest.raises(ValueError):
        rk.brute_reach_bbox_plain(fd[0], h, w)
    with pytest.raises(ValueError):
        rk.brute_reach_bbox_plain(fd.double(), h, w)
