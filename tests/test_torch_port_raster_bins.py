"""The culled CUDA sweep's algorithm on the CPU: its cull predicate
(`kernels/raster.tile_face_overlap`) and its order-free tie rule.

The kernel (`csrc/raster_sweep.cuh`) lists, per 32 x 32 pixel block, the
faces whose dilated bbox holds pixel centres of the block, with the
rectangle of those pixels, and tests each listed face at its rectangle's
pixels only, in whatever order the list was filled and the warps run
(shared atomics), keeping the lexicographic minimum of (z, face index).
Here a sweep over only the listed faces and their rectangles, in reversed
or shuffled order, with that minimum, must equal `zbuffer_sweep_tiled_plain`
(the ascending first-minimum sweep the kernels are held to on the card) bit
for bit, and every face that wins a pixel must be listed for the pixel's
block with the pixel in its rectangle. Scenes: those of `tests/test_torch_port_raster_tiled.py`, a
per-pose compacted face set, a raster with partial edge blocks, exact depth
ties, and boxes the cull must drop (empty, NaN).
"""
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from rnnpose_tpu.data.synthetic import make_icosphere
from rnnpose_tpu.render import mesh as jmesh
from rnnpose_tpu_torch.geometry import projective as tproj
from rnnpose_tpu_torch.kernels import raster as rk
from rnnpose_tpu_torch.render import raster as traster

# (raster h, w, chunk, focal, per-mesh offsets); the first two are the
# scenes of test_torch_port_raster_tiled.py.
SCENES = {
    "dense": (64, 64, 128, 120.0, ((0.0, 0.0, 0.5), (0.08, -0.05, 0.65))),
    "sparse": (96, 96, 64, 120.0, ((-0.15, -0.15, 0.9), (0.1, 0.12, 0.6))),
    "partial_blocks": (72, 88, 128, 160.0, ((0.02, 0.01, 0.5), (-0.06, 0.04, 0.7))),
}


def _pack(h, w, focal, offsets, faces=None, face_valid=None):
    """Icosphere meshes at len(offsets) poses packed for the sweep:
    face_data (B, F, 16), bbox (B, F, 4)."""
    m = jmesh.pad_mesh(make_icosphere(2, 0.06), 256, 1024)
    verts = (m.verts[None] + np.asarray(offsets, np.float32)[:, None, :]).astype(np.float32)
    K = np.tile(np.asarray([[focal, focal, w / 2.0, h / 2.0]], np.float32), (len(offsets), 1))
    faces = m.faces if faces is None else faces
    valid = (np.arange(len(faces)) < m.num_faces) if face_valid is None else face_valid
    uv, _ = tproj.project(torch.from_numpy(verts), torch.from_numpy(K)[:, None, :])
    return traster.prepare_face_data(
        uv, torch.from_numpy(verts[..., 2]), torch.from_numpy(faces.astype(np.int64)),
        torch.from_numpy(valid))


def _listed_sweep(fd, bb, h, w, order):
    """z (B, h, w) and fid over each block's listed faces only, visited in
    `order` ("reversed" or "shuffled") with the (z, face index)
    lexicographic minimum, each face tested at its rectangle's pixels only.
    Also returns the rectangles."""
    B = fd.shape[0]
    rects = rk.tile_face_overlap(bb, h, w)
    z = torch.full((B, h, w), rk.FAR)
    fid = torch.full((B, h, w), -1, dtype=torch.int64)
    rng = np.random.RandomState(3)
    for b in range(B):
        for by in range(rects.shape[1]):
            for bx in range(rects.shape[2]):
                rect = rects[b, by, bx]
                listed = torch.nonzero(rect[:, 0] <= rect[:, 1]).flatten().tolist()
                listed = listed[::-1] if order == "reversed" else list(rng.permutation(listed))
                rows = torch.arange(by * rk.BLOCK, min(by * rk.BLOCK + rk.BLOCK, h))[:, None]
                cols = torch.arange(bx * rk.BLOCK, min(bx * rk.BLOCK + rk.BLOCK, w))[None, :]
                y, x = rows.to(torch.float32) + 0.5, cols.to(torch.float32) + 0.5
                best_z = torch.full((rows.shape[0], cols.shape[1]), rk.FAR)
                best_f = torch.full(best_z.shape, -1, dtype=torch.int64)
                for f in listed:
                    row = fd[b, f]
                    c0, c1, r0, r1 = rect[f].tolist()
                    e0, e1, e2, depth = (x * row[k] + y * row[k + 1] + row[k + 2]
                                         for k in (0, 3, 6, 9))
                    seen = (cols >= c0) & (cols <= c1) & (rows >= r0) & (rows <= r1)
                    ok = (seen & (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
                          & (depth > rk.MIN_DEPTH) & (row[12] > 0.0))
                    zc = torch.where(ok, depth, torch.full_like(depth, rk.FAR))
                    take = (zc < best_z) | ((zc == best_z) & (f < best_f))
                    best_z = torch.where(take, zc, best_z)
                    best_f = torch.where(take, torch.full_like(best_f, f), best_f)
                z[b, rows[0, 0]:rows[-1, 0] + 1, cols[0, 0]:cols[0, -1] + 1] = best_z
                fid[b, rows[0, 0]:rows[-1, 0] + 1, cols[0, 0]:cols[0, -1] + 1] = best_f
    fid = torch.where(z < rk.FAR, fid, torch.full_like(fid, -1))
    return z, fid.to(torch.int32), rects


def _assert_listed_sweep_is_exact(fd, bb, h, w, chunk, order):
    z_p, f_p = rk.zbuffer_sweep_tiled_plain(fd, bb, h, w, chunk)
    z_l, f_l, rects = _listed_sweep(fd, bb, h, w, order)
    assert torch.equal(f_l, f_p)
    assert torch.equal(z_l, z_p)
    # No winning face is missing from its block's list or its rectangle.
    b, yy, xx = torch.nonzero(f_p >= 0, as_tuple=True)
    c0, c1, r0, r1 = rects[b, yy // rk.BLOCK, xx // rk.BLOCK, f_p[b, yy, xx].long()].unbind(-1)
    assert bool(((xx >= c0) & (xx <= c1) & (yy >= r0) & (yy <= r1)).all())
    assert float((f_p >= 0).float().mean()) > 0.02
    return rects


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_listed_sweep_equals_plain(scene, order):
    h, w, chunk, focal, offsets = SCENES[scene]
    fd, bb = _pack(h, w, focal, offsets)
    rects = _assert_listed_sweep_is_exact(fd, bb, h, w, chunk, order)
    # The cull does cull: most (block, face) pairs are empty.
    assert float((rects[..., 0] <= rects[..., 1]).float().mean()) < 0.5


def test_listed_sweep_equals_plain_compacted():
    """A per-pose keep mask, compacted to a 128-face budget as the backface
    path does (the padding rows at the end carry empty boxes)."""
    h, w, chunk, focal, offsets = SCENES["dense"]
    fd, bb = _pack(h, w, focal, offsets)
    keep = torch.from_numpy(np.random.RandomState(7).rand(2, fd.shape[1]) < 0.5)
    fd = torch.where(keep[..., None], fd, fd * torch.tensor([1.0] * 12 + [0.0] * 4))
    bb = torch.where(keep[..., None], bb, torch.tensor([rk.FAR, rk.FAR, -rk.FAR, -rk.FAR]))
    fd, bb, _ = traster.compact_faces(fd, bb, 128)
    _assert_listed_sweep_is_exact(fd, bb, h, w, 64, "shuffled")


def test_listed_sweep_ties_lowest_face_index():
    """Each face duplicated at a later index (exact depth ties), one copy
    in another chunk: in any visiting order the lower index wins."""
    m = jmesh.pad_mesh(make_icosphere(2, 0.06), 256, 1024)
    n = 128
    dup = np.concatenate([m.faces[:n], m.faces[:n // 2], m.faces[:n // 2]], 0)
    fd, bb = _pack(64, 64, 120.0, ((0.0, 0.0, 0.5),), faces=dup,
                   face_valid=np.ones(len(dup), bool))
    _assert_listed_sweep_is_exact(fd, bb, 64, 64, 64, "reversed")
    _, f_l, _ = _listed_sweep(fd, bb, 64, 64, "shuffled")
    assert (f_l >= 0).any() and int(f_l.max()) < n


def test_cull_drops_empty_and_nan_boxes_and_dilates():
    """Empty boxes (+1e9 / -1e9) and NaN boxes are culled everywhere; a box
    a pixel short of a block still reaches it (dilation); the rectangle is
    the pixels whose centres the dilated box holds, clipped to the block
    and the raster."""
    bb = torch.tensor([[[rk.FAR, rk.FAR, -rk.FAR, -rk.FAR],
                        [float("nan")] * 4,
                        [5.0, float("nan"), 9.0, 12.0],
                        [32.4, 5.0, 40.0, 6.0],      # 0.9 px right of block 0's last centre
                        [10.0, 29.8, 12.0, 30.2],    # centres 9.5-12.5, 29.5-30.5
                        [-5.0, 50.0, 70.0, 80.0]]])  # past the 60 x 64 raster
    r = rk.tile_face_overlap(bb, 60, 64)
    assert r.shape == (1, 2, 2, 6, 4) and r.dtype == torch.int32
    empty = [0, -1, 0, -1]
    assert all(r[0, i, j, f].tolist() == empty for i in range(2) for j in range(2)
               for f in range(3))
    assert r[0, 0, 0, 3].tolist() == [31, 31, 4, 6]
    assert r[0, 0, 1, 3].tolist() == [32, 40, 4, 6]
    assert r[0, 0, 0, 4].tolist() == [9, 12, 29, 30] and r[0, 1, 0, 4].tolist() == empty
    assert r[0, 1, 0, 5].tolist() == [0, 31, 49, 59] and r[0, 1, 1, 5].tolist() == [32, 63, 49, 59]
    with pytest.raises(ValueError):
        rk.tile_face_overlap(bb[0], 64, 64)
