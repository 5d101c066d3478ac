"""The CUDA raster kernels against their plain PyTorch versions on the card.

This file imports no jax (the card's machine has none), so the card runs it
on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(`tests/conftest.py` imports jax; `--noconftest` skips it). Every test is
marked `cuda` and skips where `torch.cuda.is_available()` is false. The
scenes are those of the JAX-comparing raster tests, rebuilt with the port's
own `data/synthetic.make_icosphere` and `render/mesh.pad_mesh` (a test in
`test_torch_port_raster.py` holds them equal to the JAX package's): the
icosphere of subdivision 2, radius 6 cm, padded to 256 vertices and 1024
faces, at two poses. Bounds: face ids exact, z 1e-5, attrs 1e-4, one
launch counted per wrapper call.
"""
import numpy as np
import pytest
import torch

from rnnpose_tpu_torch.data.synthetic import make_icosphere
from rnnpose_tpu_torch.geometry import projective as tproj
from rnnpose_tpu_torch.ops import raster_kernels as rk
from rnnpose_tpu_torch.render import mesh as tmesh
from rnnpose_tpu_torch.render import raster as traster

POSES = ((0.0, 0.0, 0.5), (0.08, -0.05, 0.65))

needs_card = pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")


def icosphere_scene(offsets=POSES, K=(120.0, 120.0, 32.0, 32.0)):
    """verts (B, 256, 3), faces (1024, 3), K (B, 4), face_valid (1024,),
    attrs (B, 256, 6) seeded from 3."""
    m = tmesh.pad_mesh(make_icosphere(2, 0.06), 256, 1024)
    verts = (m.verts[None] + np.asarray(offsets, np.float32)[:, None, :]).astype(np.float32)
    K = np.tile(np.asarray([K], np.float32), (len(offsets), 1))
    attrs = np.random.RandomState(3).randn(len(offsets), 256, 6).astype(np.float32)
    return verts, m.faces, K, np.arange(1024) < m.num_faces, attrs


def pack(verts, faces, K, fv, attrs):
    """face_data, bbox and the per-face corner attrs of the sweeps."""
    uv, _ = tproj.project(torch.from_numpy(verts), torch.from_numpy(K)[:, None, :])
    f = torch.from_numpy(faces.astype(np.int64))
    face_data, bbox = traster.prepare_face_data(
        uv, torch.from_numpy(verts[..., 2]), f, torch.from_numpy(fv))
    return face_data, bbox, torch.from_numpy(attrs)[:, f].contiguous()


def _assert_close(out, plain, n=None):
    (z, f, *a), (z_p, f_p, *a_p) = out, plain
    n = n or f.shape[0]
    assert torch.equal(f, f_p[:n])
    assert float((z - z_p[:n]).abs().max()) <= 1e-5
    if a:
        assert float((a[0] - a_p[0][:n]).abs().max()) <= 1e-4


@pytest.mark.cuda
@needs_card
def test_cuda_kernel_matches_plain_version_on_card():
    """The rows-attrs kernel against the plain version at the main path's
    240^2 / chunk 128 shapes (the 64^2 camera scaled to 240^2)."""
    verts, faces, K, fv, attrs = icosphere_scene()
    K = K * np.float32(240 / 64)
    fd, bb, ca = (x.cuda() for x in pack(verts, faces, K, fv, attrs))
    before = rk.zbuffer_sweep_rows_attrs.launches
    out_k = rk.zbuffer_sweep_rows_attrs(fd, bb, ca, 240, 240, chunk=128)
    out_p = rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, 240, 240, chunk=128)
    torch.cuda.synchronize()
    assert rk.zbuffer_sweep_rows_attrs.launches == before + 1
    _assert_close(out_k, out_p)
    assert float((out_k[1] >= 0).float().mean()) > 0.02


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("size", [240, 232])
def test_cuda_kernels_match_plain_version_on_card(size):
    """The culled and brute-force z/fid kernels at 240^2 and 232^2 (partial
    edge tiles), chunk 128, B=2; then the brute-force kernel on the same
    rows with an eighth replaced by `chip_smoke.adversarial_faces`, its
    reach pass equal to `brute_reach_bbox_plain`."""
    import chip_smoke

    verts, faces, K, fv, attrs = icosphere_scene()
    K = K * np.float32(size / 64)
    fd, bb, _ = (x.cuda() for x in pack(verts, faces, K, fv, attrs))
    before = rk.zbuffer_sweep_tiled.launches, rk.zbuffer_sweep.launches
    z_p, f_p = rk.zbuffer_sweep_tiled_plain(fd, bb, size, size, 128)
    for z_k, f_k in (rk.zbuffer_sweep_tiled(fd, bb, size, size, 128),
                     rk.zbuffer_sweep(fd, size, size, 128)):
        torch.cuda.synchronize()
        assert torch.equal(f_k, f_p)
        assert float((z_k - z_p).abs().max()) <= 1e-5
    assert (rk.zbuffer_sweep_tiled.launches, rk.zbuffer_sweep.launches) == (
        before[0] + 1, before[1] + 1)
    adv = chip_smoke.adversarial_faces(fd, size, size, seed=size)
    z_p, f_p = rk.zbuffer_sweep_tiled_plain(adv, None, size, size, 128)
    z_k, f_k = rk.zbuffer_sweep(adv, size, size, 128)
    torch.cuda.synchronize()
    assert torch.equal(f_k, f_p)
    both = (f_k >= 0) & (f_p >= 0)
    assert float((z_k - z_p).abs()[both].max()) <= 1e-5
    assert torch.equal(rk._launch_reach(adv, size, size),
                       rk.brute_reach_bbox_plain(adv, size, size))


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("tile", [16, 24, 40])
def test_cuda_tiled_attrs_kernels_match_plain_version_on_card(tile):
    """Both tiled-attrs kernels (per-(b, tile) grid and one mesh) at 240^2,
    chunk 128, B=2 and one mesh."""
    verts, faces, K, fv, attrs = icosphere_scene(K=(450.0, 450.0, 120.0, 120.0))
    fd, bb, ca = (x.cuda() for x in pack(verts, faces, K, fv, attrs))
    before = (rk.zbuffer_sweep_tiled_attrs_batched.launches,
              rk.zbuffer_sweep_tiled_attrs.launches)
    plain = rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, 240, 240, 128, tile)
    outs = [rk.zbuffer_sweep_tiled_attrs_batched(fd, bb, ca, 240, 240, 128, tile),
            [x[None] for x in rk.zbuffer_sweep_tiled_attrs(fd[0], bb[0], ca[0], 240, 240, 128,
                                                           tile)]]
    torch.cuda.synchronize()
    for out, n in zip(outs, (2, 1)):
        _assert_close(out, plain, n)
    assert (rk.zbuffer_sweep_tiled_attrs_batched.launches,
            rk.zbuffer_sweep_tiled_attrs.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("tile", [24, 40])
def test_cuda_culled_kernels_at_larger_tiles_on_card(tile):
    """The rows-attrs and culled z/fid kernels at a larger tile (240^2,
    B=2)."""
    verts, faces, K, fv, attrs = icosphere_scene(K=(450.0, 450.0, 120.0, 120.0))
    fd, bb, ca = (x.cuda() for x in pack(verts, faces, K, fv, attrs))
    plain = rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, 240, 240, 128, tile)
    out = rk.zbuffer_sweep_rows_attrs(fd, bb, ca, 240, 240, 128, tile)
    out2 = rk.zbuffer_sweep_tiled(fd, bb, 240, 240, 128, tile)
    torch.cuda.synchronize()
    _assert_close(out, plain)
    _assert_close(out2, plain)
