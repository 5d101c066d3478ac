"""The port's non-fused rasterizer and its z/fid sweeps against the JAX
package.

* The plain sweep `zbuffer_sweep_tiled_plain` (what the CPU runs and what
  the CUDA kernels of `zbuffer_sweep_tiled` and `zbuffer_sweep` are held to
  on the card) against the Pallas kernels `zbuffer_sweep_tiled` and
  `zbuffer_sweep` in interpret mode, one mesh per call as the JAX package
  runs them, on the same packed inputs: face_id exactly equal, z 1e-5 (the
  bounds of `tests/test_pallas_raster.py`).
* `rasterize` in every sweep mode, with and without per-pose face
  compaction, and `render_mesh_attributes`, against the JAX functions:
  face_id exact, zbuf and bary 1e-5.
* The wrappers: the plain version on a CPU tensor, no launch counted, bad
  inputs and unsupported devices raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import rnnpose_tpu.ops.pallas_raster as PR
from rnnpose_tpu.data.synthetic import make_icosphere
from rnnpose_tpu.render import mesh as jmesh
from rnnpose_tpu.render import raster as jraster
from rnnpose_tpu_torch.geometry import projective as tproj
from rnnpose_tpu_torch.ops import raster_kernels as rk
from rnnpose_tpu_torch.render import raster as traster

SCENES = {
    # (raster size, chunk, per-mesh offsets): object filling the raster, and
    # small objects off-centre (empty, partial and full tiles).
    "dense": (64, 128, ((0.0, 0.0, 0.5), (0.08, -0.05, 0.65))),
    "sparse": (96, 64, ((-0.15, -0.15, 0.9), (0.1, 0.12, 0.6))),
}


def _scene(h, offsets):
    """Icosphere meshes at B poses, as in tests/test_pallas_raster.py:
    verts (B, V, 3), faces (1024, 3), K (B, 4), face_valid (1024,)."""
    m = jmesh.pad_mesh(make_icosphere(2, 0.06), 256, 1024)
    verts = m.verts[None] + np.asarray(offsets, np.float32)[:, None, :]
    K = np.tile(np.asarray([[120.0, 120.0, h / 2.0, h / 2.0]], np.float32),
                (len(offsets), 1))
    return verts.astype(np.float32), m.faces, K, np.arange(1024) < m.num_faces


def _pack(verts, faces, K, fv):
    uv, _ = tproj.project(torch.from_numpy(verts), torch.from_numpy(K)[:, None, :])
    return traster.prepare_face_data(
        uv, torch.from_numpy(verts[..., 2]), torch.from_numpy(faces.astype(np.int64)),
        torch.from_numpy(fv))


def _torch(verts, faces, K, fv):
    return (torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64)),
            torch.from_numpy(K), torch.from_numpy(fv))


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas sweeps in interpret mode."""
    tiled, brute = PR.zbuffer_sweep_tiled, PR.zbuffer_sweep
    monkeypatch.setattr(PR, "zbuffer_sweep_tiled",
                        lambda *a, **k: tiled(*a, **k, interpret=True))
    monkeypatch.setattr(PR, "zbuffer_sweep", lambda *a, **k: brute(*a, **k, interpret=True))


@pytest.mark.parametrize("kernel", ["tiled", "brute"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_sweep_matches_pallas_interpret(scene, kernel, interpret):
    h, chunk, offsets = SCENES[scene]
    verts, faces, K, fv = _scene(h, offsets)
    fd, bb = _pack(verts, faces, K, fv)
    z_t, f_t = rk.zbuffer_sweep_tiled_plain(fd, bb, h, h, chunk=chunk)
    for b in range(fd.shape[0]):  # B=2: the Pallas kernels take one mesh
        fd_b = jnp.asarray(fd[b].numpy())
        if kernel == "tiled":
            z_j, f_j = PR.zbuffer_sweep_tiled(fd_b, jnp.asarray(bb[b].numpy()), h, h,
                                              chunk=chunk)
        else:
            z_j, f_j = PR.zbuffer_sweep(fd_b, h, h, chunk=chunk)
        np.testing.assert_array_equal(f_t[b].numpy(), np.asarray(f_j))
        np.testing.assert_allclose(z_t[b].numpy(), np.asarray(z_j), atol=1e-5)
    assert float((f_t >= 0).float().mean()) > 0.02
    assert float(z_t[f_t < 0].min()) == rk.FAR


def test_tie_rule_lowest_face_index_wins(interpret):
    """Each face duplicated at a later index (exact depth ties), one copy in
    another chunk: the lower index wins in the plain and Pallas sweeps."""
    verts, faces, K, fv = _scene(64, ((0.0, 0.0, 0.5),))
    n = 128
    dup = np.concatenate([faces[:n], faces[:n // 2], faces[:n // 2]], 0)
    fd, bb = _pack(verts, dup, K, np.ones(len(dup), bool))
    z_t, f_t = rk.zbuffer_sweep_tiled_plain(fd, bb, 64, 64, chunk=64)
    z_j, f_j = PR.zbuffer_sweep_tiled(jnp.asarray(fd[0].numpy()),
                                      jnp.asarray(bb[0].numpy()), 64, 64, chunk=64)
    np.testing.assert_array_equal(f_t[0].numpy(), np.asarray(f_j))
    assert (f_t >= 0).any() and int(f_t.max()) < n  # no duplicate ever wins


def _keep_mask(B, F, seed=7):
    """A per-pose keep mask (a stand-in for the backface test): about half
    the faces."""
    return np.random.RandomState(seed).rand(B, F) < 0.5


@pytest.mark.parametrize("compact", [False, True], ids=["all_faces", "compacted"])
@pytest.mark.parametrize("mode", [False, "tiled", True], ids=["plain", "tiled", "brute"])
def test_rasterize_matches_jax(mode, compact, interpret):
    """The port's `rasterize` against the JAX one in the same mode (the
    Pallas sweeps in interpret mode). Compacted: a per-pose keep mask and a
    budget of 128 faces, below the ~160 kept, so the budget also drops
    faces, as the JAX package's does."""
    h, chunk, offsets = SCENES["dense"]
    verts, faces, K, fv = _scene(h, offsets)
    kw = dict(face_keep=None, compact_to=None)
    if compact:
        kw = dict(face_keep=_keep_mask(2, 1024), compact_to=128)
    ref = jraster.rasterize(
        verts, jnp.asarray(faces), K, h, h, jnp.asarray(fv), chunk=64, use_pallas=mode,
        face_keep=None if kw["face_keep"] is None else jnp.asarray(kw["face_keep"]),
        compact_to=kw["compact_to"])
    v, f, k, valid = _torch(verts, faces, K, fv)
    out = traster.rasterize(
        v, f, k, h, h, valid, chunk=64, use_pallas=mode,
        face_keep=None if kw["face_keep"] is None else torch.from_numpy(kw["face_keep"]),
        compact_to=kw["compact_to"])
    assert out.face_id.dtype == torch.int32
    np.testing.assert_array_equal(out.face_id.numpy(), np.asarray(ref.face_id))
    np.testing.assert_allclose(out.zbuf.numpy(), np.asarray(ref.zbuf), atol=1e-5)
    np.testing.assert_allclose(out.bary.numpy(), np.asarray(ref.bary), atol=1e-5)
    fid = out.face_id.numpy()
    assert (fid >= 0).mean() > 0.05
    assert np.all(out.zbuf.numpy()[fid < 0] == 0.0)
    if compact:  # winners are original face indices of kept faces only
        b, y, x = np.nonzero(fid >= 0)
        assert kw["face_keep"][b, fid[b, y, x]].all()


def test_rasterize_any_size_matches_jax():
    """A 40x56 raster (not a multiple of the 16-pixel tile): the port sweeps
    it with the tiled sweep (the JAX package falls back to its scan)."""
    verts, faces, K, fv = _scene(48, SCENES["dense"][2])
    ref = jraster.rasterize(verts, jnp.asarray(faces), K, 40, 56, jnp.asarray(fv),
                            chunk=128, use_pallas="tiled")
    out = traster.rasterize(*_torch(verts, faces, K, fv)[:3], 40, 56,
                            torch.from_numpy(fv), chunk=128, use_pallas="tiled")
    np.testing.assert_array_equal(out.face_id.numpy(), np.asarray(ref.face_id))
    np.testing.assert_allclose(out.zbuf.numpy(), np.asarray(ref.zbuf), atol=1e-5)
    np.testing.assert_allclose(out.bary.numpy(), np.asarray(ref.bary), atol=1e-5)
    assert (out.face_id.numpy() >= 0).mean() > 0.05


def test_render_mesh_attributes_matches_jax():
    h, _, offsets = SCENES["dense"]
    verts, faces, K, fv = _scene(h, offsets)
    attrs = np.random.RandomState(8).randn(2, verts.shape[1], 5).astype(np.float32)
    ref = jraster.render_mesh_attributes(verts, jnp.asarray(faces), K, attrs, h, h,
                                         jnp.asarray(fv), chunk=128)
    v, f, k, valid = _torch(verts, faces, K, fv)
    out = traster.render_mesh_attributes(v, f, k, torch.from_numpy(attrs), h, h, valid,
                                         chunk=128)
    for a, b, tol in zip(out, ref, (1e-4, 1e-5, 0.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    h, chunk, offsets = SCENES["sparse"]
    fd, bb = _pack(*_scene(h, offsets))
    before = rk.zbuffer_sweep_tiled.launches, rk.zbuffer_sweep.launches
    plain = rk.zbuffer_sweep_tiled_plain(fd, bb, h, h, chunk)
    for out in (rk.zbuffer_sweep_tiled(fd, bb, h, h, chunk), rk.zbuffer_sweep(fd, h, h, chunk)):
        for a, b in zip(out, plain):
            assert torch.equal(a, b)
    assert (rk.zbuffer_sweep_tiled.launches, rk.zbuffer_sweep.launches) == before


def test_wrappers_reject_bad_inputs_and_devices():
    h, chunk, offsets = SCENES["sparse"]
    fd, bb = _pack(*_scene(h, offsets))
    with pytest.raises(TypeError):
        rk.zbuffer_sweep_tiled(fd.double(), bb, h, h)
    with pytest.raises(ValueError):
        rk.zbuffer_sweep_tiled(fd, bb[:, :-1], h, h)
    with pytest.raises(ValueError):
        rk.zbuffer_sweep_tiled(fd, None, h, h)
    with pytest.raises(ValueError):
        rk.zbuffer_sweep(fd, h, h, chunk=100)
    # Neither a CPU nor a CUDA tensor: no plain fallback, no launch.
    with pytest.raises(ValueError, match="unsupported device"):
        rk.zbuffer_sweep_tiled(fd.to("meta"), bb.to("meta"), h, h)
    with pytest.raises(ValueError, match="unsupported device"):
        rk.zbuffer_sweep(fd.to("meta"), h, h)
    verts, faces, K, fv = _scene(h, offsets)
    with pytest.raises(ValueError, match="use_pallas"):
        traster.rasterize(*_torch(verts, faces, K, fv)[:3], h, h, use_pallas="mxu")


def test_kernel_sources_are_in_the_package():
    """Both CUDA sources and their shared header ship with the package."""
    for src in rk.KERNEL_SOURCES:
        text = src.read_text()
        assert '#include "raster_sweep.cuh"' in text and "extern \"C\"" in text
    assert (rk.TILED_SOURCE.parent / "raster_sweep.cuh").exists()
