"""The port's rasterizer and its raster sweep against the JAX package.

* The plain sweep (`zbuffer_sweep_rows_attrs_plain`, what the CPU runs and
  what the CUDA kernel is held to on the card) against the Pallas kernel
  `zbuffer_sweep_rows_attrs_batched` in interpret mode, on the same packed
  inputs: face_id exactly equal, z 1e-5, attrs 1e-4 (the bounds of
  `tests/test_pallas_raster.py`).
* Tie rule: the nearest depth wins; on an exact depth tie the lowest face
  index wins (first minimum in a chunk, strict `<` across chunks).
* The packing, `rasterize_with_vis_attrs`, `compute_bary` and the
  gather-form interpolation against the JAX functions.
* The scenes of `test_torch_port_cuda.py` (the card's jax-free tests),
  built by the port alone, equal to this file's JAX-built ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from rnnpose_tpu.data.synthetic import make_icosphere as j_icosphere
from rnnpose_tpu.geometry import projective as jproj
from rnnpose_tpu.ops.pallas_raster import zbuffer_sweep_rows_attrs_batched
from rnnpose_tpu.render import mesh as jmesh
from rnnpose_tpu.render import raster as jraster
from rnnpose_tpu.render import shading as jshading
from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.data.synthetic import make_icosphere
from rnnpose_tpu_torch.geometry import projective as tproj
from rnnpose_tpu_torch.kernels import raster as rk
from rnnpose_tpu_torch.render import mesh as tmesh
from rnnpose_tpu_torch.render import raster as traster
from rnnpose_tpu_torch.render import shading as tshading


def _scene(B=2, h=64, offsets=((0.0, 0.0, 0.5), (0.08, -0.05, 0.65))):
    """Icosphere meshes at B poses, as in tests/test_pallas_raster.py."""
    m = jmesh.pad_mesh(j_icosphere(2, 0.06), 256, 1024)
    verts = m.verts[None] + np.asarray(offsets[:B], np.float32)[:, None, :]
    K = np.tile(np.asarray([[120.0, 120.0, h / 2.0, h / 2.0]], np.float32), (B, 1))
    fv = np.arange(1024) < m.num_faces
    attrs = np.random.RandomState(3).randn(B, 256, 6).astype(np.float32)
    return verts.astype(np.float32), m.faces, K, fv, attrs


def _port_pack(verts, faces, K, fv, attrs):
    uv, _ = tproj.project(torch.from_numpy(verts), torch.from_numpy(K)[:, None, :])
    f = torch.from_numpy(faces.astype(np.int64))
    face_data, bbox = traster.prepare_face_data(
        uv, torch.from_numpy(verts[..., 2]), f, torch.from_numpy(fv))
    return face_data, bbox, torch.from_numpy(attrs)[:, f].contiguous()


def _jax_pack(verts, faces, K, fv):
    """The JAX package's packing (`raster.py` `_prep_single`)."""
    uv, _ = jproj.project(jnp.asarray(verts), jnp.asarray(K)[:, None, :])

    def one(uv_b, z_b):
        ec, zf, valid, area2 = jraster._face_screen_data(
            uv_b, z_b, jnp.asarray(faces), jnp.asarray(fv))
        inv = jnp.where(valid, 1.0 / jnp.where(valid, area2, 1.0), 0.0)
        coef = ec * inv[:, None, None]
        zcoef = jnp.einsum("fkc,fk->fc", coef, zf)
        F = faces.shape[0]
        fd = jnp.concatenate([coef.reshape(F, 9), zcoef,
                              valid.astype(jnp.float32)[:, None],
                              jnp.zeros((F, 3))], -1)
        fuv = uv_b[jnp.asarray(faces)]
        big = jnp.float32(1e9)
        bb = jnp.concatenate([jnp.where(valid[:, None], fuv.min(1), big),
                              jnp.where(valid[:, None], fuv.max(1), -big)], -1)
        return fd, bb

    return jax.vmap(one)(uv, jnp.asarray(verts[..., 2]))


def _assert_sweeps_equal(out_t, out_j):
    z_t, f_t, a_t = (x.numpy() for x in out_t)
    z_j, f_j, a_j = (np.asarray(x) for x in out_j)
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_allclose(z_t, z_j, atol=1e-5)
    np.testing.assert_allclose(a_t, a_j, atol=1e-4)


def test_plain_sweep_matches_pallas_interpret():
    verts, faces, K, fv, attrs = _scene()
    fd, bb, ca = _port_pack(verts, faces, K, fv, attrs)
    out_t = rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, 64, 64, chunk=128)
    out_j = zbuffer_sweep_rows_attrs_batched(
        jnp.asarray(fd.numpy()), jnp.asarray(bb.numpy()), jnp.asarray(ca.numpy()),
        64, 64, chunk=128, tile=16, interpret=True)
    _assert_sweeps_equal(out_t, out_j)
    cover = (out_t[1] >= 0).float().mean(dim=(1, 2))
    assert float(cover.min()) > 0.05
    assert float(out_t[0][out_t[1] < 0].min()) == rk.FAR


def test_plain_sweep_sparse_tiles_matches_pallas_interpret():
    """Small objects off-centre in a 96^2 raster: empty, partial and full
    tiles, chunk 64."""
    verts, faces, K, fv, attrs = _scene(
        B=2, h=96, offsets=((-0.15, -0.15, 0.9), (0.1, 0.12, 0.6)))
    fd, bb, ca = _port_pack(verts, faces, K, fv, attrs)
    out_t = rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, 96, 96, chunk=64)
    out_j = zbuffer_sweep_rows_attrs_batched(
        jnp.asarray(fd.numpy()), jnp.asarray(bb.numpy()), jnp.asarray(ca.numpy()),
        96, 96, chunk=64, tile=16, interpret=True)
    _assert_sweeps_equal(out_t, out_j)
    assert float((out_t[1] >= 0).float().mean()) > 0.02


def test_tie_rule_lowest_face_index_wins():
    """Each face duplicated at a later index (exact depth ties), one copy
    in another chunk: the lower index wins in both implementations."""
    verts, faces, K, fv, attrs = _scene(B=1)
    n = 128
    dup = np.concatenate([faces[:n], faces[:n // 2], faces[:n // 2]], 0)
    fvd = np.ones(len(dup), bool)
    fd, bb, ca = _port_pack(verts, dup, K, fvd, attrs)
    out_t = rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, 64, 64, chunk=64)
    out_j = zbuffer_sweep_rows_attrs_batched(
        jnp.asarray(fd.numpy()), jnp.asarray(bb.numpy()), jnp.asarray(ca.numpy()),
        64, 64, chunk=64, tile=16, interpret=True)
    _assert_sweeps_equal(out_t, out_j)
    fid = out_t[1].numpy()
    assert (fid >= 0).any() and fid.max() < n  # no duplicate ever wins


def test_face_data_packing_matches_jax():
    verts, faces, K, fv, attrs = _scene()
    fd_t, bb_t, _ = _port_pack(verts, faces, K, fv, attrs)
    fd_j, bb_j = _jax_pack(verts, faces, K, fv)
    np.testing.assert_allclose(fd_t.numpy(), np.asarray(fd_j), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(bb_t.numpy(), np.asarray(bb_j), atol=1e-5, rtol=1e-6)


def test_rasterize_with_vis_attrs_matches_jax():
    """The port (CPU: plain sweep) against the JAX function on the CPU
    (unfused scan raster + gather) and through the Pallas kernel."""
    verts, faces, K, fv, attrs = _scene()
    out_t = traster.rasterize_with_vis_attrs(
        torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64)),
        torch.from_numpy(K), torch.from_numpy(attrs), 64, 64,
        face_valid=torch.from_numpy(fv), chunk=128)
    a_t, z_t, f_t = (x.numpy() for x in out_t)
    for use_pallas in (None, "interpret"):
        if use_pallas is None:
            out_j = jraster.rasterize_with_vis_attrs(
                verts, jnp.asarray(faces), K, attrs, 64, 64, jnp.asarray(fv), chunk=128)
        else:
            import rnnpose_tpu.ops.pallas_raster as PR

            orig = PR.zbuffer_sweep_rows_attrs_batched

            def interp(*a, **k):
                return orig(*a, **k, interpret=True)

            PR.zbuffer_sweep_rows_attrs_batched = interp
            try:
                out_j = jraster.rasterize_with_vis_attrs(
                    verts, jnp.asarray(faces), K, attrs, 64, 64, jnp.asarray(fv),
                    chunk=128, use_pallas=True)
            finally:
                PR.zbuffer_sweep_rows_attrs_batched = orig
        a_j, z_j, f_j = (np.asarray(x) for x in out_j)
        np.testing.assert_array_equal(f_t, f_j)
        np.testing.assert_allclose(z_t, z_j, atol=1e-5)
        np.testing.assert_allclose(a_t, a_j, atol=1e-4)
    assert np.all(z_t[f_t < 0] == 0.0) and np.all(a_t[f_t < 0] == 0.0)


def test_compute_bary_and_gather_interpolation_match_jax():
    verts, faces, K, fv, attrs = _scene()
    fj = jnp.asarray(faces)
    frags = jraster.rasterize(verts, fj, K, 64, 64, jnp.asarray(fv), chunk=128,
                              use_pallas=False)
    fid_lr = np.array(frags.face_id[:, 4::8, 4::8])
    gx = np.arange(8, dtype=np.float32) * 8.0 + 4.5
    pix = np.stack(np.meshgrid(gx, gx, indexing="xy"), -1)
    bary_j = jraster.compute_bary(verts, fj, K, fid_lr, pix, jnp.asarray(fv))
    ft = torch.from_numpy(faces.astype(np.int64))
    bary_t = traster.compute_bary(
        torch.from_numpy(verts), ft, torch.from_numpy(K),
        torch.from_numpy(fid_lr), torch.from_numpy(pix), torch.from_numpy(fv))
    np.testing.assert_allclose(bary_t.numpy(), np.asarray(bary_j), atol=1e-5)

    feats = np.random.RandomState(5).randn(2, 256, 13).astype(np.float32)
    frags_lr = jraster.Fragments(face_id=jnp.asarray(fid_lr), bary=bary_j,
                                 zbuf=frags.zbuf[:, 4::8, 4::8])
    ref = jraster.interpolate_attributes_onehot(frags_lr, fj, feats)
    out = traster.interpolate_attributes(
        traster.Fragments(torch.from_numpy(fid_lr), bary_t, None), ft,
        torch.from_numpy(feats))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert (fid_lr >= 0).mean() > 0.1


def test_sweep_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    verts, faces, K, fv, attrs = _scene()
    fd, bb, ca = _port_pack(verts, faces, K, fv, attrs)
    before = kernels.LAUNCHES["zbuffer_sweep_rows_attrs"]
    out_w = rk.zbuffer_sweep_rows_attrs(fd, bb, ca, 64, 64, chunk=128)
    out_p = rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, 64, 64, chunk=128)
    assert kernels.LAUNCHES["zbuffer_sweep_rows_attrs"] == before
    for a, b in zip(out_w, out_p):
        assert torch.equal(a, b)


def test_sweep_wrapper_rejects_bad_inputs():
    verts, faces, K, fv, attrs = _scene()
    fd, bb, ca = _port_pack(verts, faces, K, fv, attrs)
    with pytest.raises(TypeError):
        rk.zbuffer_sweep_rows_attrs(fd.double(), bb, ca, 64, 64)
    with pytest.raises(ValueError):
        rk.zbuffer_sweep_rows_attrs(fd, bb[:, :-1], ca, 64, 64)
    with pytest.raises(ValueError):
        rk.zbuffer_sweep_rows_attrs(fd, bb, ca, 60, 64)
    with pytest.raises(ValueError):
        rk.zbuffer_sweep_rows_attrs(fd, bb, ca, 64, 64, chunk=100)


def test_mesh_preparation_matches_jax():
    """The numpy mesh pipeline (simplify, orient, Morton order, pad) and the
    vertex normals are copies: equal arrays."""
    mt = make_icosphere(3, 0.06)
    mj = j_icosphere(3, 0.06)
    for a, b in ((mt.verts, mj.verts), (mt.faces, mj.faces), (mt.vert_colors, mj.vert_colors)):
        np.testing.assert_array_equal(a, b)
    mt = tmesh.pad_mesh(tmesh.orient_faces_outward(tmesh.simplify_mesh(mt, 256, 512)), 256, 512)
    mj = jmesh.pad_mesh(jmesh.orient_faces_outward(jmesh.simplify_mesh(mj, 256, 512)), 256, 512)
    assert (mt.num_verts, mt.num_faces) == (mj.num_verts, mj.num_faces)
    for a, b in ((mt.verts, mj.verts), (mt.faces, mj.faces), (mt.vert_colors, mj.vert_colors)):
        np.testing.assert_array_equal(a, b)
    nf = mt.faces[: mt.num_faces]
    np.testing.assert_array_equal(tshading.compute_vertex_normals(mt.verts, nf),
                                  jshading.compute_vertex_normals(mj.verts, nf))


def test_headlight_shade_matches_jax():
    rs = np.random.RandomState(6)
    col = rs.rand(2, 5, 5, 3).astype(np.float32)
    nrm = rs.randn(2, 5, 5, 3).astype(np.float32)
    nrm[0, 0, 0] = 0.0  # zero normal: clamped norm
    np.testing.assert_allclose(
        tshading.headlight_shade(torch.from_numpy(col), torch.from_numpy(nrm)).numpy(),
        np.asarray(jshading.headlight_shade(col, nrm)), atol=1e-6)


def test_card_test_scenes_equal_the_jax_built_ones():
    """`test_torch_port_cuda.py` rebuilds the icosphere scenes of the raster
    tests with the port's own mesh code: bit-equal verts, faces, face
    validity and attrs, and equal packed sweep inputs."""
    import test_torch_port_cuda as card

    verts, faces, K, fv, attrs = _scene()
    got = card.icosphere_scene()
    for a, b in zip((verts, faces, K, fv, attrs), got):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_port_pack(verts, faces, K, fv, attrs), card.pack(*got)):
        assert torch.equal(a, b)
