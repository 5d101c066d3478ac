"""The fused attribute sweeps at every pixel tile and on the per-(b, tile)
grid, and the tile/grid choice, against the JAX package.

* The plain versions of `zbuffer_sweep_tiled_attrs_batched` and
  `zbuffer_sweep_tiled_attrs` (what the CPU runs and what their CUDA kernel
  is held to on the card) against the Pallas kernels in interpret mode, the
  pattern of tests/test_pallas_raster.py:102-148 and :191-237: the `tile`
  grid at B=2 through `rasterize_with_vis_attrs`, and tiles 24/32/40 at
  48/64/80 pixels. face_id exactly equal, z 1e-5, attrs 1e-4.
* `_pick_tile` and the fused/unfused choice of `rasterize_with_vis_attrs`
  equal to the JAX module's over a grid of (RNNPOSE_RASTER_TILE, h, w,
  chunk), with both modules' prefs monkeypatched; the environment
  variables are read once, at import.
* The wrappers on the CPU and the tile checks. The kernel-vs-plain tests
  on the card are in `test_torch_port_cuda.py`, which imports no jax.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import rnnpose_tpu.ops.pallas_raster as PR
from rnnpose_tpu.data.synthetic import make_icosphere
from rnnpose_tpu.render import mesh as jmesh
from rnnpose_tpu.render import raster as jraster
from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.geometry import projective as tproj
from rnnpose_tpu_torch.kernels import raster as rk
from rnnpose_tpu_torch.render import raster as traster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(offsets, K):
    """Icosphere meshes at B poses, as in tests/test_pallas_raster.py, with
    seeded D=6 vertex attributes: verts (B, V, 3), faces, K (B, 4),
    face_valid (1024,), attrs (B, V, 6)."""
    m = jmesh.pad_mesh(make_icosphere(2, 0.06), 256, 1024)
    verts = (m.verts[None] + np.asarray(offsets, np.float32)[:, None, :]).astype(np.float32)
    K = np.tile(np.asarray([K], np.float32), (len(offsets), 1))
    attrs = np.random.RandomState(3).randn(len(offsets), verts.shape[1], 6).astype(np.float32)
    return verts, m.faces, K, np.arange(1024) < m.num_faces, attrs


def _pack(verts, faces, K, fv, attrs):
    """The sweeps' inputs, packed by the port (tests/test_torch_port_raster.py
    holds the packing to the JAX package's)."""
    uv, _ = tproj.project(torch.from_numpy(verts), torch.from_numpy(K)[:, None, :])
    ft = torch.from_numpy(faces.astype(np.int64))
    fd, bb = traster.prepare_face_data(uv, torch.from_numpy(verts[..., 2]), ft,
                                       torch.from_numpy(fv))
    return fd, bb, torch.from_numpy(attrs)[:, ft].contiguous()


def _check(out_t, out_j):
    (z_t, f_t, a_t), (z_j, f_j, a_j) = out_t, (np.asarray(x) for x in out_j)
    np.testing.assert_array_equal(f_t.numpy(), f_j)
    np.testing.assert_allclose(z_t.numpy(), z_j, atol=1e-5)
    np.testing.assert_allclose(a_t.numpy(), a_j[..., :a_t.shape[-1]], atol=1e-4)
    assert float((f_t >= 0).float().mean()) > 0.02


@pytest.mark.parametrize("tile,hw", [(24, 48), (32, 64), (40, 80)])
def test_tiled_attrs_plain_matches_pallas_at_tile(tile, hw):
    """The one-mesh sweep at a larger tile (the JAX package's
    test_tiled_sweep_larger_tiles): the wrapper on a CPU tensor runs the
    plain version and counts no launch."""
    verts, faces, K, fv, attrs = _scene([(0.0, 0.0, 0.5)], (1.6 * hw, 1.6 * hw, hw / 2, hw / 2))
    fd, bb, ca = (x[0] for x in _pack(verts, faces, K, fv, attrs))
    before = kernels.LAUNCHES["zbuffer_sweep_tiled_attrs"]
    out_t = rk.zbuffer_sweep_tiled_attrs(fd, bb, ca, hw, hw, chunk=128, tile=tile)
    assert kernels.LAUNCHES["zbuffer_sweep_tiled_attrs"] == before
    out_j = PR.zbuffer_sweep_tiled_attrs(
        jnp.asarray(fd.numpy()), jnp.asarray(bb.numpy()), jnp.asarray(ca.numpy()), hw, hw,
        chunk=128, tile=tile, interpret=True)
    _check(out_t, out_j)
    for a, b in zip(out_t, rk.zbuffer_sweep_tiled_attrs_plain(fd, bb, ca, hw, hw, 128, tile)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [16, 32])
def test_tiled_attrs_batched_plain_matches_pallas(tile):
    """B=2 at two poses (the per-(b, tile) grid), chunk 64, 64^2."""
    verts, faces, K, fv, attrs = _scene([(0.0, 0.0, 0.5), (0.08, -0.05, 0.65)],
                                        (120.0, 120.0, 32.0, 32.0))
    fd, bb, ca = _pack(verts, faces, K, fv, attrs)
    out_t = rk.zbuffer_sweep_tiled_attrs_batched(fd, bb, ca, 64, 64, chunk=64, tile=tile)
    out_j = PR.zbuffer_sweep_tiled_attrs_batched(
        jnp.asarray(fd.numpy()), jnp.asarray(bb.numpy()), jnp.asarray(ca.numpy()), 64, 64,
        chunk=64, tile=tile, interpret=True)
    _check(out_t, out_j)


@pytest.fixture
def tile_grid(monkeypatch):
    """Both rasterizers on the per-(b, tile) grid; the JAX package's Pallas
    kernel in interpret mode."""
    orig = PR.zbuffer_sweep_tiled_attrs_batched
    monkeypatch.setattr(PR, "zbuffer_sweep_tiled_attrs_batched",
                        lambda *a, **k: orig(*a, **k, interpret=True))
    monkeypatch.setattr(jraster, "_GRID_PREF", "tile")
    monkeypatch.setattr(traster, "_GRID_PREF", "tile")


def test_rasterize_with_vis_attrs_tile_grid_matches_jax(tile_grid, monkeypatch):
    """The fused branch on the `tile` grid at B=2 (the JAX package's
    test_tiled_attrs_fused_matches_unfused[tile]): the port calls
    `zbuffer_sweep_tiled_attrs_batched`, the JAX package its Pallas kernel."""
    calls = []
    wrapped = traster.zbuffer_sweep_tiled_attrs_batched
    monkeypatch.setattr(traster, "zbuffer_sweep_tiled_attrs_batched",
                        lambda *a, **k: calls.append(k["tile"]) or wrapped(*a, **k))
    verts, faces, K, fv, attrs = _scene([(0.0, 0.0, 0.5), (0.08, -0.05, 0.65)],
                                        (120.0, 120.0, 32.0, 32.0))
    out_j = jraster.rasterize_with_vis_attrs(verts, jnp.asarray(faces), K, attrs, 64, 64,
                                             jnp.asarray(fv), chunk=128, use_pallas=True)
    a_t, z_t, f_t = traster.rasterize_with_vis_attrs(
        torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64)), torch.from_numpy(K),
        torch.from_numpy(attrs), 64, 64, face_valid=torch.from_numpy(fv), chunk=128)
    assert calls == [16]
    a_j, z_j, f_j = (np.asarray(x) for x in out_j)
    np.testing.assert_array_equal(f_t.numpy(), f_j)
    np.testing.assert_allclose(z_t.numpy(), z_j, atol=1e-5)
    np.testing.assert_allclose(a_t.numpy(), a_j, atol=1e-4)
    assert (f_t.numpy() >= 0).mean() > 0.05


PREFS = [None, "16", "24", "32", "40", "52", "64"]


@pytest.mark.parametrize("pref", PREFS)
def test_pick_tile_equals_jax(pref, monkeypatch):
    monkeypatch.setattr(jraster, "_TILE_PREF", pref)
    monkeypatch.setattr(traster, "_TILE_PREF", pref)
    for h in (48, 64, 80, 96, 120, 232, 240):
        for w in (48, 80, 240):
            for chunk in (32, 64, 128, 256):
                assert traster._pick_tile(h, w, chunk) == jraster._pick_tile(h, w, chunk), (
                    h, w, chunk)
    # At the main path's 240^2 crop and chunk 128:
    expect = {None: 16, "16": 16, "24": 24, "32": None, "40": 40, "52": None, "64": None}
    assert traster._pick_tile(240, 240, 128) == expect[pref]


def _spy_jax(monkeypatch, calls):
    """Record which sweep the JAX rasterize_with_vis_attrs runs (its fused
    kernels and its unfused scan raster are replaced by stubs of the right
    shapes)."""
    def stub(name):
        def fn(face_data, bbox, corner_attrs, h, w, chunk=128, tile=16, **_):
            calls.append((name, tile))
            B, D = face_data.shape[0], corner_attrs.shape[-1]
            return (jnp.zeros((B, h, w)), jnp.full((B, h, w), -1, jnp.int32),
                    jnp.zeros((B, h, w, D)))
        return fn

    for name in ("zbuffer_sweep_tiled_attrs_batched", "zbuffer_sweep_rows_attrs_batched"):
        monkeypatch.setattr(PR, name, stub(name))
    def unfused(uv, z, faces, face_valid, h, w, *_):
        calls.append(("unfused", None))
        return (jnp.full((h, w), -1, jnp.int32), jnp.zeros((h, w, 3)), jnp.zeros((h, w)))
    monkeypatch.setattr(jraster, "_rasterize_single", unfused)


def _spy_port(monkeypatch, calls):
    for name in ("zbuffer_sweep_tiled_attrs_batched", "zbuffer_sweep_rows_attrs"):
        orig = getattr(traster, name)

        def fn(*a, _name=name, _orig=orig, **k):
            calls.append((_name, k["tile"]))
            return _orig(*a, **k)
        monkeypatch.setattr(traster, name, fn)
    orig_r = traster.rasterize
    monkeypatch.setattr(traster, "rasterize",
                        lambda *a, **k: calls.append(("unfused", None)) or orig_r(*a, **k))


@pytest.mark.parametrize("grid", ["rows", "tile"])
@pytest.mark.parametrize("pref", [None, "24", "40", "64"])
def test_fused_or_unfused_choice_equals_jax(pref, grid, monkeypatch):
    """Per (tile pref, grid, raster size, chunk): the same branch, the same
    fused kernel (rows or tile grid) and the same tile in both packages."""
    for mod in (jraster, traster):
        monkeypatch.setattr(mod, "_TILE_PREF", pref)
        monkeypatch.setattr(mod, "_GRID_PREF", grid)
    calls_j, calls_t = [], []
    _spy_jax(monkeypatch, calls_j)
    _spy_port(monkeypatch, calls_t)
    verts, faces, K, fv, attrs = _scene([(0.0, 0.0, 0.5)], (60.0, 60.0, 24.0, 24.0))
    names = {"zbuffer_sweep_tiled_attrs_batched": "tile", "zbuffer_sweep_rows_attrs": "rows",
             "zbuffer_sweep_rows_attrs_batched": "rows", "unfused": "unfused"}
    for size in (48, 40, 120):
        for chunk in (64, 128, 256):
            del calls_j[:], calls_t[:]
            jraster.rasterize_with_vis_attrs(verts, jnp.asarray(faces), K, attrs, size, size,
                                             jnp.asarray(fv), chunk=chunk, use_pallas=True)
            traster.rasterize_with_vis_attrs(
                torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64)),
                torch.from_numpy(K), torch.from_numpy(attrs), size, size,
                face_valid=torch.from_numpy(fv), chunk=chunk)
            got_j = [(names[n], t) for n, t in calls_j]
            got_t = [(names[n], t) for n, t in calls_t]
            assert got_t == got_j, (size, chunk, got_t, got_j)
            expect = jraster._pick_tile(size, size, chunk)
            assert got_t == [("unfused", None) if expect is None else (grid, expect)]


def test_env_variables_are_read_at_import():
    code = textwrap.dedent("""
        import os
        from rnnpose_tpu_torch.render import raster
        os.environ["RNNPOSE_RASTER_TILE"] = "24"      # too late: read at import
        os.environ["RNNPOSE_RASTER_GRID"] = "rows"
        print(raster._TILE_PREF, raster._GRID_PREF, raster._pick_tile(240, 240, 128),
              raster._pick_tile(240, 240, 256), raster._pick_tile(232, 232, 128))
    """)
    env = dict(os.environ, PYTHONPATH=REPO, RNNPOSE_RASTER_TILE="40",
               RNNPOSE_RASTER_GRID="tile")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["40", "tile", "40", "None", "None"]


def test_env_tile_60_renders_and_matches_jax():
    """RNNPOSE_RASTER_TILE=60 at chunk 64 on a 120^2 raster: `_pick_tile`
    gives 60 in both packages (60^2 * 64 * 24 B <= 8 MiB). The port's fused
    branch (`rasterize_with_vis_attrs`) and `rasterize` render at that tile
    and agree with the JAX package on the CPU: face ids exact, z and
    barycentrics 1e-5, attrs 1e-4."""
    code = textwrap.dedent("""
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp, numpy as np, torch
        from rnnpose_tpu.data.synthetic import make_icosphere
        from rnnpose_tpu.render import mesh as jmesh, raster as jraster
        from rnnpose_tpu_torch.render import raster as traster
        torch.set_num_threads(1)
        assert traster._pick_tile(120, 120, 64) == jraster._pick_tile(120, 120, 64) == 60
        m = jmesh.pad_mesh(make_icosphere(2, 0.06), 256, 1024)
        verts = (m.verts[None] + np.asarray([[0.01, -0.01, 0.5]], np.float32)[:, None]
                 ).astype(np.float32)
        K = np.asarray([[220.0, 220.0, 60.0, 60.0]], np.float32)
        fv = np.arange(1024) < m.num_faces
        attrs = np.random.RandomState(3).randn(1, 256, 6).astype(np.float32)
        t = lambda a: torch.from_numpy(np.asarray(a))
        ft = t(m.faces.astype(np.int64))
        a_t, z_t, f_t = traster.rasterize_with_vis_attrs(
            t(verts), ft, t(K), t(attrs), 120, 120, face_valid=t(fv), chunk=64)
        a_j, z_j, f_j = (np.asarray(x) for x in jraster.rasterize_with_vis_attrs(
            verts, jnp.asarray(m.faces), K, attrs, 120, 120, jnp.asarray(fv), chunk=64))
        assert (f_t.numpy() >= 0).sum() > 500
        np.testing.assert_array_equal(f_t.numpy(), f_j)
        np.testing.assert_allclose(z_t.numpy(), z_j, atol=1e-5)
        np.testing.assert_allclose(a_t.numpy(), a_j, atol=1e-4)
        fr_t = traster.rasterize(t(verts), ft, t(K), 120, 120, face_valid=t(fv), chunk=64)
        fr_j = jraster.rasterize(verts, jnp.asarray(m.faces), K, 120, 120, jnp.asarray(fv),
                                 chunk=64, use_pallas=False)
        np.testing.assert_array_equal(fr_t.face_id.numpy(), np.asarray(fr_j.face_id))
        np.testing.assert_allclose(fr_t.zbuf.numpy(), np.asarray(fr_j.zbuf), atol=1e-5)
        np.testing.assert_allclose(fr_t.bary.numpy(), np.asarray(fr_j.bary), atol=1e-5)
        print("TILE60_OK", int((f_t.numpy() >= 0).sum()))
    """)
    env = dict(os.environ, PYTHONPATH=REPO, RNNPOSE_RASTER_TILE="60", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "TILE60_OK" in res.stdout


def test_pixels_per_thread_and_tile_checks():
    # The culled sweep's CTA covers a fixed 32 x 32 block whatever the tile
    # (the tile only checks divisibility, as the TPU kernels do), so tiles
    # above 53, which `_pick_tile` returns at small chunks, are taken; only a
    # tile that is not a positive int raises.
    assert [rk.pixels_per_thread(t) for t in (16, 24, 32, 40, 52, 53, 54, 64)] == [
        1, 3, 4, 7, 11, 11, 12, 16]
    verts, faces, K, fv, attrs = _scene([(0.0, 0.0, 0.5)], (120.0, 120.0, 32.0, 32.0))
    fd, bb, ca = _pack(verts, faces, K, fv, attrs)
    plain = rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, 64, 64)
    for big in (54, 64):
        assert torch.equal(rk.zbuffer_sweep_tiled(fd, bb, 64, 64, tile=big)[1], plain[1])
    assert torch.equal(rk.zbuffer_sweep_tiled_attrs_batched(fd, bb, ca, 64, 64, tile=64)[1],
                       plain[1])
    for bad in (0, -16, 16.0):
        with pytest.raises(ValueError, match="tile"):
            rk.zbuffer_sweep_tiled_attrs_batched(fd, bb, ca, 64, 64, tile=bad)
        with pytest.raises(ValueError, match="tile"):
            rk.zbuffer_sweep_tiled(fd, bb, 64, 64, tile=bad)
    with pytest.raises(ValueError, match="multiples of tile=24"):
        rk.zbuffer_sweep_rows_attrs(fd, bb, ca, 64, 64, tile=24)
    with pytest.raises(ValueError, match="multiples of tile=24"):
        rk.zbuffer_sweep_tiled_attrs(fd[0], bb[0], ca[0], 64, 64, tile=24)
    with pytest.raises(ValueError, match="one mesh"):
        rk.zbuffer_sweep_tiled_attrs(fd, bb, ca, 64, 64)
    # The z/fid sweep takes any raster size at any tile (partial edge tiles).
    z, fid = rk.zbuffer_sweep_tiled(fd, bb, 60, 52, tile=24)
    assert torch.equal(fid, rk.zbuffer_sweep_tiled_plain(fd, bb, 60, 52)[1])
    with pytest.raises(ValueError, match="unsupported device"):
        rk.zbuffer_sweep_tiled_attrs_batched(fd.to("meta"), bb.to("meta"), ca.to("meta"), 64, 64)
    assert rk.TILED_ATTRS_SOURCE in kernels.SOURCES
    assert "rnnpose_raster_tiled_attrs" in rk.TILED_ATTRS_SOURCE.read_text()
