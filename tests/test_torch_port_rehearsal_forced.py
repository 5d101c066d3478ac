"""The full-budget rehearsal one render iteration at a time: each render
iteration of the port starts from the JAX refiner's own pose at that point,
so no drift of earlier iterations enters, and is held to the `slow` test's
bounds (`test_torch_port_rehearsal.py`: crop intrinsics 1e-5 relative, flow
2e-2 px, relative pose 5e-4, end pose 5e-4).

The budget is `bench.py`'s operating point: 3 render x 4 GRU x 1 LM, a
320^2 image and a 240^2 crop, the 2048 / 4096 icosphere of
`tools/full_budget_rehearsal.build_scene`, f32, the similarity and the LM at
full resolution; the JAX refiner jitted on its CPU scan raster with
PRNGKey(0) weights, converted for the port. For render iteration r the port
runs one render iteration from `Ti_history[4 r]` (the JAX refiner's pose at
the start of render r); its four inner steps are compared with JAX's steps
4r .. 4r+3 and its final pose with JAX's at the start of render r + 1 (the
JAX `Ti_pred` after the last).

Beside it:
  * the same with `project` and the face setup rounded as the jitted JAX
    refiner rounds them (XLA's contracted multiply-adds), the forms the port
    keeps uncontracted on purpose so that the two faces of an edge agree;
  * the raster at each of those poses: with those forms the port's face ids
    equal the JAX raster's; with its own, at every pixel whose depth differs
    by more than 1e-2 the port's depth is the f64 z-buffer's and the JAX
    raster sees a farther face (a crack between two faces);
  * the decomposition on the JAX side: the JAX refiner jitted at one render
    iteration from each of those poses equals the full run's slice bit for
    bit.
"""
import numpy as np
import pytest

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from _torch_port_rehearsal_common import (
    BOUNDS, XLA_FACE, _jax_run, forced_maxima, forced_render, patched, port_refiner,
    raster_cracks)
from rnnpose_tpu_torch.tools import full_budget_rehearsal as R

RI, GI, ZOOM, CHUNK = 3, 4, 240, 128


@pytest.fixture(scope="module")
def full():
    """(scene, the free-running JAX refiner's outputs, its weights, the
    port's one-render refiner holding them)."""
    scene = R.build_scene(320, 4, 2048, 4096)
    jouts, _, params = _jax_run(scene, RI, GI, ZOOM, CHUNK)
    return scene, jouts, params, port_refiner(params, 1, GI, ZOOM, CHUNK)


def _over(maxima, r):
    return {f"render {r} {k}": (v, BOUNDS[k]) for k, v in maxima.items() if not v <= BOUNDS[k]}


@pytest.mark.parametrize("r", range(RI))
def test_forced_render_iteration_matches_jax(full, r):
    scene, jouts, _, ref = full
    steps, dend, _ = forced_render(ref, scene, jouts, r, GI)
    print("iter | K_crop max rel|d| | flow max|d| | Tij max|d|")
    failed = _over(forced_maxima(steps, dend, r, GI), r)
    assert not failed, f"over the bound (measured, bound): {failed}"


@pytest.mark.parametrize("r", range(RI))
def test_forced_with_jax_face_forms_matches_jax(full, r):
    """The port with `project` and the face setup contracted as XLA
    contracts the JAX formulas: every other op of the render iteration as
    the port computes it, within the same bounds; the rendered depth within
    the slice tests' 1e-4 of the JAX refiner's."""
    scene, jouts, _, ref = full
    with patched(XLA_FACE):
        steps, dend, outs = forced_render(ref, scene, jouts, r, GI)
    print("iter | K_crop max rel|d| | flow max|d| | Tij max|d|")
    failed = _over(forced_maxima(steps, dend, r, GI), r)
    assert not failed, f"over the bound (measured, bound): {failed}"
    dz = np.abs(outs.syn_depth_history[0].numpy() - jouts.syn_depth_history[r]).max()
    assert dz <= 1e-4, dz


@pytest.mark.parametrize("r", range(RI))
def test_raster_differences_are_cracks_in_jax_raster(full, r):
    """At the JAX refiner's pose of render r: the JAX raster (jitted, as its
    refiner runs it: equal to the refiner's rendered depth) against the
    port's on the port's zoom crop (bit-equal to JAX's,
    `test_torch_port_xla_rounding.py`). With XLA's face forms the face ids
    are equal at every pixel. With the port's own, at each pixel whose depth
    differs by more than 1e-2 the port's depth is the f64 z-buffer's (the
    nearest face covering the pixel centre, within the slice tests' 1e-4)
    and the JAX raster's is farther: it sees through a crack."""
    scene, jouts, _, _ = full
    z_j, fid_j, fid_x, _, z_t, cracks = raster_cracks(scene, jouts, r, GI, ZOOM, CHUNK)
    np.testing.assert_array_equal(z_j, jouts.syn_depth_history[r][0])
    np.testing.assert_array_equal(fid_x, fid_j)
    for y, x, z64 in cracks:
        assert abs(z_t[y, x] - z64) <= 1e-4, (y, x)
        assert z_j[y, x] > z64 + 1e-2, (y, x)


@pytest.mark.parametrize("r", range(RI))
def test_jax_one_render_equals_full_run_slice(full, r):
    """`Ti = Tij @ Ti` with Tij = I is exact, so one render iteration of the
    jitted JAX refiner from `Ti_history[4 r]` is the full run's render r."""
    scene, jouts, params, _ = full
    one, _, _ = _jax_run(dict(scene, T_init=jouts.Ti_history[r * GI]), 1, GI, ZOOM, CHUNK,
                         params=params)
    sl = slice(r * GI, (r + 1) * GI)
    end_ref = jouts.Ti_history[(r + 1) * GI] if r + 1 < RI else jouts.Ti_pred
    for name, a, b in (("K_crop", one.intrinsics_history, jouts.intrinsics_history[sl]),
                       ("flow", one.flow_history, jouts.flow_history[sl]),
                       ("Tij", one.Tij_history, jouts.Tij_history[sl]),
                       ("depth", one.syn_depth_history[0], jouts.syn_depth_history[r]),
                       ("end pose", one.Ti_pred, end_ref)):
        a = np.ascontiguousarray(a, np.float32)
        b = np.ascontiguousarray(b, np.float32)
        differ = int((a.view(np.int32) != b.view(np.int32)).sum())
        print(f"render {r} {name}: {differ} of {a.size} differ, max|d| "
              f"{np.abs(a - b).max():.3e}")
        assert differ == 0, (r, name)
