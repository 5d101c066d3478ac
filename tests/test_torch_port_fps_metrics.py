"""The port's furthest point sampling, mesh fragmentation and running
training metrics against the JAX package's, on seeded inputs.

* `ops/fps.furthest_point_sample`: the same indices as JAX's on seeded
  clouds (random, a grid with exactly tied distances), for several sample
  counts. On the synthetic icosphere's vertices many distances tie up to
  f32 rounding, and which of them wins depends on how a backend rounds the
  sum of squares: there the port and JAX agree up to the first such
  near-tie in JAX's sequence (an exact tie goes to the first maximum in
  both), and every index the port picks reaches the
  largest distance to the points picked before it within f32 rounding
  (`TIE_RTOL`, measured in f64).
* `render/fragments.fragment_vertices`: the same centres, centre indices
  and per-vertex patch ids; on the icosphere, centres that are a
  furthest-point sequence as above and JAX's nearest-centre ids for them.
* `train/metrics`: `RunningScalar`, `RunningAccuracy`, `PrecisionRecall`
  and `MetricDict` fed the same stream (numpy arrays on the JAX side, CPU
  tensors on the port's) give the same values, and reset alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from rnnpose_tpu.ops.fps import furthest_point_sample as j_fps
from rnnpose_tpu.ops.knn import nearest_neighbor_idx as j_nearest
from rnnpose_tpu.render.fragments import fragment_vertices as j_fragment
from rnnpose_tpu.train import metrics as jm
from rnnpose_tpu_torch.ops.fps import furthest_point_sample
from rnnpose_tpu_torch.render.fragments import fragment_vertices
from rnnpose_tpu_torch.train import metrics as tm


def _clouds():
    from rnnpose_tpu_torch.data.synthetic import make_icosphere

    rs = np.random.RandomState(0)
    grid = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return {"random": rs.randn(500, 3).astype(np.float32),
            "grid_ties": grid.astype(np.float32),
            "icosphere": make_icosphere(3, 0.06).verts.astype(np.float32)}


# The relative rounding of an f32 sum of three squares of differences: a
# few units of 2^-24.
TIE_RTOL = 2.0 ** -21


def _fps_reach(pts, idx):
    """Per step i >= 1 of an index sequence, in f64: the chosen point's
    squared distance to the points chosen before it, the largest such
    distance over the cloud, and the runner-up's."""
    p = pts.astype(np.float64)
    m = np.full(len(p), np.inf)
    got, best, second = [], [], []
    for i in range(1, len(idx)):
        m = np.minimum(m, ((p - p[idx[i - 1]]) ** 2).sum(-1))
        top = np.sort(m)[::-1]
        got.append(m[idx[i]])
        best.append(top[0])
        second.append(top[1])
    return np.array(got), np.array(best), np.array(second)


def _assert_fps_sequence(pts, got, want):
    """`got` agrees with JAX's `want` up to JAX's first near-tie (not an
    exact one) and picks a furthest point (within rounding) at every step."""
    _, best, second = _fps_reach(pts, want)
    ties = np.nonzero((second < best) & (second >= best * (1 - TIE_RTOL)))[0]
    agree = 1 + (ties[0] if ties.size else len(want))
    np.testing.assert_array_equal(got[:agree], want[:agree])
    reach, best, _ = _fps_reach(pts, got)
    assert np.all(reach >= best * (1 - TIE_RTOL)), np.max(1 - reach / best)


@pytest.mark.parametrize("cloud", ["random", "grid_ties", "icosphere"])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_furthest_point_sample_matches_jax(cloud, k):
    pts = _clouds()[cloud]
    got = furthest_point_sample(torch.as_tensor(pts), k)
    want = np.asarray(j_fps(jnp.asarray(pts), k))
    assert got.dtype == torch.int32 and got.shape == (k,)
    if cloud == "icosphere":
        _assert_fps_sequence(pts, got.numpy(), want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got.tolist())) == k


@pytest.mark.parametrize("cloud", ["random", "icosphere"])
def test_fragment_vertices_matches_jax(cloud):
    verts = _clouds()[cloud]
    got, want = fragment_vertices(verts, 16), j_fragment(verts, 16)
    if cloud == "icosphere":
        _assert_fps_sequence(verts, got[1], want[1])
        want = (verts[got[1]], got[1],
                np.asarray(j_nearest(jnp.asarray(verts), jnp.asarray(verts[got[1]])), np.int32))
    for g, w, name in zip(got, want, ("pat_centers", "pat_center_inds", "vert_frag_ids")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_running_metrics_match_jax():
    rs = np.random.RandomState(1)
    pairs = [(jm.RunningScalar(), tm.RunningScalar()),
             (jm.RunningAccuracy(), tm.RunningAccuracy()),
             (jm.PrecisionRecall(0.3), tm.PrecisionRecall(0.3)),
             (jm.MetricDict(), tm.MetricDict())]

    def values(j, t):
        if isinstance(j, jm.PrecisionRecall):
            return (j.precision, j.recall), (t.precision, t.recall)
        if isinstance(j, jm.MetricDict):
            return j.summary(), t.summary()
        return j.value, t.value

    for _ in range(3):
        for _ in range(4):
            v, n = float(rs.randn()), int(rs.randint(1, 5))
            pred, target = rs.randint(0, 3, 10), rs.randint(0, 3, 10)
            scores, labels = rs.rand(12), (rs.rand(12) > 0.5).astype(np.float32)
            feed = {jm.RunningScalar: ((v, n), (v, n)),
                    jm.RunningAccuracy: ((pred, target),
                                         (torch.as_tensor(pred), torch.as_tensor(target))),
                    jm.PrecisionRecall: ((scores, labels),
                                         (torch.as_tensor(scores), torch.as_tensor(labels))),
                    jm.MetricDict: (({"a": v, "b": 2 * v},), ({"a": v, "b": 2 * v},))}
            for j, t in pairs:
                args_j, args_t = feed[type(j)]
                j.update(*args_j)
                t.update(*args_t)
                vj, vt = values(j, t)
                assert vt == vj, type(t).__name__
        for j, t in pairs:
            j.reset()
            t.reset()
            assert values(j, t)[1] == values(j, t)[0]
