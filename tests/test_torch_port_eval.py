"""The port's evaluation maths against the JAX package's, on the CPU, on the
same seeded random poses and points.

* `ops/knn`: pairwise squared distances within 1e-6 relative, nearest
  indices and the k nearest equal;
* `eval/metrics`: ADD, ADD-S (with a validity mask), Proj2D (both K forms),
  translation and rotation errors within 1e-6 (degrees: 1e-4);
* `eval/icp.icp_refine`: poses within 1e-5, padded points ignored;
* `PoseEvaluator` (asymmetric and symmetric classes, with ICP) and
  `YCBEvaluator`: every summary key, pass/fail counts equal, means within
  1e-6 (1e-5 after ICP, the AUCs 10x that; the rotation error's within
  5e-3 deg: an arccos near 1);
  `weighted_reduce_metrics` over mixed key sets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from rnnpose_tpu.eval import evaluator as jev
from rnnpose_tpu.eval import metrics as jm
from rnnpose_tpu.eval.icp import icp_refine as j_icp
from rnnpose_tpu.ops import knn as jknn
from rnnpose_tpu.parallel.collectives import weighted_reduce_metrics as j_reduce
from rnnpose_tpu_torch.eval import evaluator as tev
from rnnpose_tpu_torch.eval import metrics as tm
from rnnpose_tpu_torch.eval.icp import icp_refine as t_icp
from rnnpose_tpu_torch.ops import knn as tknn

T = torch.from_numpy


def _poses(rs, B, noise):
    """(B, 4, 4) GT poses and predictions off by `noise` (m, and rad)."""
    gt = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    gt[:, :3, :3] = Rotation.random(B, random_state=rs).as_matrix()
    gt[:, :3, 3] = rs.randn(B, 3) * 0.05 + [0, 0, 0.7]
    pred = gt.copy()
    dR = Rotation.from_rotvec(rs.randn(B, 3) * noise).as_matrix()
    pred[:, :3, :3] = dR @ gt[:, :3, :3]
    pred[:, :3, 3] += rs.randn(B, 3) * noise
    return pred.astype(np.float32), gt


def test_knn_matches_jax():
    rs = np.random.RandomState(0)
    a = (rs.randn(2, 70, 3) * 0.05).astype(np.float32)
    b = (rs.randn(2, 90, 3) * 0.05).astype(np.float32)
    d_t = tknn.pairwise_sqdist(T(a), T(b)).numpy()
    d_j = np.asarray(jknn.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(tknn.nearest_neighbor_idx(T(a), T(b)).numpy(),
                                  np.asarray(jknn.nearest_neighbor_idx(a, b)))
    np.testing.assert_allclose(tknn.nearest_neighbor_dist(T(a), T(b)).numpy(),
                               np.asarray(jknn.nearest_neighbor_dist(a, b)), rtol=1e-6)
    (dt, it), (dj, ij) = tknn.knn(T(a), T(b), 5), jknn.knn(a, b, 5)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)


def test_metrics_match_jax():
    rs = np.random.RandomState(1)
    pred, gt = _poses(rs, 6, 0.02)
    pts = (rs.randn(6, 200, 3) * 0.04).astype(np.float32)
    valid = (rs.rand(6, 200) > 0.2).astype(np.float32)
    K4 = np.tile(np.asarray([[572.4, 573.6, 325.3, 242.0]], np.float32), (6, 1))
    K33 = np.tile(np.asarray([[[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]]],
                             np.float32), (6, 1, 1))
    args_t = (T(pred[:, :3, :3]), T(pred[:, :3, 3]), T(gt[:, :3, :3]), T(gt[:, :3, 3]), T(pts))
    args_j = tuple(jnp.asarray(x.numpy()) for x in args_t)
    for v in (None, valid):
        vt, vj = (None, None) if v is None else (T(v), jnp.asarray(v))
        for name in ("add_error", "adds_error"):
            np.testing.assert_allclose(getattr(tm, name)(*args_t, vt).numpy(),
                                       np.asarray(getattr(jm, name)(*args_j, vj)), atol=1e-6)
        for K in (K4, K33):
            np.testing.assert_allclose(
                tm.projection_2d_error(*args_t, T(K), vt).numpy(),
                np.asarray(jm.projection_2d_error(*args_j, jnp.asarray(K), vj)), atol=1e-4,
                rtol=1e-6)
    np.testing.assert_allclose(tm.translation_error(args_t[1], args_t[3]).numpy(),
                               np.asarray(jm.translation_error(args_j[1], args_j[3])), atol=1e-7)
    np.testing.assert_allclose(tm.rotation_error_deg(args_t[0], args_t[2]).numpy(),
                               np.asarray(jm.rotation_error_deg(args_j[0], args_j[2])),
                               atol=1e-4)


def _icp_case(rs, B=3, N=150, M=220):
    gt = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    gt[:, :3, :3] = Rotation.random(B, random_state=rs).as_matrix()
    gt[:, :3, 3] = [0.01, -0.02, 0.55]
    model = (rs.randn(B, N, 3) * 0.04).astype(np.float32)
    scene = np.einsum("bij,bnj->bni", gt[:, :3, :3], model[:, :M]) + gt[:, None, :3, 3]
    scene = np.concatenate([scene, np.full((B, M - N, 3), -5.0)], 1).astype(np.float32)
    sval = (np.arange(M) < N)[None].repeat(B, 0).astype(np.float32)
    mval = (rs.rand(B, N) > 0.1).astype(np.float32)
    init, _ = _poses(rs, B, 0.01)
    init[:, :3, :3] = (Rotation.from_rotvec(rs.randn(B, 3) * 0.03).as_matrix()
                       @ gt[:, :3, :3]).astype(np.float32)
    init[:, :3, 3] = gt[:, :3, 3] + rs.randn(B, 3) * 0.005
    return init, model, scene, mval, sval, gt


def test_icp_matches_jax():
    rs = np.random.RandomState(2)
    init, model, scene, mval, sval, gt = _icp_case(rs)
    out = []
    for kw in (dict(num_iters=8, max_corr_dist=0.03), dict(num_iters=3, max_corr_dist=0.002)):
        got = t_icp(T(init), T(model), T(scene), T(mval), T(sval), **kw).numpy()
        ref = np.asarray(j_icp(jnp.asarray(init), jnp.asarray(model), jnp.asarray(scene),
                               jnp.asarray(mval), jnp.asarray(sval), **kw))
        np.testing.assert_allclose(got, ref, atol=1e-5)
        out.append(got)
    # 8 iterations pull the poses in; a 2 mm gate finds no match and keeps them.
    err = lambda P: np.abs(P[:, :3, 3] - gt[:, :3, 3]).max()  # noqa: E731
    assert err(out[0]) < 0.2 * err(init)
    np.testing.assert_array_equal(out[1], init)


@pytest.mark.parametrize("cls,icp", [("cat", False), ("glue", False), ("cat", True),
                                     ("024_bowl", False), ("011_banana", True)])
def test_evaluators_match_jax(cls, icp):
    rs = np.random.RandomState(3)
    ycb = cls[0].isdigit()
    pts = (rs.randn(180, 3) * 0.03).astype(np.float32)
    kw = dict(icp_refine=icp, icp_iters=5, icp_max_corr_dist=0.03)
    ev_t = (tev.YCBEvaluator if ycb else tev.PoseEvaluator)(cls, 0.15, pts, **kw)
    ev_j = (jev.YCBEvaluator if ycb else jev.PoseEvaluator)(cls, 0.15, pts, **kw)
    assert ev_t.symmetric == ev_j.symmetric
    K = np.asarray([[572.4, 573.6, 325.3, 242.0]], np.float32)
    for noise in (0.001, 0.004, 0.01, 0.03):
        pred, gt = _poses(rs, 4, noise)
        scene = {}
        if icp:
            # A noisy cloud: ICP stops short of GT, away from the arccos's
            # ill-conditioned zero.
            cloud = (np.einsum("bij,nj->bni", gt[:, :3, :3], pts) + gt[:, None, :3, 3]
                     + rs.randn(4, 180, 3) * 0.004)
            scene = dict(scene_points=cloud.astype(np.float32),
                         scene_valid=np.ones((4, 180), np.float32))
        ev_t.evaluate(pred, gt, np.repeat(K, 4, 0), **scene)
        ev_j.evaluate(pred, gt, np.repeat(K, 4, 0), **scene)
    s_t, s_j = ev_t.summarize(), ev_j.summarize()
    assert s_t.keys() == s_j.keys() and s_t["seq_len"] == 16
    for k in s_j:
        if k in ("add01", "add005", "add002", "proj5", "cm5deg5", "adds2cm"):
            assert s_t[k] == s_j[k], k  # pass/fail counts equal
        elif k == "rot_err_deg":
            # arccos((trace - 1) / 2) near 0: a 1e-7 trace rounding moves a
            # 0.06 deg error by up to ~3e-3 deg.
            np.testing.assert_allclose(s_t[k], s_j[k], atol=5e-3, err_msg=k)
        else:  # after ICP the poses themselves agree within 1e-5; an AUC
            # scales a distance by 1 / 0.1 m
            tol = (1e-5 if icp else 1e-6) * (10 if k.endswith("auc") else 1)
            np.testing.assert_allclose(s_t[k], s_j[k], atol=tol, err_msg=k)
    assert 0.0 < s_t["add01"] < 1.0 or 0.0 < s_t["proj5"] < 1.0


def test_weighted_reduce_matches_jax():
    summaries = [{"add01": 1.0, "proj5": 0.5, "seq_len": 3},
                 {"add01": 0.0, "add_auc": 0.7, "seq_len": 1},
                 {"seq_len": 0}]
    assert tev.weighted_reduce_metrics(summaries) == j_reduce(summaries)
    assert tev.weighted_reduce_metrics([]) == j_reduce([]) == {"seq_len": 0.0}


def test_eval_cli_synthetic_batch(tmp_path):
    """`tools/eval.main --synthetic` at the small fixture: one frame, the
    summary keys of the JAX CLI, the pose dumped; `--icp` needs real depth."""
    from rnnpose_tpu_torch.tools.eval import main

    small = ["--synthetic", "--syn_image_size", "64", "--syn_zoom", "32", "--device", "cpu"]
    overall = main(small + ["--dump_poses", str(tmp_path)])
    assert overall["seq_len"] == 1 and {"add01", "proj5", "cm5deg5", "fps"} <= set(overall)
    poses = np.load(tmp_path / "synthetic_pose_preds.npy")
    assert poses.shape == (1, 4, 4) and np.isfinite(poses).all()
    with pytest.raises(SystemExit, match="--icp needs real depth"):
        main(small + ["--icp"])
