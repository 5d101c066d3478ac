"""The training losses, `induced_flow` and `se3_expm_approx_grad` of the
port against the JAX package's, on the same numpy inputs: values and input
gradients within 1e-5 (the expm backward within 1e-6). The circle loss also
runs batched against a vmap of the JAX one, and on a padded correspondence
set, where the port's gradients must be finite wherever the JAX package's
are."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
from rnnpose_tpu.geometry import lm as jlm
from rnnpose_tpu.geometry import se3 as jse3
from rnnpose_tpu.models.refiner import RefinerOutputs as JOutputs
from rnnpose_tpu.train import losses as jl
from rnnpose_tpu_torch.geometry import lm as tlm
from rnnpose_tpu_torch.geometry import se3 as tse3
from rnnpose_tpu_torch.models.refiner import RefinerOutputs as TOutputs
from rnnpose_tpu_torch.train import losses as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _grads_both(jfn, tfn, arrays, argnums):
    """Value and the gradients wrt `argnums` of a scalar function of numpy
    arrays, through JAX and through torch."""
    vj, gj = jax.value_and_grad(jfn, argnums=argnums)(*[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(arrays)]
    vt = tfn(*ts)
    gt = torch.autograd.grad(vt, [ts[i] for i in argnums])
    return (float(vj), [np.asarray(g) for g in gj]), (float(vt.detach()), [g.numpy() for g in gt])


def _corr_sample(rs, P=40, C=16, n_pad=0):
    tgt = rs.uniform(0.0, 0.06, size=(P, 3)).astype(np.float32)
    src = (tgt + rs.randn(P, 3) * 2e-3).astype(np.float32)
    f_t = rs.randn(P, C).astype(np.float32)
    f_t /= np.linalg.norm(f_t, axis=-1, keepdims=True)
    f_s = f_t + rs.randn(P, C).astype(np.float32) * 0.5
    f_s /= np.linalg.norm(f_s, axis=-1, keepdims=True)
    valid = np.ones(P, np.float32)
    valid[P - n_pad:] = 0.0
    return [src, tgt, f_s.astype(np.float32), f_t.astype(np.float32), valid]


@pytest.mark.parametrize("n_pad", [0, 7])
def test_circle_loss_value_and_grads(n_pad):
    cfg = jl.CircleLossConfig()
    arrays = _corr_sample(np.random.RandomState(n_pad), n_pad=n_pad)
    (vj, gj), (vt, gt) = _grads_both(
        lambda *a: jl.circle_loss(*a, cfg), lambda *a: tl.circle_loss(*a, tl.CircleLossConfig()),
        arrays, (2, 3))
    assert vj > 0.0
    np.testing.assert_allclose(vt, vj, **TOL)
    for a, b in zip(gt, gj):
        # Finite wherever the JAX package's gradient is, and equal there.
        assert np.isfinite(a[np.isfinite(b)]).all()
        np.testing.assert_allclose(a, b, **TOL)
    if n_pad:
        assert np.all(gt[0][-n_pad:] == 0.0) and np.all(gt[1][-n_pad:] == 0.0)


def test_circle_loss_and_recall_batched():
    rs = np.random.RandomState(3)
    samples = [_corr_sample(rs, n_pad=p) for p in (0, 5)]
    batch = [np.stack(x) for x in zip(*samples)]
    cfg = jl.CircleLossConfig()
    vj = jax.vmap(lambda *a: jl.circle_loss(*a, cfg))(*batch)
    rj = jax.vmap(lambda *a: jl.match_recall(*a, cfg))(*batch)
    tb = [torch.from_numpy(a) for a in batch]
    np.testing.assert_allclose(tl.circle_loss(*tb).numpy(), np.asarray(vj), **TOL)
    rt = tl.match_recall(*tb).numpy()
    np.testing.assert_allclose(rt, np.asarray(rj), **TOL)
    assert (rt > 0).all()


def test_point_alignment_loss():
    rs = np.random.RandomState(1)
    B, N = 2, 50
    R = np.stack([np.asarray(jse3.se3_expm(jnp.asarray(rs.randn(6) * 0.2)))[:3, :3]
                  for _ in range(2 * B)]).astype(np.float32)
    arrays = [R[:B], rs.randn(B, 3).astype(np.float32) * 0.05, R[B:],
              rs.randn(B, 3).astype(np.float32) * 0.05,
              rs.randn(B, N, 3).astype(np.float32) * 0.05,
              (rs.rand(B, N) > 0.3).astype(np.float32)]
    for pv in (True, False):
        args = arrays if pv else arrays[:5]
        (vj, gj), (vt, gt) = _grads_both(jl.point_alignment_loss, tl.point_alignment_loss,
                                         args, (0, 1))
        np.testing.assert_allclose(vt, vj, **TOL)
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(a, b, **TOL)


def test_sequence_flow_loss():
    rs = np.random.RandomState(2)
    T, B, H = 3, 2, 8
    gt = rs.randn(B, H, H, 2).astype(np.float32) * 5
    gt[0, 0, 0] = 500.0  # beyond max_flow: masked out
    arrays = [rs.randn(T, B, H, H, 2).astype(np.float32) * 5, gt,
              rs.rand(B, H, H).astype(np.float32)]
    (vj, gj), (vt, gt_) = _grads_both(jl.sequence_flow_loss, tl.sequence_flow_loss, arrays, (0,))
    np.testing.assert_allclose(vt, vj, **TOL)
    np.testing.assert_allclose(gt_[0], gj[0], **TOL)


def _poses(rs, n, scale):
    xi = rs.randn(n, 6) * scale
    return np.stack([np.asarray(jse3.se3_expm(jnp.asarray(x, jnp.float32))) for x in xi])


def _history(rs, R=2, G=2, B=2, S=16):
    """A RefinerOutputs-shaped history: small relative poses, objects 0.6 m
    away, depth maps with background, full-res flows."""
    T = R * G
    Ti = _poses(rs, T * B, 0.1).reshape(T, B, 4, 4)
    Ti[..., 2, 3] += 0.6
    depth = (0.6 + rs.rand(R, B, S, S) * 0.05).astype(np.float32)
    depth[..., :3, :] = 0.0
    K = np.tile(np.asarray([40.0, 40.0, S / 2, S / 2], np.float32), (T, B, 1))
    return dict(
        Tij_history=_poses(rs, T * B, 0.02).reshape(T, B, 4, 4).astype(np.float32),
        flow_history=(rs.randn(T, B, S, S, 2) * 2).astype(np.float32),
        Ti_history=Ti.astype(np.float32),
        Tij_gt_history=_poses(rs, T * B, 0.02).reshape(T, B, 4, 4).astype(np.float32),
        intrinsics_history=K, syn_depth_history=depth,
        pts=(rs.randn(B, 30, 3) * 0.05).astype(np.float32),
        pv=(rs.rand(B, 30) > 0.2).astype(np.float32),
    )


def _outputs(cls, h, wrap, Tij, flow):
    zero = wrap(np.zeros((1,), np.float32))
    return cls(Ti_pred=zero, Tij=zero, flow_history=flow, Tij_history=Tij,
               Ti_history=wrap(h["Ti_history"]), Tij_gt_history=wrap(h["Tij_gt_history"]),
               intrinsics_history=wrap(h["intrinsics_history"]),
               syn_depth_history=wrap(h["syn_depth_history"]), weight=zero, syn_img=zero,
               image_crop=zero, valid_mask=zero)


@pytest.mark.parametrize("clobber", [True, False])
def test_refiner_loss(clobber):
    h = _history(np.random.RandomState(4))
    cfg_j = jl.RefinerLossConfig(reproj_weight=0.3)
    cfg_t = tl.RefinerLossConfig(reproj_weight=0.3)

    def run_j(Tij, flow):
        out = jl.refiner_loss(_outputs(JOutputs, h, jnp.asarray, Tij, flow),
                              jnp.asarray(h["pts"]), jnp.asarray(h["pv"]), cfg_j, 2, clobber)
        return out["total_loss"], out

    (vj, out_j), gj = jax.value_and_grad(run_j, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h["Tij_history"]), jnp.asarray(h["flow_history"]))
    Tij = torch.tensor(h["Tij_history"], requires_grad=True)
    flow = torch.tensor(h["flow_history"], requires_grad=True)
    out_t = tl.refiner_loss(_outputs(TOutputs, h, torch.from_numpy, Tij, flow),
                            torch.from_numpy(h["pts"]), torch.from_numpy(h["pv"]), cfg_t, 2,
                            clobber)
    gt = torch.autograd.grad(out_t["total_loss"], [Tij, flow])
    for k in ("total_loss", "flow_loss", "reproj_loss", "loss_3d_proj"):
        np.testing.assert_allclose(float(out_t[k]), float(out_j[k]), err_msg=k, **TOL)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # The clobbered iteration (the last inner step of render iteration 0)
    # carries no pose gradient.
    assert (np.abs(gt[0][1].numpy()).max() == 0.0) == clobber


def test_induced_flow():
    rs = np.random.RandomState(5)
    T = _poses(rs, 2, 0.05).astype(np.float32)
    depth = (0.5 + rs.rand(2, 12, 10)).astype(np.float32)
    depth[0, 0, :4] = 0.05  # below min_depth: invalid
    K = np.asarray([[50.0, 52.0, 5.0, 6.0], [60.0, 58.0, 4.5, 6.5]], np.float32)
    w = rs.randn(2, 12, 10, 2).astype(np.float32)
    fj, vj = jlm.induced_flow(jnp.asarray(T), jnp.asarray(depth), jnp.asarray(K))
    ft, vt = tlm.induced_flow(torch.from_numpy(T), torch.from_numpy(depth), torch.from_numpy(K))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    (_, gj), (_, gt) = _grads_both(
        lambda T_: jnp.sum(jlm.induced_flow(T_, jnp.asarray(depth), jnp.asarray(K))[0] * w),
        lambda T_: torch.sum(tlm.induced_flow(T_, torch.from_numpy(depth),
                                              torch.from_numpy(K))[0] * torch.from_numpy(w)),
        [T], (0,))
    np.testing.assert_allclose(gt[0], gj[0], rtol=1e-5, atol=1e-5 * np.abs(gj[0]).max())


def test_se3_expm_approx_grad():
    rs = np.random.RandomState(6)
    xi = (rs.randn(3, 6) * 0.1).astype(np.float32)
    w = rs.randn(3, 4, 4).astype(np.float32)
    (vj, gj), (vt, gt) = _grads_both(
        lambda x: jnp.sum(jse3.se3_expm_approx_grad(x) * w),
        lambda x: torch.sum(tse3.se3_expm_approx_grad(x) * torch.from_numpy(w)), [xi], (0,))
    np.testing.assert_allclose(vt, vj, rtol=1e-6)
    np.testing.assert_allclose(gt[0], gj[0], atol=1e-6)
    # The approximation is linearised at the identity: not the exact VJP.
    x = torch.tensor(xi, requires_grad=True)
    exact = torch.autograd.grad(torch.sum(tse3.se3_expm(x) * torch.from_numpy(w)), [x])[0]
    assert np.abs(exact.numpy() - gt[0]).max() > 1e-3


def test_lm_step_gradients():
    """One LM step (approximate expm backward by default) differentiated
    wrt the target field and the weights; a zero-weight batch item makes
    the solve's NaN-zeroing branch run in the backward too. The port sums
    and solves the normal equations in f64, so the JAX side runs in f64
    (`jax.enable_x64`): in f32 its sums' rounding alone moves these gradients
    by up to 4e-4 relative."""
    rs = np.random.RandomState(7)
    T = _poses(rs, 2, 0.03).astype(np.float32)
    depth = (0.55 + rs.rand(2, 6, 6) * 0.1).astype(np.float32)
    K = np.asarray([[30.0, 30.0, 3.0, 3.0]] * 2, np.float32)
    grid = np.stack(np.meshgrid(np.arange(6), np.arange(6), indexing="xy"), -1)
    target = (grid[None] + rs.randn(2, 6, 6, 2) * 0.5).astype(np.float32)
    weight = rs.rand(2, 6, 6, 2).astype(np.float32)
    weight[1] = 0.0
    sel = rs.randn(2, 4, 4).astype(np.float32)
    jcfg, tcfg = jlm.LMConfig(lm_lambda=1e-4, ep_lambda=1e-3), tlm.LMConfig(
        lm_lambda=1e-4, ep_lambda=1e-3)
    assert jcfg.expm_approx_grad and tcfg.expm_approx_grad
    f64 = [a.astype(np.float64) for a in (T, depth, K, sel)]
    with jax.enable_x64(True):
        (vj, gj), (vt, gt) = _grads_both(
            lambda tg, wt: jnp.sum(jlm.reprojection_optim(
                jnp.asarray(f64[0]), tg, wt, jnp.asarray(f64[1]), jnp.asarray(f64[2]),
                cfg=jcfg) * f64[3]),
            lambda tg, wt: torch.sum(tlm.reprojection_optim(
                torch.from_numpy(T), tg.float(), wt.float(), torch.from_numpy(depth),
                torch.from_numpy(K), cfg=tcfg) * torch.from_numpy(sel)),
            [target.astype(np.float64), weight.astype(np.float64)], (0, 1))
    np.testing.assert_allclose(vt, vj, **TOL)
    for a, b in zip(gt, gj):
        assert np.isfinite(a[np.isfinite(b)]).all()
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
