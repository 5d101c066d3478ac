"""The LM step's operator (`kernels/lm.lm_step`, kernel
`csrc/lm_step.cu`) on the CPU: its plain version against `geometry/lm._lm_step`
bit for bit, the dispatch of `reprojection_optim` by whether a gradient is
needed, the operator's checks, and `torch.export` holding one node per step
(`tests/test_torch_port_export.py` runs `opcheck` on it with the raster
operators). The kernel itself runs only on the card
(`tests/test_torch_port_cuda.py`).
"""
import numpy as np
import pytest
import torch

from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.geometry import lm
from rnnpose_tpu_torch.geometry import projective as proj
from rnnpose_tpu_torch.geometry import se3
from rnnpose_tpu_torch.kernels import lm as lm_kernel


def lm_problem(seed, B=2, h=6, w=6, noise=0.5, stride0=True):
    """A seeded LM problem: poses near the identity, depth 0.4-0.7 m with an
    invalid pixel, a camera of focal 10 h, targets the grid plus `noise` px,
    weights in [0, 1) (one channel broadcast to both when `stride0`, as the
    refiner passes them)."""
    rs = np.random.RandomState(seed)
    T = se3.se3_expm(torch.from_numpy(rs.randn(B, 6).astype(np.float32) * 0.02))
    depth = torch.from_numpy(rs.uniform(0.4, 0.7, (B, h, w)).astype(np.float32))
    depth[:, 0, 0] = 0.0
    K = torch.tensor([[10.0 * h, 10.0 * h, h / 2.0, w / 2.0]] * B)
    target = (proj.coords_grid(h, w)[None]
              + torch.from_numpy(rs.randn(B, h, w, 2).astype(np.float32)) * noise)
    channels = 1 if stride0 else 2
    weight = torch.from_numpy(rs.uniform(0.0, 1.0, (B, h, w, channels)).astype(np.float32))
    return T, target, weight.expand(B, h, w, 2), depth, K


def legacy_step(T, target, weight, depth, K, cfg=lm.LMConfig()):
    """`reprojection_optim`'s body before the operator: back-projection, then
    `_lm_step`."""
    X0 = proj.backproject(depth, K)
    valid = (depth > cfg.min_depth).to(depth.dtype)
    return lm._lm_step(T, target, weight, X0, valid, K, cfg)


def op(T, target, weight, depth, K, cfg=lm.LMConfig()):
    return torch.ops.rnnpose.lm_step(T, target, weight, depth, K, cfg.lm_lambda, cfg.ep_lambda,
                                     cfg.delta_clamp, cfg.min_depth)


def _cases():
    """name -> (T, target, weight, depth, K, cfg)."""
    cfg = lm.LMConfig()
    cases = {}
    for B, s in ((1, 6), (2, 6), (1, 30), (3, 30)):
        cases[f"b{B}_{s}"] = lm_problem(B * 100 + s, B, s, s) + (cfg,)
    cases["two_channels"] = lm_problem(5, stride0=False) + (cfg,)
    # Pixels at and below the depth threshold, and points behind the camera
    # and between projective.MIN_DEPTH and min_depth after the transform.
    T, target, weight, depth, K = lm_problem(6, 2, 12, 12)
    depth[0, 1, :4] = torch.tensor([0.1, 0.05, -0.3, np.float32(0.1) * (1 + 2 ** -23)])
    T = T.clone()
    T[1, 2, 3] = -0.55   # moves item 1's near points behind the camera
    cases["invalid_and_behind"] = (T, target, weight, depth, K, cfg)
    # An item whose weights are all zero: H = ep I, b = 0, delta = 0.
    T, target, weight, depth, K = lm_problem(7, stride0=False)
    weight = weight.clone()
    weight[1] = 0.0
    cases["zero_weights"] = (T, target, weight, depth, K, cfg)
    # A target on the projection: a tiny update, in the expm's Taylor branch.
    T, _, weight, depth, K = lm_problem(8)
    uv, _ = lm.pose_transform_coords(T, depth, K)
    cases["taylor"] = (T, uv + 1e-4, weight, depth, K, cfg)
    cases["zero_residual"] = (T, uv, weight, depth, K, cfg)
    # A non-finite weight: H and b non-finite, delta zeroed.
    T, target, weight, depth, K = lm_problem(9, stride0=False)
    weight = weight.clone()
    weight[0, 2, 3, 0] = float("inf")
    cases["nonfinite"] = (T, target, weight, depth, K, cfg)
    # Far targets and weak damping: the clamp engages.
    T, target, weight, depth, K = lm_problem(10)
    cases["clamped"] = (T, target + 300.0, weight, depth, K,
                        lm.LMConfig(ep_lambda=1e-3, delta_clamp=0.05))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_is_lm_step_bit_for_bit(name):
    """The operator on CPU tensors (its plain version) gives `_lm_step`'s
    bits, and the wrapper counts no launch."""
    T, target, weight, depth, K, cfg = CASES[name]
    with torch.no_grad():
        want = legacy_step(T, target, weight, depth, K, cfg)
        before = kernels.LAUNCHES["lm_step"]
        got = lm_kernel.lm_step(T, target, weight, depth, K, cfg.lm_lambda, cfg.ep_lambda,
                                cfg.delta_clamp, cfg.min_depth)
    assert kernels.LAUNCHES["lm_step"] == before
    assert got.dtype == torch.float32 and got.shape == T.shape
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(lm_kernel.lm_step_plain(T, target, weight, depth, K, cfg.lm_lambda,
                                               cfg.ep_lambda, cfg.delta_clamp, cfg.min_depth),
                       want)


def test_cases_reach_their_branches():
    """The edge cases do what they are named for: no move with zero weights,
    a non-finite H or a zero residual, a clamped twist, a Taylor-branch twist."""
    def twist(name):
        T, target, weight, depth, K, cfg = CASES[name]
        with torch.no_grad():
            out = op(T, target, weight, depth, K, cfg)
        return se3.se3_logm(out @ se3.se3_inverse(T))
    assert torch.equal(op(*CASES["zero_weights"][:5])[1], CASES["zero_weights"][0][1])
    assert torch.equal(op(*CASES["nonfinite"][:5])[0], CASES["nonfinite"][0][0])
    assert torch.equal(op(*CASES["zero_residual"][:5]), CASES["zero_residual"][0])
    assert float(twist("clamped").abs().max()) == pytest.approx(0.05, rel=1e-3)
    w = twist("taylor")[:, 3:]
    assert 0.0 < float(w.square().sum(-1).max()) < 1e-8


@pytest.mark.parametrize("num_iters", [1, 3])
def test_reprojection_optim_without_gradient_calls_the_operator(monkeypatch, num_iters):
    """No gradient wanted: one operator call per step, the result the
    legacy chain's bit for bit; under autograd the operator is not called."""
    T, target, weight, depth, K, cfg = CASES["b2_6"]
    calls = []
    real = lm_kernel.lm_step

    def counted(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(lm_kernel, "lm_step", counted)
    want = T
    with torch.no_grad():
        for _ in range(num_iters):
            want = legacy_step(want, target, weight, depth, K, cfg)
        got = lm.reprojection_optim(T, target, weight, depth, K, num_iters, cfg)
    assert len(calls) == num_iters and torch.equal(got, want)
    # Grad mode on but nothing requires grad: still the operator.
    got = lm.reprojection_optim(T, target, weight, depth, K, num_iters, cfg)
    assert len(calls) == 2 * num_iters and torch.equal(got, want)
    # A target that requires grad: `_lm_step` under autograd, gradients flow.
    tg = target.clone().requires_grad_(True)
    out = lm.reprojection_optim(T, tg, weight, depth, K, num_iters, cfg)
    assert len(calls) == 2 * num_iters and out.requires_grad
    out.sum().backward()
    assert tg.grad is not None and float(tg.grad.abs().sum()) > 0
    assert torch.equal(out.detach(), want)


@pytest.mark.parametrize("bad", ["shape", "dtype", "T"])
def test_operator_checks_its_arguments(bad):
    T, target, weight, depth, K, cfg = CASES["b2_6"]
    if bad == "shape":
        with pytest.raises(ValueError, match="target"):
            lm_kernel.lm_step(T, target[:, :5], weight, depth, K)
    elif bad == "dtype":
        with pytest.raises(TypeError, match="weight"):
            lm_kernel.lm_step(T, target, weight.double(), depth, K)
    else:
        with pytest.raises(ValueError, match="T must be"):
            lm_kernel.lm_step(T[:, :3], target, weight, depth, K)


def test_export_holds_one_node_per_step():
    """`torch.export` of `reprojection_optim` without gradient: one
    `rnnpose::lm_step` node per step and nothing else of the chain."""
    from rnnpose_tpu_torch.utils import bundle

    class Solve(torch.nn.Module):
        def forward(self, T, target, weight, depth, K):
            with torch.no_grad():
                return lm.reprojection_optim(T, target, weight, depth, K, 3)

    T, target, weight, depth, K, _ = CASES["b2_6"]
    args = (T, target, weight.contiguous(), depth, K)
    exported = torch.export.export(Solve(), args, strict=False)
    assert bundle.operator_nodes(exported, kernels.OPS_NAMESPACE) == {"lm_step": 3}
    calls = [n for n in exported.graph.nodes if n.op == "call_function"]
    assert len(calls) <= 4   # the three steps (and the no_grad region, if kept)
    assert torch.equal(exported.module()(*args), Solve()(*args))
