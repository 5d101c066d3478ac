"""`kernels.dispatch` / `kernels.uses_kernel`: the one place that sends a call
of a no-grad operator (`lm_step`, `corr_lookup`, `corr_lookup_1d`,
`instance_norm`) to its kernel or to its plain chain. Every input whose
dtype a kernel does not take (float64, float16) goes to the chain, which
computes in that dtype, as the grad path does: each no-grad float64 (and
float16) call of `geometry/lm.reprojection_optim`, `ops/corr.corr_lookup`,
`ops/corr.corr_lookup_1d` and `models/raft.InstanceNorm` gives the grad
path's values, in that dtype, bit for bit; float32 (and bfloat16) inputs
without a gradient still go to the operator. Off the CPU an input of a dtype
the kernel does not take goes to the kernel's wrapper, which raises: on the
card a kernel never gives way to the chain in silence (held here on `meta`
tensors, and on the card in `test_torch_port_cuda.py`).
"""
from __future__ import annotations

import pytest
import torch

from chip_smoke import corr_problem, lm_problem, stereo_lookup_problem
from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.geometry import lm as lm_ops
from rnnpose_tpu_torch.models.raft import InstanceNorm
from rnnpose_tpu_torch.ops import corr as corr_ops

torch.set_num_threads(2)


def _grad_path(fn, *tensors):
    """fn(*tensors) with grad mode on and every float tensor requiring a
    gradient (the plain chain under autograd), detached."""
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in tensors]
    with torch.enable_grad():
        return fn(*leaves).detach()


def _lm_inputs(dtype):
    T, target, weight, depth, K = lm_problem(2, 16, seed=4, device="cpu")
    return [t.to(dtype) for t in (T, target, weight, depth, K)]


def test_lm_f64_without_grad_is_the_grad_path():
    """Two LM steps on float64 inputs under `no_grad`: the grad path's
    poses, in float64, bit for bit (the operator raised on them before)."""
    args = _lm_inputs(torch.float64)
    assert not kernels.uses_kernel("lm_step", *args)
    with torch.no_grad():
        got = lm_ops.reprojection_optim(*args, num_iters=2)
    want = _grad_path(lambda *a: lm_ops.reprojection_optim(*a, num_iters=2), *args)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    # float32 without a gradient goes to the operator, which the CPU runs as
    # its plain version: the grad path's poses within f32 rounding.
    f32 = _lm_inputs(torch.float32)
    assert kernels.uses_kernel("lm_step", *f32)
    with torch.no_grad():
        got32 = lm_ops.reprojection_optim(*f32, num_iters=2)
    want32 = _grad_path(lambda *a: lm_ops.reprojection_optim(*a, num_iters=2), *f32)
    assert got32.dtype == torch.float32
    assert float((got32 - want32).abs().max()) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_corr_lookup_f64_and_f16_without_grad_are_the_grad_path(dtype):
    """The 2D lookup with float64 coords and levels, or float16 levels:
    under `no_grad` the grad path's values in their dtype, bit for bit."""
    lv, coords = corr_problem(1, 6, 9, "out_of_range", seed=2, device="cpu")
    lv = [level.to(dtype) for level in lv]
    if dtype == torch.float64:
        coords = coords.double()
    pyramid = corr_ops.CorrPyramid(tuple(lv))
    assert not kernels.uses_kernel("corr_lookup", lv, coords, 4)
    with torch.no_grad():
        got = corr_ops.corr_lookup(pyramid, coords, 4)
    want = _grad_path(lambda c, *levels: corr_ops.corr_lookup(
        corr_ops.CorrPyramid(tuple(levels)), c, 4), coords, *lv)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_corr_lookup_1d_f64_and_f16_without_grad_are_the_grad_path(dtype):
    """The 1D lookup likewise."""
    lv, coords = stereo_lookup_problem(1, 6, 20, "out_of_range", seed=3, device="cpu")
    lv = [level.to(dtype) for level in lv]
    if dtype == torch.float64:
        coords = coords.double()
    assert not kernels.uses_kernel("corr_lookup_1d", lv, coords, 4)
    with torch.no_grad():
        got = corr_ops.corr_lookup_1d(corr_ops.CorrPyramid(tuple(lv)), coords, 4)
    want = _grad_path(lambda c, *levels: corr_ops.corr_lookup_1d(
        corr_ops.CorrPyramid(tuple(levels)), c, 4), coords, *lv)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert got.shape == (1, 6, 20, 36)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_instance_norm_f64_and_f16_without_grad_are_the_grad_path(dtype):
    """`InstanceNorm` with its ReLU on a float64 or float16 map: under
    `no_grad` the grad path's values in its dtype, bit for bit."""
    g = torch.Generator().manual_seed(6)
    x = (3.0 * torch.randn(2, 8, 5, 7, generator=g) + 1.0).to(dtype)
    norm = InstanceNorm()
    assert not kernels.uses_kernel("instance_norm", x, 1e-5, True)
    with torch.no_grad():
        got = norm(x, relu=True)
    want = _grad_path(lambda t: norm(t, relu=True), x)
    assert got.dtype == dtype and torch.equal(got, want)


def test_the_kernel_takes_f32_and_bf16_without_grad_only():
    """f32 and bf16 inputs go to the operator without a gradient and to the
    chain under autograd; mixed level dtypes go to the chain."""
    x = torch.randn(1, 4, 3, 3)
    assert kernels.uses_kernel("instance_norm", x, 1e-5, False)
    assert kernels.uses_kernel("instance_norm", x.bfloat16(), 1e-5, False)
    leaf = x.clone().requires_grad_()
    with torch.enable_grad():
        assert not kernels.uses_kernel("instance_norm", leaf, 1e-5, False)
    with torch.no_grad():
        assert kernels.uses_kernel("instance_norm", leaf, 1e-5, False)
    lv, coords = corr_problem(1, 4, 4, device="cpu")
    assert kernels.uses_kernel("corr_lookup", lv, coords, 4)
    assert not kernels.uses_kernel("corr_lookup", [lv[0].bfloat16()] + lv[1:], coords, 4)
    # The raster sweeps are not dispatched: they have no `takes`.
    assert all(kernels.OPS[name].takes is None for name in kernels.OPERATORS
               if name.startswith("zbuffer"))


def _untaken_calls(device):
    """One float16 (or float64) call of each no-grad operator's entry point
    on `device`, each a thunk: `InstanceNorm`, both lookups and the LM."""
    x = torch.zeros(1, 4, 3, 3, dtype=torch.float16, device=device)
    lv, coords = corr_problem(1, 4, 4, device="cpu")
    lv1, coords1 = stereo_lookup_problem(1, 4, 8, device="cpu")
    lm_args = [t.to(device) for t in _lm_inputs(torch.float64)]
    return {
        "instance_norm": lambda: InstanceNorm()(x, relu=True),
        "corr_lookup": lambda: corr_ops.corr_lookup(
            corr_ops.CorrPyramid(tuple(t.to(device).half() for t in lv)), coords.to(device), 4),
        "corr_lookup_1d": lambda: corr_ops.corr_lookup_1d(
            corr_ops.CorrPyramid(tuple(t.to(device).half() for t in lv1)), coords1.to(device), 4),
        "lm_step": lambda: lm_ops.reprojection_optim(*lm_args, num_iters=1),
    }


@pytest.mark.parametrize("name", ["instance_norm", "corr_lookup", "corr_lookup_1d", "lm_step"])
def test_off_the_cpu_an_untaken_dtype_raises(name):
    """Without a gradient, a float16 or float64 input off the CPU (a `meta`
    tensor here, a card tensor on the card) goes to the kernel's wrapper,
    which raises a TypeError, and not to the plain chain."""
    with torch.no_grad(), pytest.raises(TypeError):
        _untaken_calls("meta")[name]()
