"""The correlation lookup's operator (`kernels/corr.corr_lookup`,
kernel `csrc/corr_lookup.cu`) on the CPU: its plain version against the
lookup's chain as it stood before the operator, bit for bit, on
`chip_smoke.corr_problem`'s cases (in-range, out-of-range, NaN and inf
coordinates, non-finite level values, a level pooled away, bf16 levels); the
dispatch of `ops/corr.corr_lookup` by whether a gradient is needed, and the
gradient of the plain version; `opcheck`; the wrapper's checks; and
`torch.export` holding one node per lookup. The kernel itself runs only on
the card (`tests/test_torch_port_cuda.py`).
"""
import pytest
import torch

from chip_smoke import LOOKUP_CASES, corr_problem, same_bits
from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.kernels import corr as corr_kernel
from rnnpose_tpu_torch.ops import corr
from rnnpose_tpu_torch.utils import bundle


def legacy_taps(center, radius, size):
    """`ops/corr._taps` before the operator."""
    d = torch.arange(-radius, radius + 1, dtype=center.dtype, device=center.device)
    pos = center[:, None] + d[None, :]
    i0 = torch.floor(pos)
    w1 = pos - i0
    w0 = 1.0 - w1
    i1 = i0 + 1
    v0 = (i0 >= 0) & (i0 <= size - 1)
    v1 = (i1 >= 0) & (i1 <= size - 1)
    zero = torch.zeros_like(i0)
    return (
        (torch.where(v0, i0, zero).long(), w0 * v0),
        (torch.where(v1, i1, zero).long(), w1 * v1),
    )


def legacy_lookup(levels, coords, radius):
    """`ops/corr.corr_lookup` before the operator, on a list of levels."""
    B, H, W, _ = coords.shape
    Q = B * H * W
    win = 2 * radius + 1
    cx = coords[..., 0].reshape(Q)
    cy = coords[..., 1].reshape(Q)
    outs = []
    for i, level in enumerate(levels):
        Hl, Wl = level.shape[-2], level.shape[-1]
        if Hl == 0 or Wl == 0:
            outs.append(torch.zeros((B, H, W, win * win), dtype=level.dtype,
                                    device=level.device))
            continue
        scale = 1.0 / (2.0 ** i)
        ty = legacy_taps(cy * scale, radius, Hl)
        tx = legacy_taps(cx * scale, radius, Wl)
        vol = level.reshape(Q, Hl * Wl)
        out = 0.0
        for xi, wx in tx:
            col = 0.0
            for yi, wy in ty:
                idx = yi[:, None, :] * Wl + xi[:, :, None]
                v = torch.gather(vol, 1, idx.reshape(Q, -1)).reshape(Q, win, win)
                col = col + wy[:, None, :] * v
            out = out + wx[:, :, None] * col
        outs.append(out.reshape(B, H, W, win * win))
    return torch.cat(outs, dim=-1)


# (B, H, W, levels, radius): a grid whose coarsest level is 1 x 1, one whose
# level 3 is pooled away (4 x 4 at 4 levels), and fewer levels at radius 3.
SHAPES = {"b2_6x9": (2, 6, 9, 4, 4), "b1_4x4": (1, 4, 4, 4, 4), "b2_5x7_r3": (2, 5, 7, 3, 3)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("case", LOOKUP_CASES)
def test_plain_version_is_the_chain_bit_for_bit(case, shape):
    """The operator on CPU tensors (its plain version) gives the chain's
    bits, NaN where it gives NaN, as f32; the wrapper counts no launch."""
    B, H, W, levels, radius = SHAPES[shape]
    lv, coords = corr_problem(B, H, W, case, seed=B * 100 + H, levels=levels, device="cpu")
    want = legacy_lookup(lv, coords, radius)
    before = kernels.LAUNCHES["corr_lookup"]
    got = corr_kernel.corr_lookup(lv, coords, radius)
    assert kernels.LAUNCHES["corr_lookup"] == before
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == (B, H, W, levels * (2 * radius + 1) ** 2)
    assert same_bits(got, want)
    assert same_bits(corr_kernel.corr_lookup_plain(lv, coords, radius), want)
    if case == "in_range":
        assert torch.isfinite(got).all()
    if case in ("nan_coords", "nonfinite_element0"):
        assert got.isnan().any() and not got.isnan().all()
    if shape == "b1_4x4":   # level 3 is 0 x 0: its taps read 0
        assert lv[3].numel() == 0 and not got[..., 3 * 81:].any()


def test_cases_reach_their_edges():
    """The edge cases do what they are named for: taps out of range (a
    window wholly outside reads 0), non-finite coordinates and level values,
    and the rounding edge, where c + d lands on an integer."""
    lv, coords = corr_problem(2, 6, 9, "out_of_range", device="cpu")
    out = corr_kernel.corr_lookup(lv, coords, 4)
    far = (coords.abs() > 100).any(-1)
    assert far.any() and not out[far].any()
    assert (coords == -1e-9).all(-1).any()
    lv, coords = corr_problem(2, 6, 9, "nan_coords", device="cpu")
    assert (~torch.isfinite(coords)).any(-1).sum() >= 9
    lv, coords = corr_problem(2, 6, 9, "nonfinite_element0", device="cpu")
    assert all(torch.isnan(level).any() for level in lv if level.numel())
    lv, _ = corr_problem(2, 6, 9, "bf16", device="cpu")
    assert all(level.dtype == torch.bfloat16 for level in lv)


@pytest.mark.parametrize("grad", ["no_grad", "nothing_requires_grad", "levels", "coords"])
def test_corr_lookup_takes_the_operator_only_without_gradient(monkeypatch, grad):
    """No gradient to keep (grad mode off, or nothing requiring one): one
    operator call, the chain's bits. A level or the coords requiring grad:
    the plain chain under autograd, no operator call, gradients reaching
    the pyramid (and the coords)."""
    lv, coords = corr_problem(2, 6, 9, "out_of_range", device="cpu")
    want = legacy_lookup(lv, coords, 4)
    calls = []
    real = corr_kernel.corr_lookup

    def counted(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(corr_kernel, "corr_lookup", counted)
    if grad in ("no_grad", "nothing_requires_grad"):
        with torch.set_grad_enabled(grad != "no_grad"):
            got = corr.corr_lookup(corr.CorrPyramid(tuple(lv)), coords, 4)
        assert len(calls) == 1 and same_bits(got, want)
        return
    if grad == "levels":
        lv = [level.clone().requires_grad_(True) for level in lv]
    else:
        coords = coords.clone().requires_grad_(True)
    got = corr.corr_lookup(corr.CorrPyramid(tuple(lv)), coords, 4)
    assert not calls and got.requires_grad and same_bits(got.detach(), want)
    got.sum().backward()
    leaves = [t for t in lv if t.numel()] if grad == "levels" else [coords]
    assert all(t.grad is not None for t in leaves)
    assert all(float(t.grad[torch.isfinite(t.grad)].abs().sum()) > 0 for t in leaves)


@pytest.mark.parametrize("case", ["out_of_range", "bf16"])
def test_operator_opcheck(case):
    """`opcheck` (schema, fake implementation, dispatch) on the lookup at a
    grid whose level 3 is pooled away; the fake output has the real one's
    shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    lv, coords = corr_problem(1, 4, 4, case, device="cpu")
    op = torch.ops.rnnpose.corr_lookup.default
    torch.library.opcheck(op, (lv, coords, 4))
    with FakeTensorMode() as mode:
        fake = op([mode.from_tensor(level) for level in lv], mode.from_tensor(coords), 4)
    assert (tuple(fake.shape), fake.dtype) == ((1, 4, 4, 324), torch.float32)


@pytest.mark.parametrize("bad", ["coords_shape", "coords_dtype", "level_shape", "mixed_dtype",
                                 "level_dtype", "levels", "radius"])
def test_wrapper_checks_its_arguments(bad):
    lv, coords = corr_problem(1, 6, 9, device="cpu")
    if bad == "coords_shape":
        with pytest.raises(ValueError, match="coords must be"):
            corr_kernel.corr_lookup(lv, coords[..., :1], 4)
    elif bad == "coords_dtype":
        with pytest.raises(TypeError, match="coords must be float32"):
            corr_kernel.corr_lookup(lv, coords.double(), 4)
    elif bad == "level_shape":
        with pytest.raises(ValueError, match="level 1 must be"):
            corr_kernel.corr_lookup([lv[0], lv[1][:, :-1]], coords, 4)
    elif bad == "mixed_dtype":
        with pytest.raises(TypeError, match="share one dtype"):
            corr_kernel.corr_lookup([lv[0], lv[1].bfloat16()], coords, 4)
    elif bad == "level_dtype":
        with pytest.raises(TypeError, match="share one dtype"):
            corr_kernel.corr_lookup([level.half() for level in lv], coords, 4)
    elif bad == "levels":
        with pytest.raises(ValueError, match="levels and a radius"):
            corr_kernel.corr_lookup(lv * 3, coords, 4)
    else:
        with pytest.raises(ValueError, match="levels and a radius"):
            corr_kernel.corr_lookup(lv, coords, -1)


def test_export_holds_one_node_per_lookup():
    """`torch.export` of three lookups without gradient: three
    `rnnpose::corr_lookup` nodes and nothing of the chain; the program gives
    the eager bits."""

    class Lookups(torch.nn.Module):
        def forward(self, l0, l1, l2, coords):
            pyramid = corr.CorrPyramid((l0, l1, l2))
            with torch.no_grad():
                out = corr.corr_lookup(pyramid, coords, 4)
                for _ in range(2):
                    out = out + corr.corr_lookup(pyramid, coords + 0.5, 4)
            return out

    lv, coords = corr_problem(2, 6, 9, "out_of_range", levels=3, device="cpu")
    args = (*lv, coords)
    exported = torch.export.export(Lookups(), args, strict=False)
    assert bundle.operator_nodes(exported, kernels.OPS_NAMESPACE) == {"corr_lookup": 3}
    targets = {str(n.target) for m in exported.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
               if n.op == "call_function"}
    assert not any("gather" in t or "floor" in t for t in targets)
    assert same_bits(exported.module()(*args), Lookups()(*args))


def test_training_step_takes_the_chain_and_eval_the_operator(monkeypatch):
    """A training step's lookups run the chain under autograd (the
    operator is never called: its pyramid requires grad), and the eval
    forward of the same model calls the operator once per render and GRU
    iteration."""
    import dataclasses

    from rnnpose_tpu_torch.data.synthetic import (
        SyntheticConfig, kpconv_config, make_synthetic_inputs)
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_
    from rnnpose_tpu_torch.train.loop import Trainer
    from rnnpose_tpu_torch.train.optim import OptimizerConfig

    syn = SyntheticConfig(batch_size=2, image_size=64, num_verts=128, num_faces=256,
                          subdivisions=2, kp_layers=2, kp_dl=0.03, num_corr=64)
    kp = dataclasses.replace(kpconv_config(syn), first_feats_dim=16, gnn_feats_dim=16)
    cfg = RNNPoseConfig(desc_kp=dataclasses.replace(kp, final_feats_dim=32),
                        ctx_kp=dataclasses.replace(kp, final_feats_dim=256,
                                                   normalize_output=False),
                        refiner=RefinerConfig(zoom_crop_size=32, render_iters=2, gru_iters=2,
                                              corr_levels=2, raster_chunk=64))
    batch = make_synthetic_inputs(syn, with_corr=True)
    calls = []
    real = corr_kernel.corr_lookup
    monkeypatch.setattr(corr_kernel, "corr_lookup", lambda *args: calls.append(1) or real(*args))
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(0))
    Trainer(model, OptimizerConfig()).run_step(batch)
    assert not calls
    with torch.no_grad():
        model(batch, train=False)
    assert len(calls) == 2 * 2
