"""RAFT-Stereo (`rnnpose_tpu_torch/models/raft_stereo.py`) against the
benchmark's plain reference (`benchmark/reference/models/raft_stereo.py`,
RAFT-Stereo's `core/raft_stereo.py` in f32), at RAFT-Stereo's published
widths (three GRU levels of 128, 4 correlation levels of radius 4 along the
row, `fnet` of 256 at 1/4, batch-norm `cnet`) on seeded random weights
(`benchmark/gen_flow.make_weights`) and small seeded rectified pairs
(`benchmark/gen_stereo.make_pairs`) on the CPU.

The frames are 90 x 150, padded to 96 x 160: a 24 x 40 grid at 1/4 (12 x 20
at 1/8, 6 x 10 at 1/16), whose coarsest read level is 5 wide.

* The eager f32 forward against the reference: the coarse x-flow after
  each iteration and the full-resolution x-flow.
* `FlowEngine` on the CPU: the eager forward's bits, one program per
  iteration count and frame size, its counters and its marks.
* The bf16 configuration against the f32 reference, in the benchmark
  check's iteration-forced form.
* `corr_lookup_1d`'s plain version against the reference's `CorrBlock1D`
  lookup (its 1D `bilinear_sampler`), taps outside the row included; the
  1D pyramid against `CorrBlock1D`'s levels.
* The reference's `state_dict` loads strictly into the port.
* The 32-divisor padder's 1988 -> 2016 -> 1988 round trip against
  RAFT-Stereo's `InputPadder(divis_by=32)`.
* The flow's y stays exactly 0 (the delta's y is forced to 0 each
  iteration).
* RAFT's and RNNPose's encoders keep their stride-2 stem, their names and
  their bits.
"""
from __future__ import annotations

import pytest
import torch

from benchmark import gen_flow, gen_stereo
from benchmark.reference.models import raft_flow as ref_flow
from benchmark.reference.models import raft_stereo as ref_stereo
from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.kernels import corr as corr_kernel
from rnnpose_tpu_torch.models.engine import FlowEngine
from rnnpose_tpu_torch.models.raft import BasicEncoder, to_nchw, to_nhwc
from rnnpose_tpu_torch.models.raft_flow import pad_frames, sintel_pad, unpad
from rnnpose_tpu_torch.models.raft_stereo import DIVISOR, RAFTStereo, RAFTStereoConfig
from rnnpose_tpu_torch.ops import corr as corr_ops
from rnnpose_tpu_torch.utils import profiling

torch.set_num_threads(2)

H, W, ITERS = 90, 150, 3
GRID = (24, 40)


def _setup(seed: int, mixed_precision: bool = False):
    """(reference, port, rectified pair) on seeded weights and frames."""
    ref = ref_stereo.RAFTStereo().eval()
    weights = gen_flow.make_weights(ref, seed, "cpu")
    ref.load_state_dict(weights, strict=True)
    port = RAFTStereo(RAFTStereoConfig(mixed_precision=mixed_precision)).eval()
    port.load_state_dict(weights, strict=True)
    gen = torch.Generator().manual_seed(seed)
    i1, i2, _ = gen_stereo.make_pairs(1, H, W, 16, 2.0, gen)
    return ref, port, (i1, i2)


@pytest.mark.parametrize("seed", [0, 1])
def test_eager_f32_forward_matches_reference(seed):
    """Every iteration's coarse x-flow within 5e-5 px and the
    full-resolution x-flow within 2e-4 px (largest seen 7.6e-6 and 1.7e-5):
    RAFT-Stereo's `grid_sample` normalises each sample coordinate to [-1, 1]
    and back, which moves it by about an ulp, where the port takes the taps
    at the coordinate itself, and the convolutions sum in other orders."""
    ref, port, pair = _setup(seed)
    with torch.no_grad():
        r, p = ref(*pair, ITERS), port(*pair, ITERS)
    assert p.flow.shape == r["flow"].shape == (1, H, W, 1)
    assert p.flow_history.shape == r["flow_history"].shape == (ITERS, 1) + GRID + (1,)
    assert float(r["flow"].abs().max()) > 1.0  # the flow moved
    assert float((p.flow_history - r["flow_history"]).abs().max()) <= 5e-5
    assert float((p.flow - r["flow"]).abs().max()) <= 2e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_against_f32_reference(seed):
    """The configuration's precision (bf16 convolutions, f32 volume,
    lookup, coordinates, norm statistics and upsampling) against the f32
    reference following it from its own coordinates (the benchmark check's
    form): each iteration's mean coarse gap at most 0.01 px and the
    full-resolution mean gap at most 0.03 px (largest seen 0.0038 and 0.0073
    over four seeds). The gaps must also exceed 1e-4 px: the bf16 path is
    on."""
    ref, port, pair = _setup(seed, mixed_precision=True)
    with torch.no_grad():
        p = port(*pair, ITERS)
        r = ref(*pair, ITERS, forced=p.flow_history)
    it = float((p.flow_history - r["flow_history"]).abs().flatten(2).mean(-1).max())
    up = float((p.flow - r["flow"]).abs().mean())
    assert 1e-4 < it <= 0.01
    assert 1e-4 < up <= 0.03


def test_engine_equals_eager_on_the_cpu():
    """`FlowEngine` on the CPU: the eager forward's bits; one program per
    iteration count and frame size; its counters, spans and marks (RAFT's
    and `coarse_gru` between `lookup` and `update`)."""
    _, port, pair = _setup(3, mixed_precision=True)
    tracer = profiling.Tracer("cpu")
    engine = FlowEngine(port, tracer=tracer)
    got = engine.flow(*pair, ITERS)
    with torch.no_grad():
        eager = port(*pair, ITERS)
    assert torch.equal(got.flow, eager.flow)
    assert torch.equal(got.flow_history, eager.flow_history)
    engine.flow(*pair, ITERS)
    engine.flow(*pair, 2)
    label = f"flow:{tuple(pair[0].shape)}:{ITERS}"
    counters = engine.counters()
    assert counters["graph_captures"] == 2
    assert counters["replays"] == {label: 2, label[:-1] + "2": 1}
    assert counters["flow_iters"][label] == ITERS
    # The f32 1D pyramid of a 24 x 40 grid: rows of 40, 20, 10, 5.
    assert counters["corr_pyramid_bytes"][label] == 4 * 960 * (40 + 20 + 10 + 5)
    assert "corr_lookup_1d" in counters["kernel_launches"]
    doc = tracer.export()
    stamps = [s["name"] for s in doc["stamps"] if s["call"] == 1]
    assert stamps == (["copy_in", "end", "encode", "corr"]
                      + ITERS * ["lookup", "coarse_gru", "update"]
                      + ["upsample", "end", "clone_out", "end"])


@pytest.mark.parametrize("case", ["in_range", "out_of_range"])
def test_lookup_1d_matches_the_reference_sampler(case):
    """The plain 1D lookup on the reference's own `CorrBlock1D` levels
    against its `bilinear_sampler` lookup, taps outside the row (zero)
    included, within 1e-5 on values up to about 5 (grid_sample's normalised
    coordinate moves the tap by about an ulp; largest seen 4.4e-6); the
    operator (on the CPU, the plain version) gives the plain version's
    bits; the port's 1D pyramid is `CorrBlock1D`'s read levels."""
    g = torch.Generator().manual_seed(8)
    f1, f2 = torch.randn(2, 1, 32, 6, 20, generator=g)
    block = ref_stereo.CorrBlock1D(f1, f2, num_levels=4, radius=4)
    coords = ref_stereo.coords_grid(1, 6, 20, "cpu")
    coords[:, 0] += 3.0 * torch.randn(1, 6, 20, generator=g)
    if case == "out_of_range":
        coords[:, 0, :3] = torch.tensor([-9.5, -4.25, 23.5])[:, None]
        coords[:, 0, 3, :4] = torch.tensor([-1e-9, 19.0, -5.0, 24.0])
    want = to_nhwc(block(coords))
    nhwc = to_nhwc(coords).contiguous()
    pyramid = corr_ops.build_corr_pyramid_1d(to_nhwc(f1), to_nhwc(f2), 4)
    for mine, theirs in zip(pyramid.levels, block.corr_pyramid):
        assert torch.allclose(mine, theirs.reshape(mine.shape), rtol=1e-5, atol=1e-6)
    levels = [t.reshape(t.shape[0], 1, t.shape[-1]) for t in block.corr_pyramid[:4]]
    got = corr_kernel.corr_lookup_1d_plain(levels, nhwc, 4)
    assert got.shape == (1, 6, 20, 36)
    assert float((got - want).abs().max()) <= 1e-5
    if case == "out_of_range":
        assert not got[0, 0, :3, :9].any()  # every tap of level 0 outside the row
    with torch.no_grad():
        assert torch.equal(corr_kernel.corr_lookup_1d(levels, nhwc, 4), got)
        assert torch.equal(corr_ops.corr_lookup_1d(corr_ops.CorrPyramid(tuple(levels)), nhwc,
                                                   4), got)


def test_reference_state_dict_loads_strictly_with_raft_stereo_names():
    """The reference's `state_dict` (RAFT-Stereo's names, the batch norms'
    running statistics and `norm3` twice) is the port's, key for key and
    shape for shape; the instance-norm `fnet` has no norm entries and runs
    its stem at stride 1."""
    ref, port = ref_stereo.RAFTStereo(), RAFTStereo()
    rs, ps = ref.state_dict(), port.state_dict()
    assert sorted(rs) == sorted(ps)
    assert all(rs[k].shape == ps[k].shape for k in rs)
    for key in ("cnet.outputs08.1.0.norm2.running_var", "cnet.outputs16.0.1.weight",
                "cnet.outputs32.1.bias", "cnet.layer5.0.norm3.weight",
                "cnet.layer4.0.downsample.1.running_mean", "context_zqr_convs.2.weight",
                "update_block.gru08.convq.weight", "update_block.gru32.convz.bias",
                "update_block.encoder.convc1.weight", "update_block.mask.2.weight",
                "fnet.layer3.0.downsample.0.weight"):
        assert key in ps, key
    assert tuple(ps["update_block.gru08.convz.weight"].shape) == (128, 384, 3, 3)
    assert tuple(ps["update_block.gru32.convz.weight"].shape) == (128, 256, 3, 3)
    assert tuple(ps["update_block.encoder.convc1.weight"].shape) == (64, 36, 1, 1)
    assert tuple(ps["update_block.mask.2.weight"].shape) == (144, 256, 1, 1)
    assert not [k for k in ps if k.startswith("fnet") and ".norm" in k]
    assert port.fnet.conv1.stride == (1, 1) and port.cnet.conv1.stride == (1, 1)
    port.load_state_dict({k: v.clone() for k, v in rs.items()}, strict=True)


@pytest.mark.parametrize("hw", [(1988, 2880), (90, 150), (375, 1242)])
def test_padder_round_trip_at_32(hw):
    """The pad of RAFT-Stereo's `InputPadder(divis_by=32)` in mode 'sintel'
    (1988 -> 2016 rows, 14 above and 14 below, replicated), bit for bit,
    and the unpad back; the divisor 8 stays RAFT's."""
    h, w = hw
    x = torch.rand(1, h, w, 3, generator=torch.Generator().manual_seed(h)) * 255
    padder = ref_stereo.InputPadder((1, 3, h, w), divis_by=32)
    want = padder.pad(x.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)
    got = pad_frames(x, DIVISOR)
    assert got.shape == want.shape and got.shape[1] % 32 == 0 and got.shape[2] % 32 == 0
    assert torch.equal(got, want)
    assert torch.equal(unpad(got, h, w, DIVISOR), x)
    assert torch.equal(unpad(got, h, w, DIVISOR),
                       padder.unpad(got.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    if hw == (1988, 2880):
        assert sintel_pad(h, w, 32) == (14, 14, 0, 0) and got.shape[1:3] == (2016, 2880)
        assert sintel_pad(h, w) == (2, 2, 0, 0)  # RAFT's default divisor of 8


def test_the_flow_stays_on_the_rows():
    """The motion encoder sees a flow whose y is exactly 0 in every
    iteration, though the flow head's raw y is not 0: the delta's y is
    forced to 0 before it moves the coordinates."""
    _, port, pair = _setup(4)
    seen, heads = [], []
    port.update_block.encoder.register_forward_hook(
        lambda mod, args, out: seen.append(args[0][:, 1].clone()))
    port.update_block.flow_head.register_forward_hook(
        lambda mod, args, out: heads.append(out[:, 1].clone()))
    with torch.no_grad():
        port(*pair, ITERS)
    assert len(seen) == len(heads) == ITERS
    assert all(not y.any() for y in seen)
    assert all(float(y.abs().max()) > 1e-3 for y in heads)


def test_raft_and_rnnpose_encoders_keep_their_stem_names_and_bits():
    """The default `BasicEncoder` (RNNPose's feature encoder and RAFT's
    `fnet`) keeps its stride-2 stem and stages of strides 1, 2, 2 (1/8),
    its names, and its bits: its output equals the stem, stages and
    projection run one by one; RAFT's reference `fnet` agrees within f32
    rounding."""
    enc = BasicEncoder(256).eval()
    ref = ref_flow.BasicEncoder(256, norm_fn="instance").eval()
    enc.load_state_dict(gen_flow.make_weights(ref, 9, "cpu"), strict=True)
    ref.load_state_dict(enc.state_dict(), strict=True)
    assert enc.conv1.stride == (2, 2)
    assert [blocks[0].conv1.stride for blocks in (enc.layer1, enc.layer2, enc.layer3)] == [
        (1, 1), (2, 2), (2, 2)]
    assert sorted(enc.state_dict()) == sorted(ref.state_dict())
    x = torch.rand(2, 64, 48, 3, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        got = enc(x)
        y = enc.norm1(enc.conv1(to_nchw(x)), relu=True)
        want = to_nhwc(enc.conv2(enc.layer3(enc.layer2(enc.layer1(y)))))
        r = ref(to_nchw(x).contiguous())
    assert got.shape == (2, 8, 6, 256)
    assert torch.equal(got, want)
    assert float((got - to_nhwc(r)).abs().max()) <= 1e-4
    cnet = BasicEncoder(256, norm="batch")
    assert cnet.conv1.stride == (2, 2) and "layer2.0.norm3.weight" in cnet.state_dict()
    # The operator runs the norms where no gradient is needed.
    assert kernels.uses_kernel("instance_norm", y, 1e-5, True)
