"""RAFT (`rnnpose_tpu_torch/models/raft_flow.py`) against the benchmark's
plain reference (`benchmark/reference/models/raft_flow.py`, RAFT's
`core/raft.py` in f32), at RAFT's published widths (hidden and context 128,
4 correlation levels of radius 4, encoders of output 256) on seeded random
weights (`benchmark/gen_flow.make_weights`) and small seeded frame pairs
(`gen_flow.make_pairs`) on the CPU.

The frames are 132 x 164, padded to 136 x 168: a 17 x 21 grid, whose
coarsest level is 2 x 2. RAFT's `bilinear_sampler` divides by (H - 1) of
each level, so a grid under 16 rows or columns gives a 1-wide level and
NaN in the reference (RAFT's own code); the port's lookup has no such
division.

* The eager f32 forward against the reference: the coarse flow after each
  iteration and the full-resolution flow.
* `FlowEngine` on the CPU (its program runs the eager forward on the
  static buffers): the eager forward's bits, one program per iteration
  count and frame size, its counters and its spans.
* The bf16 configuration against the f32 reference, in the benchmark
  check's form: each iteration from the program's own coordinates.
* The reference's `state_dict` loads strictly into the port; RNNPose's
  instance-norm encoder keeps its names.
* The padder's 436 -> 440 -> 436 round trip against RAFT's `InputPadder`.
* The `.flo` tool on a small pair.
* RNNPose's programs of three classes replayed out of the order they were
  made in, and RAFT's at two frame sizes, each equal to the eager forward.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import gen_flow
from benchmark.reference.models import raft_flow as ref_flow
from rnnpose_tpu_torch.models.engine import FlowEngine, InferenceEngine
from rnnpose_tpu_torch.models.raft import BasicEncoder, BatchNorm
from rnnpose_tpu_torch.models.raft_flow import (
    RAFT, RAFTConfig, pad_frames, sintel_pad, unpad)
from rnnpose_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, ITERS = 132, 164, 3


def _setup(seed: int, mixed_precision: bool = False):
    """(reference, port, frame pair) on seeded weights and frames."""
    ref = ref_flow.RAFT().eval()
    weights = gen_flow.make_weights(ref, seed, "cpu")
    ref.load_state_dict(weights, strict=True)
    port = RAFT(RAFTConfig(mixed_precision=mixed_precision)).eval()
    port.load_state_dict(weights, strict=True)
    gen = torch.Generator().manual_seed(seed)
    i1, i2, _ = gen_flow.make_pairs(1, H, W, 8, 2.0, gen)
    return ref, port, (i1, i2)


@pytest.mark.parametrize("seed", [0, 1])
def test_eager_f32_forward_matches_reference(seed):
    """Every iteration's coarse flow within 5e-5 px and the full-resolution
    flow within 2e-4 px (largest seen 7.6e-6 and 2.7e-5 over four seeds):
    RAFT's `grid_sample` normalises each sample coordinate to [-1, 1] and
    back, which moves it by about an ulp, where the port gathers the taps
    at the coordinate itself, and the convolutions sum in other orders;
    flows reach 20 px, so an ulp of theirs is ~2e-6."""
    ref, port, pair = _setup(seed)
    with torch.no_grad():
        r, p = ref(*pair, ITERS), port(*pair, ITERS)
    assert p.flow.shape == r["flow"].shape == (1, H, W, 2)
    assert p.flow_history.shape == r["flow_history"].shape == (ITERS, 1, 17, 21, 2)
    assert float(r["flow"].abs().max()) > 1.0  # the flow moved
    assert float((p.flow_history - r["flow_history"]).abs().max()) <= 5e-5
    assert float((p.flow - r["flow"]).abs().max()) <= 2e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_forward_against_f32_reference(seed):
    """The configuration's precision (bf16 convolutions, f32 correlation,
    coordinates, norm statistics and upsampling) against the f32
    reference following it from its own coordinates (the benchmark check's
    form): each iteration's mean coarse gap at most 0.015 px and the
    full-resolution mean gap at most 0.06 px (largest seen 0.0059 and
    0.030 over four seeds). bf16 keeps 8 bits of mantissa, so each
    convolution's input and weight move by up to 2^-9 of themselves, and
    the motion encoder, GRU and flow head chain 12 convolutions a step.
    The gaps must also exceed 1e-4 px: the bf16 path is on."""
    ref, port, pair = _setup(seed, mixed_precision=True)
    with torch.no_grad():
        p = port(*pair, ITERS)
        r = ref(*pair, ITERS, forced=p.flow_history)
    it = float((p.flow_history - r["flow_history"]).norm(dim=-1).flatten(2).mean(-1).max())
    up = float((p.flow - r["flow"]).norm(dim=-1).mean())
    assert 1e-4 < it <= 0.015
    assert 1e-4 < up <= 0.06


def test_forced_reference_follows_the_given_coordinates():
    """The reference's `forced` run over its own free run's history is the
    free run again, within 1e-3 px: iteration k starts from coords0 +
    (coords1 - coords0), an ulp of the coordinates (~1.5e-5 px at 128) off
    the coordinates it reached. Forced along another history (zero flow),
    its steps are those taken from that history's coordinates."""
    ref, _, pair = _setup(2)
    with torch.no_grad():
        free = ref(*pair, ITERS)
        forced = ref(*pair, ITERS, forced=free["flow_history"])
        still = ref(*pair, ITERS, forced=torch.zeros_like(free["flow_history"]))
        first = ref(*pair, 1)
    assert float((free["flow"] - forced["flow"]).abs().max()) <= 1e-3
    assert float((free["flow_history"] - forced["flow_history"]).abs().max()) <= 1e-3
    # From zero flow every step has the first iteration's input but the
    # hidden state of its own: step 0 is the free run's exactly.
    assert torch.equal(still["flow_history"][0], first["flow_history"][0])
    assert float((still["flow_history"][-1] - free["flow_history"][-1]).abs().max()) > 0.1


def test_engine_equals_eager_on_the_cpu():
    """`FlowEngine` on the CPU: the eager forward's bits; one program per
    iteration count and frame size; its counters, spans and marks."""
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
    # The f32 pyramid of a 17 x 21 grid: levels of 17 x 21, 8 x 10, 4 x 5, 2 x 2.
    assert counters["corr_pyramid_bytes"][label] == 4 * 357 * (357 + 8 * 10 + 4 * 5 + 2 * 2)
    doc = tracer.export()
    stamps = [s["name"] for s in doc["stamps"] if s["call"] == 1]
    assert stamps == (["copy_in", "end", "encode", "corr"] + ITERS * ["lookup", "update"]
                      + ["upsample", "end", "clone_out", "end"])
    assert {s["name"] for s in doc["spans"]} >= {"engine/flow", "engine/copy_in",
                                                 "engine/replay", "engine/clone_out"}
    with pytest.raises(ValueError, match="differ in shape"):
        engine.flow(pair[0], pair[1][:, :-8], ITERS)


def test_reference_state_dict_loads_strictly_with_raft_names():
    """The reference's `state_dict` (RAFT's names, the batch norms' running
    statistics and `norm3` twice, as itself and as `downsample.1`) is the
    port's, key for key and shape for shape; the instance-norm `fnet` has
    no norm entries. RNNPose's instance-norm encoder keeps its names."""
    ref, port = ref_flow.RAFT(), RAFT()
    rs, ps = ref.state_dict(), port.state_dict()
    assert list(sorted(rs)) == list(sorted(ps))
    assert all(rs[k].shape == ps[k].shape for k in rs)
    for key in ("cnet.norm1.running_var", "cnet.layer1.0.norm2.weight",
                "cnet.layer2.0.norm3.bias", "cnet.layer2.0.downsample.1.running_mean",
                "cnet.layer3.0.downsample.1.num_batches_tracked", "update_block.mask.2.weight",
                "update_block.gru.convq2.bias", "fnet.layer3.0.downsample.0.weight"):
        assert key in ps, key
    assert not [k for k in ps if k.startswith("fnet") and ".norm" in k]
    assert port.cnet.layer2[0].norm3 is port.cnet.layer2[0].downsample[1]
    port.load_state_dict({k: v.clone() for k, v in rs.items()}, strict=True)
    inst = BasicEncoder(256)
    assert not [k for k in inst.state_dict() if "norm" in k]
    assert hasattr(inst.layer2[0], "norm") and not hasattr(inst.layer2[0], "norm1")


def test_batch_norm_keeps_f32_statistics_and_the_input_dtype():
    """`BatchNorm` in eval mode: the running statistics applied in f32, the
    result in the input's dtype; in f32 the plain `BatchNorm2d`'s bits."""
    bn = BatchNorm(8).eval()
    with torch.no_grad():
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 2.0)
        bn.weight.normal_()
        bn.bias.normal_()
    plain = torch.nn.BatchNorm2d(8).eval()
    plain.load_state_dict(bn.state_dict())
    x = torch.randn(2, 8, 5, 6, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(bn(x), plain(x))
        y = bn(x.bfloat16())
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, plain(x.bfloat16().float()).bfloat16())


@pytest.mark.parametrize("hw", [(436, 1024), (132, 164), (440, 1024), (375, 1242)])
def test_padder_round_trip(hw):
    """The pad of RAFT's `InputPadder` in mode 'sintel' (436 -> 440 rows,
    2 above and 2 below, replicated), bit for bit, and the unpad back."""
    h, w = hw
    x = torch.rand(1, h, w, 3, generator=torch.Generator().manual_seed(h)) * 255
    padder = ref_flow.InputPadder((1, 3, h, w))
    want = padder.pad(x.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)
    got = pad_frames(x)
    assert got.shape == want.shape and got.shape[1] % 8 == 0 and got.shape[2] % 8 == 0
    assert torch.equal(got, want)
    assert torch.equal(unpad(got, h, w), x)
    assert torch.equal(unpad(got, h, w), padder.unpad(got.permute(0, 3, 1, 2))
                       .permute(0, 2, 3, 1))
    if hw == (436, 1024):
        assert sintel_pad(h, w) == (2, 2, 0, 0)


def test_flow_tool_writes_a_flo_file(tmp_path):
    """`tools/flow.py` on two PNG files: the `.flo` file holds the engine's
    flow under the tool's default-initialised weights; with a RAFT
    checkpoint (`module.` prefixes, as `nn.DataParallel` saves it) it loads
    it strictly and its flow is the reference's under those weights."""
    from rnnpose_tpu_torch.data.imageio import write_png
    from rnnpose_tpu_torch.tools.flow import read_flo, write_flo

    gen = torch.Generator().manual_seed(4)
    i1, i2, _ = gen_flow.make_pairs(1, H, W, 8, 2.0, gen)
    paths = []
    for k, img in enumerate((i1, i2)):
        paths.append(str(tmp_path / f"frame{k}.png"))
        write_png(paths[-1], img[0].round().to(torch.uint8).numpy())
    ref = ref_flow.RAFT().eval()
    weights = gen_flow.make_weights(ref, 4, "cpu")
    ref.load_state_dict(weights)
    ckpt = str(tmp_path / "raft-test.pth")
    torch.save({f"module.{k}": v for k, v in weights.items()}, ckpt)
    out = str(tmp_path / "flow.flo")
    cmd = [sys.executable, "-m", "rnnpose_tpu_torch.tools.flow", *paths, "--out", out,
           "--device", "cpu", "--iters", "2", "--pretrained_path", ckpt]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    got = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env=env, check=True)
    summary = json.loads(got.stdout.strip().splitlines()[-1])
    assert summary["height"] == H and summary["width"] == W and summary["pretrained"]
    flow = read_flo(out)
    assert flow.shape == (H, W, 2)
    x1, x2 = (torch.from_numpy(np.round(f[0].numpy())).float()[None] for f in (i1, i2))
    with torch.no_grad():
        want = ref(x1, x2, 2)["flow"][0].numpy()
    assert np.abs(flow - want).max() <= 2e-4  # the f32 bound of the eager test
    with open(out, "rb") as f:
        head = f.read(12)
    assert head[:4] == b"PIEH" and np.frombuffer(head[4:], "<i4").tolist() == [W, H]
    write_flo(str(tmp_path / "again.flo"), flow)
    assert np.array_equal(read_flo(str(tmp_path / "again.flo")), flow)


def _rnnpose_scene():
    """A tiny RNNPose model on the CPU (the card tests' 96^2 scene, f32) and
    one request at B=1."""
    from rnnpose_tpu_torch.data.synthetic import (
        SyntheticConfig, kpconv_config, make_synthetic_inputs)
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_

    syn = SyntheticConfig(image_size=96, num_verts=256, num_faces=512, subdivisions=2,
                          fx=150.0, fy=150.0, kp_layers=2, kp_dl=0.03)
    kp = kpconv_config(syn)
    model = RNNPose(RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32, first_feats_dim=16,
                                    gnn_feats_dim=16),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False,
                                   first_feats_dim=16, gnn_feats_dim=16),
        refiner=RefinerConfig(zoom_crop_size=48, corr_levels=3, raster_chunk=64,
                              render_iters=1, gru_iters=2, mixed_precision=False)))
    model = init_random_(model, torch.Generator().manual_seed(0)).eval()
    return model, make_synthetic_inputs(syn)


def test_programs_replayed_out_of_the_order_they_were_made_in():
    """Three classes' RNNPose programs made in one order and run in another,
    and RAFT's at two frame sizes on the same core, each request equal to
    the eager forward; no request after the first of its key makes a
    program."""
    from rnnpose_tpu_torch.geometry.se3 import se3_expm

    model, base = _rnnpose_scene()
    engine = InferenceEngine(model)
    gen = torch.Generator().manual_seed(3)

    def moved():
        return base._replace(T_init=se3_expm(torch.randn(1, 6, generator=gen) * 1e-3)
                             @ base.T_init)

    for name in "abc":
        engine.prepare(name, moved())
    for name in "cabbca":
        r = moved()
        got = engine.refine(name, r)
        d3, c3 = engine.class_features(name, None)
        eager = model(r, cached_desc3d=d3, cached_ctx3d=c3)
        assert torch.equal(got["Ti_pred"], eager["Ti_pred"])
        assert torch.equal(got["refiner"].flow_history, eager["refiner"].flow_history)
    assert engine.graph_captures == 3 and engine.encode_3d_calls == 3
    assert sorted(engine.replays.values()) == [2, 2, 2]

    _, raft, pair = _setup(5, mixed_precision=True)
    flows = FlowEngine(raft)
    small = tuple(x[:, :128, :136].contiguous() for x in pair)
    for p in (pair, small, pair, small):
        got = flows.flow(*p, ITERS)
        with torch.no_grad():
            eager = raft(*p, ITERS)
        assert torch.equal(got.flow, eager.flow)
        assert torch.equal(got.flow_history, eager.flow_history)
    assert flows.graph_captures == 2
