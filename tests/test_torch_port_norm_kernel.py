"""The instance norm's operator (`kernels/norm.instance_norm`, kernel
`csrc/instance_norm.cu`) on the CPU: its plain version against
`models/raft.InstanceNorm`'s chain as it stood before the operator (and the
ReLU after it), bit for bit, in bf16 and f32, channels-last and NCHW, at the
plane sizes of the four encoders and at odd ones; the dispatch of
`InstanceNorm` by whether a gradient is needed; `opcheck`; the wrapper's
checks; how the CUDA launch cuts each shape; `torch.export` holding one node
per norm; and a training step on the chain beside an eval forward on the
operator. The kernel itself runs only on the card
(`tests/test_torch_port_cuda.py`).
"""
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import same_bits
from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.kernels import norm as norm_kernel
from rnnpose_tpu_torch.models import raft
from rnnpose_tpu_torch.utils import bundle


def legacy_norm(x, eps=1e-5, relu=False):
    """`models/raft.InstanceNorm.forward` before the operator, and the
    caller's F.relu after it."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=(-2, -1), keepdim=True)
    var = x32.var(dim=(-2, -1), unbiased=False, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return F.relu(y) if relu else y


# (B, C, H, W): the planes of RNNPose's feature encoder at its 240^2 crop
# (120^2, 60^2, 30^2), SuperPoint's decoder at the half and full tails of a
# 320^2 image (80^2, 160^2), RAFT's `fnet` at 440 x 1024 (its stem's 220 x
# 512 and its 1/8 grid), with fewer channels; and odd planes.
SHAPES = {"encoder_120": (2, 16, 120, 120), "encoder_60": (2, 24, 60, 60),
          "encoder_30": (2, 32, 30, 30), "superpoint_80": (1, 16, 80, 80),
          "superpoint_160": (1, 8, 160, 160), "raft_stem": (1, 8, 220, 512),
          "raft_55x128": (1, 16, 55, 128), "odd_7x9": (3, 5, 7, 9), "odd_1x1": (2, 3, 1, 1)}


def problem(shape, dtype, layout, seed=0):
    """A seeded (B, C, H, W) input: a per-channel offset and scale, so the
    statistics are not 0 and 1, in `layout` ("nhwc" or "nchw")."""
    B, C, H, W = SHAPES[shape]
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, C, H, W, generator=g) * (1.0 + 3.0 * torch.rand(1, C, 1, 1, generator=g))
         + 5.0 * torch.randn(1, C, 1, 1, generator=g)).to(dtype)
    if layout == "nhwc":
        x = x.to(memory_format=torch.channels_last)
    return x


@pytest.mark.parametrize("relu", [False, True], ids=["norm", "relu"])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_version_is_the_chain_bit_for_bit(shape, dtype, layout, relu):
    """The operator on CPU tensors (its plain version) and `InstanceNorm`
    without gradient give the chain's bits, in its dtype and layout; the
    wrapper counts no launch."""
    x = problem(shape, dtype, layout)
    want = legacy_norm(x, 1e-5, relu)
    before = kernels.LAUNCHES["instance_norm"]
    got = norm_kernel.instance_norm(x, 1e-5, relu)
    assert kernels.LAUNCHES["instance_norm"] == before
    assert got.dtype == want.dtype == dtype and got.stride() == want.stride()
    assert same_bits(got.float(), want.float())
    assert same_bits(norm_kernel.instance_norm_plain(x, 1e-5, relu).float(), want.float())
    with torch.no_grad():
        assert same_bits(raft.InstanceNorm()(x, relu=relu).float(), want.float())
    if relu:
        assert (got >= 0).all()


@pytest.mark.parametrize("grad", ["no_grad", "nothing_requires_grad", "input"])
def test_instance_norm_takes_the_operator_only_without_gradient(monkeypatch, grad):
    """No gradient to keep (grad mode off, or nothing requiring one): one
    operator call, the chain's bits. The input requiring grad: the plain
    chain under autograd, no operator call, a gradient reaching the input."""
    x = problem("encoder_30", torch.bfloat16, "nhwc")
    want = legacy_norm(x, 1e-5, True)
    calls = []
    real = norm_kernel.instance_norm

    def counted(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(norm_kernel, "instance_norm", counted)
    norm = raft.InstanceNorm()
    if grad != "input":
        with torch.set_grad_enabled(grad != "no_grad"):
            got = norm(x, relu=True)
        assert len(calls) == 1 and same_bits(got.float(), want.float())
        return
    x = x.clone().requires_grad_(True)
    got = norm(x, relu=True)
    assert not calls and got.requires_grad and same_bits(got.detach().float(), want.float())
    (got.float() * torch.linspace(0, 1, got.numel()).view(got.shape)).sum().backward()
    assert x.grad is not None and float(x.grad.float().abs().sum()) > 0


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_operator_opcheck(dtype, layout):
    """`opcheck` (schema, fake implementation, dispatch) on an odd plane;
    the fake output has the real one's shape, dtype and strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x = problem("odd_7x9", dtype, layout)
    op = torch.ops.rnnpose.instance_norm.default
    torch.library.opcheck(op, (x, 1e-5, True))
    with FakeTensorMode() as mode:
        fake = op(mode.from_tensor(x), 1e-5, False)
    assert (tuple(fake.shape), fake.dtype, fake.stride()) == (tuple(x.shape), dtype, x.stride())


@pytest.mark.parametrize("bad", ["rank", "dtype", "layout", "empty"])
def test_wrapper_checks_its_arguments(bad):
    x = problem("odd_7x9", torch.float32, "nchw")
    if bad == "rank":
        with pytest.raises(ValueError, match="must be \\(B, C, H, W\\)"):
            norm_kernel.instance_norm(x[0])
    elif bad == "dtype":
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            norm_kernel.instance_norm(x.half())
    elif bad == "layout":
        with pytest.raises(ValueError, match="channels-last or contiguous"):
            norm_kernel.instance_norm(x.transpose(2, 3))
    else:
        with pytest.raises(ValueError, match="must hold elements"):
            norm_kernel.instance_norm(x[:, :0])


@pytest.mark.parametrize("case", ["raft_stem_bf16", "encoder_b16_bf16", "encoder_b2_bf16",
                                  "parity_f32", "nchw_f32", "nchw_odd", "nhwc_odd_channels",
                                  "offset", "second_mode"])
def test_launch_params_follow_the_shape(case):
    """The CUDA launch's cut of each shape on a card of 132 SMs: 16-byte
    vectors along the channels (channels-last) or the positions (NCHW)
    where they tile the run and the pointer is aligned, narrower ones where
    not; items of up to four vectors of a position's channels while the
    groups leave a cluster of 16 to every two SMs; the fewest blocks of at
    most 64 KiB that give a block to every four SMs, up to a cluster of 16;
    on chip up to 128 KiB a block, re-read past it. The items cover each
    group once."""
    shapes = {"raft_stem_bf16": ((2, 64, 220, 512), torch.bfloat16, "nhwc"),
              "encoder_b16_bf16": ((16, 64, 120, 120), torch.bfloat16, "nhwc"),
              "encoder_b2_bf16": ((2, 64, 120, 120), torch.bfloat16, "nhwc"),
              "parity_f32": ((8, 128, 160, 160), torch.float32, "nhwc"),
              "nchw_f32": ((2, 3, 30, 30), torch.float32, "nchw"),
              "nchw_odd": ((2, 3, 7, 9), torch.bfloat16, "nchw"),
              "nhwc_odd_channels": ((2, 6, 30, 30), torch.bfloat16, "nhwc"),
              "offset": ((2, 64, 30, 30), torch.bfloat16, "nhwc"),
              "second_mode": ((1, 8, 512, 512), torch.bfloat16, "nhwc")}
    shape, dtype, layout = shapes[case]
    x = torch.empty(shape, dtype=dtype)
    if layout == "nhwc":
        x = x.to(memory_format=torch.channels_last)
    if case == "offset":   # a channels-last view one element into its storage
        x = torch.empty(1 + x.numel(), dtype=dtype)[1:].view(2, 30, 30, 64).permute(0, 3, 1, 2)
    p = norm_kernel.launch_params(x, 132)
    B, C, H, W = shape
    want = {"raft_stem_bf16": (8, 2, 112640, 16, 0), "encoder_b16_bf16": (8, 4, 14400, 16, 1),
            "encoder_b2_bf16": (8, 2, 14400, 8, 1), "parity_f32": (4, 4, 25600, 16, 1),
            "nchw_f32": (4, 1, 225, 8, 1), "nchw_odd": (1, 1, 63, 8, 1),
            "nhwc_odd_channels": (2, 1, 900, 8, 1), "offset": (1, 1, 900, 1, 1),
            "second_mode": (8, 1, 262144, 16, 0)}[case]
    assert (p["vec"], p["lanes"], p["n_items"], p["tiles"], p["cached"]) == want
    assert p["combine"] == int(layout == "nchw") and p["count"] == H * W
    assert p["tiles"] * p["per_block"] >= p["n_items"] > (p["tiles"] - 1) * p["per_block"]
    assert p["groups"] * p["n_items"] * p["lanes"] * p["vec"] == C * H * W and p["B"] == B


def test_export_holds_one_node_per_norm():
    """`torch.export` of an instance-norm encoder without gradient: 15
    `rnnpose::instance_norm` nodes (the stem's and each residual block's
    two, ReLU included, and two downsampling norms) and nothing of the
    chain, and no ReLU but the residual sums'; the program gives the eager
    bits."""

    class Encode(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.enc = raft.BasicEncoder(32, torch.bfloat16)

        def forward(self, image):
            with torch.no_grad():
                return self.enc(image)

    torch.manual_seed(0)
    model = Encode().eval()
    image = torch.randn(2, 40, 48, 3)
    exported = torch.export.export(model, (image,), strict=False)
    assert bundle.operator_nodes(exported, kernels.OPS_NAMESPACE) == {"instance_norm": 15}
    targets = [str(n.target) for m in exported.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
               if n.op == "call_function"]
    assert not any("var" in t or "rsqrt" in t or "mean" in t for t in targets), targets
    assert sum("relu" in t for t in targets) == 6   # each residual block's sum's alone
    assert same_bits(exported.module()(image).float(), model(image).float())


def test_training_step_takes_the_chain_and_eval_the_operator(monkeypatch):
    """A training step's norms run the chain under autograd (the operator
    is never called: every norm's input requires grad), and the eval forward
    of the same model calls the operator 15 times per render iteration (the
    feature encoder) and 3 times for SuperPoint's half-resolution tail."""
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
    real = norm_kernel.instance_norm
    monkeypatch.setattr(norm_kernel, "instance_norm",
                        lambda *args: calls.append(1) or real(*args))
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(0))
    Trainer(model, OptimizerConfig()).run_step(batch)
    assert not calls
    with torch.no_grad():
        model(batch, train=False)
    assert len(calls) == 2 * 15 + 3
