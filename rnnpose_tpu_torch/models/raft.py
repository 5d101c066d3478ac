"""RAFT building blocks (port of `rnnpose_tpu/models/raft.py`).

Module and parameter names follow the reference torch checkpoints
(`fnet.layer1.0.conv1`, `update_block.gru.convz1`, `update_block.mask.0`,
...), so converted weights load strictly. The inner blocks run NCHW; the
public `BasicEncoder` and `BasicUpdateBlock` take and return NHWC like the
JAX modules.

Mixed precision mirrors the flax `dtype=` casts: parameters stay f32, and a
`Conv` with a compute dtype casts its input, weight and bias to it;
`InstanceNorm` and `BatchNorm` statistics are always taken in f32. Both
norms take `relu=True` where the ReLU follows them directly; where no
gradient is needed `InstanceNorm` is one call of the operator
`kernels/norm.instance_norm` (one kernel launch on the card, and on the CPU
its plain version, the same bits as the chain), otherwise that plain
version (`instance_norm_plain`, a chain of PyTorch ops) under autograd, as
for a CPU map of a dtype the kernel does not take (`kernels.dispatch`; on
the card the wrapper raises on one).

`BasicEncoder(norm="instance")` is RNNPose's feature encoder and RAFT's
`fnet`; `norm="batch"` is RAFT's context encoder `cnet`, whose norms carry
RAFT's names (`norm1`, `layer2.0.norm1`, `norm2`, and `norm3`, which is also
`downsample.1`) with their weights, biases and running statistics. Its
`downsample` is RAFT-Stereo's (`core/extractor.py`): the default 3 (1/8
resolution, the 7x7 stem at stride 2) is RNNPose's and RAFT's; at 2 the stem
runs at stride 1 (1/4 resolution), as RAFT-Stereo's `fnet` and the trunk of
its `MultiBasicEncoder` (`models/raft_stereo.py`). `ConvGRU` is RAFT-Stereo's
3x3 GRU with the context terms added to its gates; `BasicMotionEncoder`
takes RAFT-Stereo's narrower widths.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from ..kernels import norm as norm_kernel

__all__ = [
    "Conv",
    "InstanceNorm",
    "BatchNorm",
    "ResidualBlock",
    "BasicEncoder",
    "FlowHead",
    "SepConvGRU",
    "ConvGRU",
    "BasicMotionEncoder",
    "BasicUpdateBlock",
    "to_nchw",
    "to_nhwc",
]


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """Conv2d with 'SAME' padding for odd kernels (unless given) and an
    optional compute dtype (None: the promoted input/parameter dtype)."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=None, dtype: Optional[torch.dtype] = None):
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        if padding is None:
            padding = (kh // 2, kw // 2)
        super().__init__(cin, cout, (kh, kw), stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False) over H, W of an NCHW tensor, with the
    statistics in f32 and the result in the input dtype; F.relu after it
    with `relu`."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return kernels.dispatch("instance_norm", norm_kernel.instance_norm, x, self.epsilon,
                                relu)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d over an NCHW tensor with its statistics in f32 and the
    result in the input dtype (in eval mode: the running statistics); F.relu
    after it with `relu`."""

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        y = super().forward(x.to(torch.float32)).to(x.dtype)
        return F.relu(y) if relu else y


def _norm(kind: str, planes: int) -> nn.Module:
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return BatchNorm(planes)
    raise ValueError(f"norm must be 'instance' or 'batch', got {kind!r}")


class ResidualBlock(nn.Module):
    """Two 3x3 convolutions with a residual path. Instance norm: one
    parameterless `norm` for both; batch norm: `norm1`, `norm2` and, with a
    downsampling path, `norm3` (RAFT's names)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None, norm: str = "instance"):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride=stride, padding=1, dtype=dtype)
        self.conv2 = Conv(planes, planes, 3, dtype=dtype)
        if norm == "instance":
            self.norm = _norm(norm, planes)
        else:
            self.norm1, self.norm2 = _norm(norm, planes), _norm(norm, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            last = _norm(norm, planes)
            if norm == "batch":
                self.norm3 = last  # RAFT's name for `downsample.1`
            self.downsample = nn.Sequential(
                Conv(in_planes, planes, 1, stride=stride, padding=0, dtype=dtype), last)

    def forward(self, x):
        if hasattr(self, "norm"):
            norm1 = norm2 = self.norm
        else:
            norm1, norm2 = self.norm1, self.norm2
        y = norm1(self.conv1(x), relu=True)
        y = norm2(self.conv2(y), relu=True)
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Feature encoder: 7x7 stem, three 2-block residual stages (64/96/128),
    1x1 projection; `norm` "instance" or "batch". `downsample` 3: stem
    stride 2, stage strides 1/2/2 (1/8 resolution); 2: stem stride 1
    (1/4)."""

    def __init__(self, output_dim: int = 256, dtype: Optional[torch.dtype] = None,
                 norm: str = "instance", downsample: int = 3):
        super().__init__()
        self._trunk(dtype, norm, downsample)
        self.conv2 = Conv(128, output_dim, 1, dtype=dtype)

    def _trunk(self, dtype, norm: str, downsample: int) -> None:
        """The stem and the three stages, with RAFT-Stereo's strides: stem
        1 + (downsample > 2), stages 1, 1 + (downsample > 1), 1 + (downsample
        > 0)."""
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, stride=1 + (downsample > 2), padding=3, dtype=dtype)
        self.norm1 = _norm(norm, 64)
        stages, cin = [], 64
        for planes, stride in ((64, 1), (96, 1 + (downsample > 1)), (128, 1 + (downsample > 0))):
            stages.append(nn.Sequential(
                ResidualBlock(cin, planes, stride, dtype, norm),
                ResidualBlock(planes, planes, 1, dtype, norm),
            ))
            cin = planes
        self.layer1, self.layer2, self.layer3 = stages

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> the third stage's (B, 128, H/s, W/s), NCHW."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.norm1(self.conv1(to_nchw(x)), relu=True)
        return self.layer3(self.layer2(self.layer1(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/s, W/s, output_dim), s = 2^downsample."""
        return to_nhwc(self.conv2(self.trunk(x)))


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(input_dim, hidden_dim, 3, dtype=dtype)
        self.conv2 = Conv(hidden_dim, 2, 3, dtype=dtype)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """Separable 1x5 / 5x1 ConvGRU (NCHW)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cin = hidden_dim + input_dim
        for i, k in ((1, (1, 5)), (2, (5, 1))):
            for g in ("z", "r", "q"):
                setattr(self, f"conv{g}{i}", Conv(cin, hidden_dim, k, dtype=dtype))

    def forward(self, h, x):
        for i in (1, 2):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx))
            q = torch.tanh(getattr(self, f"convq{i}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class ConvGRU(nn.Module):
    """RAFT-Stereo's 3x3 ConvGRU (NCHW), with context terms added to its
    gates: z = sigmoid(convz([h, x]) + cz), r = sigmoid(convr([h, x]) + cr),
    q = tanh(convq([r h, x]) + cq), h = (1 - z) h + z q, x the inputs
    concatenated."""

    def __init__(self, hidden_dim: int, input_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        for g in ("z", "r", "q"):
            setattr(self, f"conv{g}", Conv(hidden_dim + input_dim, hidden_dim, 3, dtype=dtype))

    def forward(self, h, cz, cr, cq, *xs):
        x = torch.cat(xs, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """corr + flow -> 128-channel motion features (NCHW). `widths`: convc1,
    convc2, convf1 and convf2's outputs, RAFT's (256, 192, 128, 64) or
    RAFT-Stereo's (64, 64, 64, 64)."""

    def __init__(self, corr_planes: int, dtype: Optional[torch.dtype] = None,
                 widths: Tuple[int, int, int, int] = (256, 192, 128, 64)):
        super().__init__()
        c1, c2, f1, f2 = widths
        self.convc1 = Conv(corr_planes, c1, 1, dtype=dtype)
        self.convc2 = Conv(c1, c2, 3, dtype=dtype)
        self.convf1 = Conv(2, f1, 7, dtype=dtype)
        self.convf2 = Conv(f1, f2, 3, dtype=dtype)
        self.conv = Conv(f2 + c2, 128 - 2, 3, dtype=dtype)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


class BasicUpdateBlock(nn.Module):
    """Motion encoder + SepConvGRU + flow head + upsample-mask head."""

    def __init__(self, corr_planes: int, hidden_dim: int = 128,
                 context_dim: int = 128, downsample_scale: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes, dtype)
        self.gru = SepConvGRU(hidden_dim, context_dim + 128, dtype)
        self.flow_head = FlowHead(hidden_dim, 256, dtype)
        s = downsample_scale
        self.mask = nn.Sequential(
            Conv(hidden_dim, 256, 3, dtype=dtype), nn.ReLU(),
            Conv(256, s * s * 9, 1, dtype=dtype),
        )

    def forward(self, h, inp, corr, flow) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC h, inp, corr, flow -> (h, delta_flow f32).

        The JAX module also returns the upsample mask; only the convex
        upsampling of the full-res flow reads it (`GRUFlowStep` with
        `emit_full_flow`), so here it is `upsample_mask(h)`, called by
        whoever needs it."""
        flow = to_nchw(flow)
        motion = self.encoder(flow, to_nchw(corr))
        x = torch.cat([to_nchw(inp).to(motion.dtype), motion], dim=1)
        h = self.gru(to_nchw(h), x)
        delta = self.flow_head(h).to(torch.float32)
        return to_nhwc(h), to_nhwc(delta)

    def upsample_mask(self, h: torch.Tensor) -> torch.Tensor:
        """NHWC hidden state -> (B, H, W, 9 * s * s) f32 upsample logits."""
        return to_nhwc(0.25 * self.mask(to_nchw(h))).to(torch.float32)
