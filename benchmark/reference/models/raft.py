"""RAFT building blocks (port of `rnnpose_tpu/models/raft.py`).

Module and parameter names follow the reference torch checkpoints
(`fnet.layer1.0.conv1`, `update_block.gru.convz1`, `update_block.mask.0`,
...), so converted weights load strictly. The inner blocks run NCHW; the
public `BasicEncoder` and `BasicUpdateBlock` take and return NHWC like the
JAX modules.

Mixed precision mirrors the flax `dtype=` casts: parameters stay f32, and a
`Conv` with a compute dtype casts its input, weight and bias to it;
`InstanceNorm` statistics are always taken in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Conv",
    "InstanceNorm",
    "ResidualBlock",
    "BasicEncoder",
    "FlowHead",
    "SepConvGRU",
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

    # The benchmark's lower-precision control sets it on the convolutions
    # that run in a compute dtype: their input and weight are rounded to
    # float8 (e4m3, one scale per tensor) before the convolution.
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        w = self.weight
        if self.fp8:
            x, w = _fp8_round(x), _fp8_round(w)
        return F.conv2d(x.to(dt), w.to(dt), self.bias.to(dt), self.stride, self.padding)


def _fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude maps to 448, e4m3's largest finite value), in t's dtype."""
    t32 = t.to(torch.float32)
    scale = t32.abs().amax().clamp(min=1e-30) / 448.0
    return ((t32 / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale).to(t.dtype)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False) over H, W of an NCHW tensor, with the
    statistics in f32 and the result in the input dtype."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=(-2, -1), keepdim=True)
        var = x32.var(dim=(-2, -1), unbiased=False, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + self.epsilon)).to(x.dtype)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride=stride, padding=1, dtype=dtype)
        self.conv2 = Conv(planes, planes, 3, dtype=dtype)
        self.norm = InstanceNorm()
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                Conv(in_planes, planes, 1, stride=stride, padding=0, dtype=dtype),
                InstanceNorm(),
            )

    def forward(self, x):
        y = F.relu(self.norm(self.conv1(x)))
        y = F.relu(self.norm(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """1/8-resolution feature encoder: 7x7 stride-2 stem, three 2-block
    residual stages (64/96/128, strides 1/2/2), 1x1 projection."""

    def __init__(self, output_dim: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, dtype=dtype)
        self.norm1 = InstanceNorm()
        stages, cin = [], 64
        for planes, stride in ((64, 1), (96, 2), (128, 2)):
            stages.append(nn.Sequential(
                ResidualBlock(cin, planes, stride, dtype),
                ResidualBlock(planes, planes, 1, dtype),
            ))
            cin = planes
        self.layer1, self.layer2, self.layer3 = stages
        self.conv2 = Conv(128, output_dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/8, W/8, output_dim)."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(self.norm1(self.conv1(to_nchw(x))))
        x = self.layer3(self.layer2(self.layer1(x)))
        return to_nhwc(self.conv2(x))


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


class BasicMotionEncoder(nn.Module):
    """corr + flow -> 128-channel motion features (NCHW)."""

    def __init__(self, corr_planes: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convc1 = Conv(corr_planes, 256, 1, dtype=dtype)
        self.convc2 = Conv(256, 192, 3, dtype=dtype)
        self.convf1 = Conv(2, 128, 7, dtype=dtype)
        self.convf2 = Conv(128, 64, 3, dtype=dtype)
        self.conv = Conv(64 + 192, 128 - 2, 3, dtype=dtype)

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
