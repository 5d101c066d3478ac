"""SuperPoint-style 2D descriptor network (port of
`rnnpose_tpu/models/superpoint.py`).

VGG encoder (4 x {conv, conv, pool}, 64/64/128/128), a 3-stage bilinear
upsample decoder with skips, a sigmoid saliency head (the JAX module's
default normalization, the only one its callers reach) and an
L2-normalised descriptor head.
Parameter names follow the reference checkpoint (`conv1a`, `decode1.1`,
`convPa.0`, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.upsample import upsample2x_bilinear
from .raft import Conv, InstanceNorm, to_nchw, to_nhwc

__all__ = ["SuperPoint2D"]


def _up(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling of an NCHW tensor (the NHWC stencil)."""
    return to_nchw(upsample2x_bilinear(to_nhwc(x)))


def _concat_conv(conv: Conv, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv(concat([a, b], channels)) as two convolutions over the split
    kernel, so the concatenated tensor is never built."""
    ca = a.shape[1]
    dt = conv.compute_dtype or torch.promote_types(a.dtype, conv.weight.dtype)
    w = conv.weight.to(dt)
    y = (F.conv2d(a.to(dt), w[:, :ca], None, 1, conv.padding)
         + F.conv2d(b.to(dt), w[:, ca:], None, 1, conv.padding))
    return y + conv.bias.to(dt)[:, None, None]


class SuperPoint2D(nn.Module):
    """Dense L2-normalised descriptors: (B, H, W, 3) -> (B, H', W', D) f32,
    and on request the saliency scores (B, H', W', 1) f32.

    The saliency head (`convPa`, `convPb`) runs only when `compute_scores`
    is set (the training forward sets it); its output feeds no loss, as in
    the reference."""

    def __init__(self, descriptor_dim: int = 32, mixed_precision: bool = True):
        super().__init__()
        dt = torch.bfloat16 if mixed_precision else None
        c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256
        cin = 3
        for i, ch in enumerate((c1, c2, c3, c4)):
            setattr(self, f"conv{i + 1}a", Conv(cin, ch, 3, dtype=dt))
            setattr(self, f"conv{i + 1}b", Conv(ch, ch, 3, dtype=dt))
            cin = ch
        # Index 0 of each decode stage is the reference's upsampling layer
        # (parameter-free); the convolution sits at index 1.
        self.decode1 = nn.Sequential(nn.Identity(), Conv(c4, c4, 3, dtype=dt))
        self.decode2 = nn.Sequential(nn.Identity(), Conv(c4 + c3, c4, 3, dtype=dt))
        self.decode3 = nn.Sequential(nn.Identity(), Conv(c4 + c2, c4, 3, dtype=dt))
        self.convPa = nn.Sequential(Conv(c4, c5, 3, dtype=dt))
        self.convPb = Conv(c5, 1, 1, dtype=dt)
        self.convDa = Conv(c4, c5, 3, dtype=dt)
        self.convDb = Conv(c5, descriptor_dim, 1, dtype=dt)
        self.norm = InstanceNorm()

    def forward(self, image: torch.Tensor, tail_res: str = "full",
                compute_scores: bool = False):
        """Descriptors, or (scores, descriptors) with `compute_scores`.
        `tail_res='half'` runs decode3 and the heads at 1/2 resolution with
        the same parameters; 'full' at the input's."""
        x = to_nchw(image)
        skips = []
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i + 1}a")(x))
            x = F.relu(getattr(self, f"conv{i + 1}b")(x))
            if i < 3:
                skips.append(x)
                x = F.max_pool2d(x, 2, 2)

        norm = self.norm
        x = norm(self.decode1[1](_up(x)), relu=True)
        x = norm(_concat_conv(self.decode2[1], _up(x), _up(skips[2])), relu=True)
        if tail_res == "half":
            x = norm(_concat_conv(self.decode3[1], x, skips[1]), relu=True)
        elif tail_res == "full":
            x = norm(_concat_conv(self.decode3[1], _up(x), _up(skips[1])), relu=True)
        else:
            raise ValueError(tail_res)

        desc = self.convDb(F.relu(self.convDa(x))).to(torch.float32)
        sq = torch.sum(desc * desc, dim=1, keepdim=True)
        desc = to_nhwc(desc * torch.rsqrt(torch.clamp(sq, min=1e-16)))
        if not compute_scores:
            return desc
        scores = torch.sigmoid(self.convPb(norm(self.convPa[0](x), relu=True)).to(torch.float32))
        return to_nhwc(scores), desc
