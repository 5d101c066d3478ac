"""RAFT-Stereo, the stereo-matching model (Lipson, Teed & Deng, 3DV 2021;
github.com/princeton-vl/RAFT-Stereo `core/raft_stereo.py`), on the port's
RAFT blocks.

`RAFTStereo(cfg)(image1, image2, iters=32)` takes a batch of rectified
pairs (B, H, W, 3) in [0, 255] (any H and W) and returns `FlowOutputs`: the
full-resolution x-flow (B, H, W, 1), the negated disparity of image1 against
image2, and the coarse x-flow after each iteration (iters, B, Hp/4, Wp/4,
1). The published default model, the one of `train_stereo.py` and
`evaluate_stereo.py` (`n_downsample 2`, `n_gru_layers 3`, `hidden_dims
128 x 3`, 4 correlation levels of radius 4, `context_norm batch`,
`corr_implementation reg`, no shared backbone, no slow-fast GRU).

The forward pads the frames to a multiple of 32 (`InputPadder(divis_by=32)`
in mode 'sintel': replicated rows and columns split between both sides;
1988 -> 2016 rows), normalises them to 2 x / 255 - 1, and runs `fnet`
(instance norm, `downsample=2`: the 7x7 stem at stride 1, so its first stage
runs at the frames' full resolution) on both frames in one pass and `cnet`
(`MultiBasicEncoder`, batch norm) on the first: the trunk at 1/4, two more
stages at 1/8 and 1/16, and per level two heads, the GRU's hidden state
(tanh) and its input (relu), which `context_zqr_convs` turns once per pair
into each gate's context term (cz, cr, cq). `ops/corr.build_corr_pyramid_1d`
builds `CorrBlock1D`'s volume: for each position of the 1/4 grid, its image
row's correlations with the second frame, in f32, pooled by two along the
row per level. Then `iters` iterations of: the 1D lookup (2r+1 linear taps a
level), the coupled update (`BasicMultiUpdateBlock`: gru32 on the 1/16 grid
from pool2x of the 1/8 state, gru16 on the 1/8 grid from pool2x of the 1/4
state and the 1/16 state interpolated up, then the motion encoder and gru08
on the 1/4 grid from the motion features and the 1/8 state interpolated up,
then the flow head), the delta's y forced to 0 and `coords1 += delta`, from a
zero flow. Last, the mask head on the 1/4 state, the convex 4x upsampling
(`ops/upsample.convex_upsample`) of the x-flow, and the unpad. In test mode
RAFT-Stereo computes the mask and the upsampling after the last iteration
only: the same numbers.

Submodules and their parameters and buffers carry RAFT-Stereo's names
(`fnet`, `cnet` with `outputs08`, `outputs16` and `outputs32`,
`context_zqr_convs`, `update_block` with `gru08`, `gru16`, `gru32`,
`flow_head` and `mask`), so a RAFT-Stereo `state_dict` loads strictly.

Precision: with `mixed_precision` the convolutions compute in bf16
(RAFT-Stereo's own `--mixed_precision` is fp16 autocast), and the GRUs'
states and gates follow them; the correlation volume and its lookup, the
coordinates, the norms' statistics and the upsampling are f32 always. On the
card the forward turns TF32 off for matmuls and cuDNN, so the correlation is
exact f32.

After a forward, `pyramid_nbytes` holds the bytes of the correlation
pyramid it built, read from the levels themselves: the 4 levels the lookup
reads (`CorrBlock1D` also pools a fifth, which no lookup reads).

Tracing (`utils/profiling.mark`): `encode` (pad, normalise, both encoders,
the context convolutions), `corr` (the volume and its pyramid), per
iteration `lookup`, `coarse_gru` (gru32 and gru16 with their pooling and
interpolation) and `update` (motion encoder, gru08, flow head, coordinates),
then `upsample` (mask head, convex upsampling, unpad). The caller closes the
last stage (`models/engine.FlowEngine`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.geometry import coords_grid
from ..ops import corr as corr_ops
from ..ops.upsample import convex_upsample
from ..utils import profiling
from .raft import (BasicEncoder, BasicMotionEncoder, Conv, ConvGRU, FlowHead, ResidualBlock,
                   to_nchw, to_nhwc)
from .raft_flow import FlowOutputs, pad_frames, unpad
from .rnnpose import _exact_f32

__all__ = ["RAFTStereoConfig", "RAFTStereo", "MultiBasicEncoder", "BasicMultiUpdateBlock",
           "pool2x", "interp", "DIVISOR", "DOWNSAMPLE"]

DIVISOR = 32    # `InputPadder(divis_by=32)`: the 1/32 grid of three GRU levels below 1/4
DOWNSAMPLE = 2  # `n_downsample`: the finest GRU runs at 1/4


@dataclasses.dataclass(frozen=True)
class RAFTStereoConfig:
    """RAFT-Stereo's published model: three GRU levels of hidden and context
    128, 4 levels of radius 4 along the row, batch-norm context encoder."""

    hidden_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    mixed_precision: bool = False

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.mixed_precision else None


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """RAFT-Stereo's `pool2x`: 3x3 average pooling, stride 2, zero padding 1
    counted in the mean (NCHW)."""
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def interp(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """RAFT-Stereo's `interp`: x resized to dest's grid, bilinear with
    aligned corners (NCHW)."""
    return F.interpolate(x, dest.shape[2:], mode="bilinear", align_corners=True)


def _stage(planes: int, stride: int, dtype, norm: str) -> nn.Sequential:
    return nn.Sequential(ResidualBlock(128, planes, stride, dtype, norm),
                         ResidualBlock(planes, planes, 1, dtype, norm))


class MultiBasicEncoder(BasicEncoder):
    """RAFT-Stereo's context encoder: `BasicEncoder`'s trunk at 1/4
    (`downsample` 2), `layer4` and `layer5` (stride 2 each), and `heads`
    heads at each level: a residual block and a 3x3 convolution at 1/4
    (`outputs08`) and 1/8 (`outputs16`), a 3x3 convolution at 1/16
    (`outputs32`)."""

    def __init__(self, output_dim: int = 128, heads: int = 2, dtype=None, norm: str = "batch",
                 downsample: int = DOWNSAMPLE):
        nn.Module.__init__(self)
        self._trunk(dtype, norm, downsample)
        self.layer4 = _stage(128, 2, dtype, norm)
        self.layer5 = _stage(128, 2, dtype, norm)
        for name in ("outputs08", "outputs16"):
            setattr(self, name, nn.ModuleList(
                nn.Sequential(ResidualBlock(128, 128, 1, dtype, norm),
                              Conv(128, output_dim, 3, dtype=dtype))
                for _ in range(heads)))
        self.outputs32 = nn.ModuleList(Conv(128, output_dim, 3, dtype=dtype)
                                       for _ in range(heads))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        """(B, H, W, 3) -> per level, finest first, the heads' outputs (B,
        output_dim, H/s, W/s), NCHW, s = 4, 8, 16."""
        x = self.trunk(x)
        y = self.layer4(x)
        z = self.layer5(y)
        return [[f(t) for f in heads]
                for t, heads in ((x, self.outputs08), (y, self.outputs16), (z, self.outputs32))]


class BasicMultiUpdateBlock(nn.Module):
    """RAFT-Stereo's update block over three GRU levels (NCHW): `coarse`
    runs gru32 and gru16, `forward` the motion encoder, gru08 and the flow
    head, `upsample_mask` the mask head."""

    def __init__(self, corr_planes: int, hidden_dim: int = 128, dtype=None):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes, dtype, widths=(64, 64, 64, 64))
        self.gru08 = ConvGRU(hidden_dim, 128 + hidden_dim, dtype)
        self.gru16 = ConvGRU(hidden_dim, 2 * hidden_dim, dtype)
        self.gru32 = ConvGRU(hidden_dim, hidden_dim, dtype)
        self.flow_head = FlowHead(hidden_dim, 256, dtype)
        f = 2 ** DOWNSAMPLE
        self.mask = nn.Sequential(Conv(hidden_dim, 256, 3, dtype=dtype), nn.ReLU(),
                                  Conv(256, f * f * 9, 1, dtype=dtype))

    def coarse(self, net: Sequence[torch.Tensor], ctx) -> List[torch.Tensor]:
        """gru32, then gru16 from its new state: net and ctx finest first."""
        net32 = self.gru32(net[2], *ctx[2], pool2x(net[1]))
        net16 = self.gru16(net[1], *ctx[1], pool2x(net[0]), interp(net32, net[1]))
        return [net[0], net16, net32]

    def forward(self, net: Sequence[torch.Tensor], ctx, corr: torch.Tensor,
                flow: torch.Tensor) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(net with the new 1/4 state, delta (B, 2, h, w) f32 with y 0):
        corr (B, L(2r+1), h, w), flow (B, 2, h, w)."""
        motion = self.encoder(flow, corr)
        net08 = self.gru08(net[0], *ctx[0], motion, interp(net[1], net[0]))
        delta = self.flow_head(net08).to(torch.float32)
        delta[:, 1] = 0.0  # in stereo the flow stays on the epipolar line
        return [net08, net[1], net[2]], delta

    def upsample_mask(self, h: torch.Tensor) -> torch.Tensor:
        """NCHW 1/4 state -> (B, h, w, 9 * 16) f32 upsample logits."""
        return to_nhwc(0.25 * self.mask(h)).to(torch.float32)


class RAFTStereo(nn.Module):
    def __init__(self, cfg: RAFTStereoConfig = RAFTStereoConfig()):
        super().__init__()
        self.cfg = cfg
        dt, hd = cfg.compute_dtype, cfg.hidden_dim
        self.cnet = MultiBasicEncoder(hd, 2, dt)
        self.update_block = BasicMultiUpdateBlock(cfg.corr_levels * (2 * cfg.corr_radius + 1),
                                                  hd, dt)
        self.context_zqr_convs = nn.ModuleList(Conv(hd, 3 * hd, 3, dtype=dt) for _ in range(3))
        self.fnet = BasicEncoder(256, dt, norm="instance", downsample=DOWNSAMPLE)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 32
                ) -> FlowOutputs:
        """`iters` defaults to `evaluate_stereo.py`'s `valid_iters` 32."""
        cfg = self.cfg
        B, H, W, _ = image1.shape
        _exact_f32(image1)
        profiling.mark("encode")
        frames = 2.0 * (pad_frames(torch.cat([image1, image2], dim=0).float(), DIVISOR)
                        / 255.0) - 1.0
        fmap = self.fnet(frames)
        net, ctx = [], []
        for (h, i), conv in zip(self.cnet(frames[:B]), self.context_zqr_convs):
            net.append(torch.tanh(h))
            ctx.append([c.contiguous(memory_format=torch.channels_last)
                        for c in conv(F.relu(i)).split(cfg.hidden_dim, dim=1)])

        profiling.mark("corr")
        pyramid = corr_ops.build_corr_pyramid_1d(fmap[:B], fmap[B:], cfg.corr_levels)
        self.pyramid_nbytes = sum(level.nbytes for level in pyramid.levels)
        coords0 = coords_grid(fmap.shape[1], fmap.shape[2], device=image1.device)[None].expand(
            B, -1, -1, -1)
        coords1 = coords0
        history = []
        for _ in range(iters):
            profiling.mark("lookup")
            corr = corr_ops.corr_lookup_1d(pyramid, coords1, cfg.corr_radius)
            profiling.mark("coarse_gru")
            net = self.update_block.coarse(net, ctx)
            profiling.mark("update")
            net, delta = self.update_block(net, ctx, to_nchw(corr), to_nchw(coords1 - coords0))
            coords1 = coords1 + to_nhwc(delta)
            history.append((coords1 - coords0)[..., :1])

        profiling.mark("upsample")
        up = convex_upsample(history[-1], self.update_block.upsample_mask(net[0]),
                             factor=2 ** DOWNSAMPLE)
        return FlowOutputs(unpad(up, H, W, DIVISOR), torch.stack(history))
