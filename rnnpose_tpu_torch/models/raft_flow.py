"""RAFT, the optical-flow model (Teed & Deng, ECCV 2020;
github.com/princeton-vl/RAFT `core/raft.py`), on the port's RAFT blocks.

`RAFT(cfg)(image1, image2, iters=12)` takes a batch of frame pairs (B, H, W, 3)
in [0, 255] (any H and W) and returns `FlowOutputs`: the full-resolution
flow (B, H, W, 2) and the coarse flow after each iteration. The forward
pads the frames to a multiple of 8 as RAFT's `InputPadder` does in mode
'sintel' (replicated rows and columns split between both sides: 436 ->
440 rows), normalises them to 2 x / 255 - 1, runs `fnet` (instance norm)
on both frames in one pass, builds the all-pairs correlation pyramid
(`ops/corr`), runs `cnet` (batch norm) on the first frame for the GRU's
hidden state (tanh) and input (relu), then `iters` iterations of lookup,
update and `coords1 += delta` from a zero flow, and last the mask head, the
convex 8x upsampling (`ops/upsample.convex_upsample`) and the unpad. In
test mode RAFT computes the mask and the upsampled flow in every iteration
and returns the last; here they run once, after the last iteration, on
the same hidden state and coarse flow: the same numbers.

Submodules and their parameters and buffers carry RAFT's names (`fnet`,
`cnet`, `update_block`, with `update_block.mask`), so a RAFT `state_dict`
(`raft-sintel.pth`, its `module.` prefixes stripped) loads strictly.

Precision: with `mixed_precision` the convolutions compute in bf16 (RAFT's
own `--mixed_precision` is fp16 autocast); the correlation, the
coordinates, the norms' statistics and the upsampling are f32 always. On
the card the forward turns TF32 off for matmuls and cuDNN, as RNNPose's
does, so the correlation (and every convolution without `mixed_precision`)
is exact f32.

After a forward, `pyramid_nbytes` holds the bytes of the correlation
pyramid it built, read from the levels themselves.

Tracing (`utils/profiling.mark`): `encode` (pad, normalise, both
encoders), `corr` (the pyramid), per iteration `lookup` and `update`, then
`upsample` (mask head, convex upsampling, unpad). The caller closes the
last stage (`models/engine.FlowEngine`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import corr as corr_ops
from ..kernels.geometry import coords_grid
from ..ops.upsample import convex_upsample
from ..utils import profiling
from .raft import BasicEncoder, BasicUpdateBlock
from .rnnpose import _exact_f32

__all__ = ["RAFTConfig", "RAFT", "FlowOutputs", "sintel_pad", "pad_frames", "unpad"]


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """RAFT's full model: hidden and context 128, 4 levels of radius 4."""

    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    mixed_precision: bool = False

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.mixed_precision else None


class FlowOutputs(NamedTuple):
    """flow: (B, H, W, C) f32 at the frames' resolution; flow_history:
    (iters, B, Hp/s, Wp/s, C) f32, the coarse flow after each iteration on
    the padded frames' grid. RAFT: C = 2, s = 8; RAFT-Stereo
    (`models/raft_stereo.py`): C = 1 (x only), s = 4."""

    flow: torch.Tensor
    flow_history: torch.Tensor


def sintel_pad(h: int, w: int, divisor: int = 8) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) rows and columns that `InputPadder` in mode
    'sintel' adds to reach a multiple of `divisor` (RAFT's 8, RAFT-Stereo's
    `divis_by`), split between both sides."""
    ph, pw = (-h) % divisor, (-w) % divisor
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


def pad_frames(x: torch.Tensor, divisor: int = 8) -> torch.Tensor:
    """(B, H, W, C) -> padded by replicating edge rows and columns."""
    top, bottom, left, right = sintel_pad(x.shape[1], x.shape[2], divisor)
    if not (top or bottom or left or right):
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom), mode="replicate")
    return y.permute(0, 2, 3, 1)


def unpad(x: torch.Tensor, h: int, w: int, divisor: int = 8) -> torch.Tensor:
    """A padded (B, Hp, Wp, C) map back to the frames' (B, h, w, C)."""
    top, _, left, _ = sintel_pad(h, w, divisor)
    return x[:, top:top + h, left:left + w]


class RAFT(nn.Module):
    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.fnet = BasicEncoder(256, dt, norm="instance")
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, dt, norm="batch")
        self.update_block = BasicUpdateBlock(
            cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2, cfg.hidden_dim, cfg.context_dim,
            8, dt)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12
                ) -> FlowOutputs:
        """`iters` defaults to RAFT's 12; its Sintel evaluation runs 32."""
        cfg = self.cfg
        B, H, W, _ = image1.shape
        _exact_f32(image1)
        profiling.mark("encode")
        frames = 2.0 * (pad_frames(torch.cat([image1, image2], dim=0).float()) / 255.0) - 1.0
        fmap = self.fnet(frames)
        ctx = self.cnet(frames[:B])
        net = torch.tanh(ctx[..., :cfg.hidden_dim])
        inp = F.relu(ctx[..., cfg.hidden_dim:])

        profiling.mark("corr")
        pyramid = corr_ops.build_corr_pyramid(fmap[:B], fmap[B:], cfg.corr_levels)
        self.pyramid_nbytes = sum(level.nbytes for level in pyramid.levels)
        h8, w8 = fmap.shape[1], fmap.shape[2]
        coords0 = coords_grid(h8, w8, device=image1.device)[None].expand(B, -1, -1, -1)
        coords1 = coords0
        history = []
        for _ in range(iters):
            profiling.mark("lookup")
            corr = corr_ops.corr_lookup(pyramid, coords1, cfg.corr_radius)
            profiling.mark("update")
            net, delta = self.update_block(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
            history.append(coords1 - coords0)

        profiling.mark("upsample")
        up = convex_upsample(history[-1], self.update_block.upsample_mask(net), factor=8)
        return FlowOutputs(unpad(up, H, W), torch.stack(history))
