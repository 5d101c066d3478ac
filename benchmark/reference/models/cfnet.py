"""Correspondence-field (flow) network pieces (port of
`rnnpose_tpu/models/cfnet.py`): the image feature encoder, the context
split, the flow downsampling, and one GRU flow step at 1/8 resolution with
the optional convex upsampling to full resolution."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import corr as corr_ops
from ..ops.upsample import convex_upsample
from .raft import BasicEncoder, BasicUpdateBlock

__all__ = ["ImageFeaEncoder", "GRUFlowStep", "split_context", "downsample_flow",
           "resize_bilinear_ac"]


class ImageFeaEncoder(nn.Module):
    """Both crops through one RAFT encoder pass: (B, S, S, 3) x2 in [0, 1]
    -> two (B, S/8, S/8, 256) feature maps."""

    def __init__(self, output_dim: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fnet = BasicEncoder(output_dim, dtype)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        x = 2.0 * torch.cat([img1, img2], dim=0) - 1.0
        fmap = self.fnet(x)
        b = img1.shape[0]
        return fmap[:b], fmap[b:]


def resize_bilinear_ac(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) with align_corners=True (source of
    output i is i*(in-1)/(out-1)), as two tent-weight contractions in f32."""
    b, h, w, c = x.shape
    oh, ow = out_hw

    def weights(n_out, n_in):
        if n_out == 1:
            src = torch.zeros((1,), dtype=torch.float32, device=x.device)
        else:
            src = torch.arange(n_out, dtype=torch.float32, device=x.device) * (
                (n_in - 1) / (n_out - 1)
            )
        j = torch.arange(n_in, dtype=torch.float32, device=x.device)
        return torch.clamp(1.0 - torch.abs(src[:, None] - j), min=0.0).to(x.dtype)

    tmp = torch.einsum("iy,byxc->bixc", weights(oh, h), x)
    return torch.einsum("jx,bixc->bijc", weights(ow, w), tmp)


def downsample_flow(flow: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Full-res flow (B, H, W, 2) -> 1/factor resolution with the magnitude
    rescaled: divide by `factor`, then the align_corners=True bilinear
    resize (reference `CFNet.py:139-144`)."""
    b, h, w, c = flow.shape
    return resize_bilinear_ac(flow / factor, (h // factor, w // factor))


def split_context(
    cfea: torch.Tensor, hidden_dim: int = 128, context_dim: int = 128,
    dtype: Optional[torch.dtype] = None, out_hw=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rendered context features (B, h, w, C) -> initial GRU hidden (tanh)
    and input (relu) at 1/8 resolution, optionally cast to `dtype`."""
    b, h, w, c = cfea.shape
    if c < hidden_dim + context_dim:
        raise ValueError(f"context features too thin: {c}")
    if out_hw is None:
        out_hw = (h // 8, w // 8)
    lr = cfea if (h, w) == tuple(out_hw) else resize_bilinear_ac(cfea, out_hw)
    net = torch.tanh(lr[..., :hidden_dim])
    inp = F.relu(lr[..., hidden_dim:hidden_dim + context_dim])
    if dtype is not None:
        net, inp = net.to(dtype), inp.to(dtype)
    return net, inp


class GRUFlowStep(nn.Module):
    """One recurrent flow update at 1/8 resolution: corr lookup ->
    BasicUpdateBlock -> coords += delta. Returns (h, coords_lr, flow): with
    `emit_full_flow` the flow convex-upsampled 8x from the new hidden
    state's mask, else the coarse flow."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.corr_radius = corr_radius
        self.update_block = BasicUpdateBlock(
            corr_levels * (2 * corr_radius + 1) ** 2, dtype=dtype
        )

    def forward(self, h, inp, pyramid: corr_ops.CorrPyramid, coords_lr, grid_lr,
                emit_full_flow: bool = False):
        corr = corr_ops.corr_lookup(pyramid, coords_lr, self.corr_radius)
        h, delta = self.update_block(h, inp, corr, coords_lr - grid_lr)
        coords_lr = coords_lr + delta
        flow = coords_lr - grid_lr
        if emit_full_flow:
            flow = convex_upsample(flow, self.update_block.upsample_mask(h), factor=8)
        return h, coords_lr, flow
