"""RAFT's optical-flow forward in plain torch and float32: the benchmark's
own copy, which the program's RAFT (`rnnpose_tpu_torch/models/raft_flow.py`)
is held to.

Source: Teed & Deng, "RAFT: Recurrent All-Pairs Field Transforms for
Optical Flow", ECCV 2020; github.com/princeton-vl/RAFT, `core/raft.py`
(`RAFT`), `core/extractor.py` (`BasicEncoder`, `ResidualBlock`),
`core/update.py` (`BasicUpdateBlock` and its parts), `core/corr.py`
(`CorrBlock`) and `core/utils/utils.py` (`InputPadder`,
`bilinear_sampler`, `coords_grid`). The full model: hidden and context 128,
4 correlation levels of radius 4, `fnet` with instance norm and `cnet` with
batch norm (eval mode: the running statistics), each of output 256. Module,
parameter and buffer names are RAFT's, so a RAFT `state_dict` loads
strictly.

Float32 throughout: no autocast (`--mixed_precision` off, as
`evaluate.py` runs it), and `exact_f32` turns TF32 off for matmuls and
cuDNN. Departures from `core/raft.py`, none of which changes a number:

* frames come in as (B, H, W, 3) in [0, 255] and the flow goes out as
  (B, H, W, 2); the pad to a multiple of 8 (`InputPadder`, mode 'sintel':
  replicated rows and columns split between both sides) and the unpad
  run inside the forward, as `evaluate.validate_sintel` runs them around
  it;
* in test mode RAFT computes the upsampling mask and `flow_up` in every
  iteration and returns the last; here the mask head and the convex
  upsampling run once, after the last iteration, on the same hidden state
  and coarse flow: the same numbers;
* besides the full-resolution flow it returns the coarse flow after every
  iteration (`coords1 - coords0`), for the check;
* no warm start (`flow_init`), no dropout, no `alternate_corr` and no
  small model: the Sintel evaluation uses none of them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["exact_f32", "ResidualBlock", "BasicEncoder", "FlowHead", "SepConvGRU",
           "BasicMotionEncoder", "BasicUpdateBlock", "CorrBlock", "bilinear_sampler",
           "coords_grid", "InputPadder", "upsample_flow", "RAFT"]


def exact_f32() -> None:
    """TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- core/extractor.py ----------------------------------------------------


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "batch", stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, kernel_size=3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, kernel_size=3, padding=1)
        self.relu = nn.ReLU()
        norm = {"batch": nn.BatchNorm2d, "instance": nn.InstanceNorm2d}[norm_fn]
        self.norm1 = norm(planes)
        self.norm2 = norm(planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = norm(planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, kernel_size=1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim: int = 128, norm_fn: str = "batch"):
        super().__init__()
        self.norm1 = {"batch": nn.BatchNorm2d, "instance": nn.InstanceNorm2d}[norm_fn](64)
        self.conv1 = nn.Conv2d(3, 64, kernel_size=7, stride=2, padding=3)
        self.relu1 = nn.ReLU()
        self.in_planes = 64
        self.layer1 = self._make_layer(64, norm_fn, stride=1)
        self.layer2 = self._make_layer(96, norm_fn, stride=2)
        self.layer3 = self._make_layer(128, norm_fn, stride=2)
        self.conv2 = nn.Conv2d(128, output_dim, kernel_size=1)

    def _make_layer(self, dim, norm_fn, stride=1):
        layers = (ResidualBlock(self.in_planes, dim, norm_fn, stride=stride),
                  ResidualBlock(dim, dim, norm_fn, stride=1))
        self.in_planes = dim
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


# ---- core/update.py -------------------------------------------------------


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = nn.Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = nn.Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))

    def forward(self, h, x):
        # horizontal
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz1(hx))
        r = torch.sigmoid(self.convr1(hx))
        q = torch.tanh(self.convq1(torch.cat([r * h, x], dim=1)))
        h = (1 - z) * h + z * q
        # vertical
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz2(hx))
        r = torch.sigmoid(self.convr2(hx))
        q = torch.tanh(self.convq2(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1, padding=0)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))
        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4, hidden_dim: int = 128,
                 input_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim=hidden_dim, input_dim=input_dim + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 64 * 9, 1, padding=0))

    def forward(self, net, inp, corr, flow):
        """(net, delta_flow): RAFT's block without its mask, which the
        forward computes once, after the last iteration (`upsample_mask`)."""
        motion_features = self.encoder(flow, corr)
        inp = torch.cat([inp, motion_features], dim=1)
        net = self.gru(net, inp)
        return net, self.flow_head(net)

    def upsample_mask(self, net):
        # scale mask to balance gradients
        return .25 * self.mask(net)


# ---- core/corr.py and core/utils/utils.py ---------------------------------


def bilinear_sampler(img, coords):
    """Wrapper for grid_sample, uses pixel coordinates."""
    H, W = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (W - 1) - 1
    ygrid = 2 * ygrid / (H - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


def coords_grid(batch: int, ht: int, wd: int, device):
    coords = torch.meshgrid(torch.arange(ht, device=device), torch.arange(wd, device=device),
                            indexing="ij")
    coords = torch.stack(coords[::-1], dim=0).float()
    return coords[None].repeat(batch, 1, 1, 1)


class CorrBlock:
    def __init__(self, fmap1, fmap2, num_levels: int = 4, radius: int = 4):
        self.num_levels = num_levels
        self.radius = radius
        self.corr_pyramid: List[torch.Tensor] = []
        corr = CorrBlock.corr(fmap1, fmap2)
        batch, h1, w1, dim, h2, w2 = corr.shape
        corr = corr.reshape(batch * h1 * w1, dim, h2, w2)
        self.corr_pyramid.append(corr)
        for _ in range(self.num_levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            self.corr_pyramid.append(corr)

    def __call__(self, coords):
        r = self.radius
        coords = coords.permute(0, 2, 3, 1)
        batch, h1, w1, _ = coords.shape
        out_pyramid = []
        for i in range(self.num_levels):
            corr = self.corr_pyramid[i]
            dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), dim=-1)
            centroid_lvl = coords.reshape(batch * h1 * w1, 1, 1, 2) / 2 ** i
            delta_lvl = delta.view(1, 2 * r + 1, 2 * r + 1, 2)
            coords_lvl = centroid_lvl + delta_lvl
            corr = bilinear_sampler(corr, coords_lvl)
            out_pyramid.append(corr.view(batch, h1, w1, -1))
        out = torch.cat(out_pyramid, dim=-1)
        return out.permute(0, 3, 1, 2).contiguous().float()

    @staticmethod
    def corr(fmap1, fmap2):
        batch, dim, ht, wd = fmap1.shape
        fmap1 = fmap1.view(batch, dim, ht * wd)
        fmap2 = fmap2.view(batch, dim, ht * wd)
        corr = torch.matmul(fmap1.transpose(1, 2), fmap2)
        corr = corr.view(batch, ht, wd, 1, ht, wd)
        return corr / torch.sqrt(torch.tensor(dim).float())


class InputPadder:
    """Pads images such that dimensions are divisible by 8."""

    def __init__(self, dims, mode: str = "sintel"):
        self.ht, self.wd = dims[-2:]
        pad_ht = (((self.ht // 8) + 1) * 8 - self.ht) % 8
        pad_wd = (((self.wd // 8) + 1) * 8 - self.wd) % 8
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs):
        return [F.pad(x, self._pad, mode="replicate") for x in inputs]

    def unpad(self, x):
        ht, wd = x.shape[-2:]
        c = [self._pad[2], ht - self._pad[3], self._pad[0], wd - self._pad[1]]
        return x[..., c[0]:c[1], c[2]:c[3]]


def upsample_flow(flow, mask):
    """Upsample flow field [H/8, W/8, 2] -> [H, W, 2] using convex combination."""
    N, _, H, W = flow.shape
    mask = mask.view(N, 1, 9, 8, 8, H, W)
    mask = torch.softmax(mask, dim=2)
    up_flow = F.unfold(8 * flow, [3, 3], padding=1)
    up_flow = up_flow.view(N, 2, 9, 1, 1, H, W)
    up_flow = torch.sum(mask * up_flow, dim=2)
    up_flow = up_flow.permute(0, 1, 4, 2, 5, 3)
    return up_flow.reshape(N, 2, 8 * H, 8 * W)


# ---- core/raft.py ---------------------------------------------------------


class RAFT(nn.Module):
    def __init__(self, hidden_dim: int = 128, context_dim: int = 128, corr_levels: int = 4,
                 corr_radius: int = 4):
        super().__init__()
        self.hidden_dim, self.context_dim = hidden_dim, context_dim
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=hidden_dim + context_dim, norm_fn="batch")
        self.update_block = BasicUpdateBlock(corr_levels, corr_radius, hidden_dim=hidden_dim,
                                             input_dim=context_dim)

    def initialize_flow(self, img):
        N, C, H, W = img.shape
        coords0 = coords_grid(N, H // 8, W // 8, device=img.device)
        coords1 = coords_grid(N, H // 8, W // 8, device=img.device)
        return coords0, coords1

    def encode(self, image1, image2) -> Tuple[CorrBlock, torch.Tensor, torch.Tensor]:
        """NCHW frames in [-1, 1], padded -> (the correlation pyramid, the
        GRU's initial hidden state, its context input)."""
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2], dim=0)).split(
            [image1.shape[0]] * 2, dim=0)
        corr_fn = CorrBlock(fmap1.float(), fmap2.float(), num_levels=self.corr_levels,
                            radius=self.corr_radius)
        net, inp = torch.split(self.cnet(image1), [self.hidden_dim, self.context_dim], dim=1)
        return corr_fn, torch.tanh(net), torch.relu(inp)

    def forward(self, image1, image2, iters: int = 12,
                forced: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Frames (B, H, W, 3) in [0, 255] -> {"flow": (B, H, W, 2) at full
        resolution, "flow_history": (iters, B, H8, W8, 2) the coarse flow
        after each iteration, on the padded grid}.

        `forced`, a coarse flow history of another run (n, B, H8, W8, 2),
        makes iteration k > 0 start from that run's coordinates after
        iteration k - 1 (`forced[k - 1]`, for k <= n) instead of its own:
        each iteration's step is then taken from the other run's state,
        with this run's own hidden state, and the full-resolution flow is
        upsampled from the last such step."""
        padder = InputPadder(image1.permute(0, 3, 1, 2).shape)
        image1, image2 = padder.pad(image1.permute(0, 3, 1, 2).float(),
                                    image2.permute(0, 3, 1, 2).float())
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        corr_fn, net, inp = self.encode(image1.contiguous(), image2.contiguous())
        coords0, coords1 = self.initialize_flow(image1)
        history = []
        for k in range(iters):
            if forced is not None and 0 < k <= forced.shape[0]:
                coords1 = coords0 + forced[k - 1].permute(0, 3, 1, 2)
            coords1 = coords1.detach()
            corr = corr_fn(coords1)  # index correlation volume
            flow = coords1 - coords0
            net, delta_flow = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta_flow
            history.append((coords1 - coords0).permute(0, 2, 3, 1))
        flow_up = upsample_flow(coords1 - coords0, self.update_block.upsample_mask(net))
        return {"flow": padder.unpad(flow_up).permute(0, 2, 3, 1),
                "flow_history": torch.stack(history)}
