"""RAFT-Stereo's forward in plain torch and float32: the benchmark's own copy,
which the program's RAFT-Stereo (`rnnpose_tpu_torch/models/raft_stereo.py`)
is held to.

Source: Lipson, Teed & Deng, "RAFT-Stereo: Multilevel Recurrent Field
Transforms for Stereo Matching", 3DV 2021; github.com/princeton-vl/RAFT-Stereo,
`core/raft_stereo.py` (`RAFTStereo`), `core/extractor.py` (`ResidualBlock`,
`BasicEncoder`, `MultiBasicEncoder`), `core/update.py` (`ConvGRU`,
`BasicMotionEncoder`, `BasicMultiUpdateBlock`, `pool2x`, `interp`),
`core/corr.py` (`CorrBlock1D`) and `core/utils/utils.py` (`InputPadder`
with `divis_by`, `bilinear_sampler`, `coords_grid`). The published default
model: `n_downsample 2`, `n_gru_layers 3`, `hidden_dims` 128 x 3, 4
correlation levels of radius 4, `context_norm batch` (eval mode: the running
statistics), `corr_implementation reg`, no `shared_backbone`, no
`slow_fast_gru`. Module, parameter and buffer names are RAFT-Stereo's, so a
RAFT-Stereo `state_dict` loads strictly. `FlowHead` and `exact_f32` are the
reference's RAFT ones (`raft_flow.py`), the same code.

Float32 throughout: no autocast (`--mixed_precision` off), and `exact_f32`
turns TF32 off for matmuls and cuDNN. Departures from the source, none of
which changes a number:

* frames come in as (B, H, W, 3) in [0, 255] and the x-flow goes out as
  (B, H, W, 1); the pad to a multiple of 32 (`InputPadder(divis_by=32)`,
  mode 'sintel') and the unpad run inside the forward, as
  `evaluate_stereo.py` runs them around it;
* in test mode RAFT-Stereo upsamples after the last iteration only; here
  the same, and the mask head runs once there, on the same hidden state
  (its mask of earlier iterations is never read);
* besides the full-resolution x-flow it returns the coarse x-flow after
  every iteration (`coords1 - coords0`, x), for the check;
* an iteration-forced mode (`forced`), for the check;
* no warm start (`flow_init`), no training mode (no `freeze_bn`, no
  dropout, no list of upsampled predictions), and only the published
  choices above: `evaluate_stereo.py` uses none of the others.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .raft_flow import FlowHead, exact_f32

__all__ = ["exact_f32", "ResidualBlock", "BasicEncoder", "MultiBasicEncoder", "ConvGRU",
           "BasicMotionEncoder", "BasicMultiUpdateBlock", "CorrBlock1D", "bilinear_sampler",
           "coords_grid", "InputPadder", "pool2x", "interp", "RAFTStereo"]


# ---- core/extractor.py ----------------------------------------------------


def _norm(norm_fn: str, planes: int) -> nn.Module:
    return {"batch": nn.BatchNorm2d, "instance": nn.InstanceNorm2d}[norm_fn](planes)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group", stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, kernel_size=3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, kernel_size=3, padding=1)
        self.relu = nn.ReLU()
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        if not (stride == 1 and in_planes == planes):
            self.norm3 = _norm(norm_fn, planes)
        if stride == 1 and in_planes == planes:
            self.downsample = None
        else:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, kernel_size=1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim: int = 128, norm_fn: str = "batch", downsample: int = 3):
        super().__init__()
        self.norm1 = _norm(norm_fn, 64)
        self.conv1 = nn.Conv2d(3, 64, kernel_size=7, stride=1 + (downsample > 2), padding=3)
        self.relu1 = nn.ReLU()
        self.in_planes = 64
        self.layer1 = self._make_layer(64, norm_fn, stride=1)
        self.layer2 = self._make_layer(96, norm_fn, stride=1 + (downsample > 1))
        self.layer3 = self._make_layer(128, norm_fn, stride=1 + (downsample > 0))
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


class MultiBasicEncoder(nn.Module):
    def __init__(self, output_dim=((128, 128, 128), (128, 128, 128)), norm_fn: str = "batch",
                 downsample: int = 3):
        super().__init__()
        self.norm1 = _norm(norm_fn, 64)
        self.conv1 = nn.Conv2d(3, 64, kernel_size=7, stride=1 + (downsample > 2), padding=3)
        self.relu1 = nn.ReLU()
        self.in_planes = 64
        self.layer1 = self._make_layer(64, norm_fn, stride=1)
        self.layer2 = self._make_layer(96, norm_fn, stride=1 + (downsample > 1))
        self.layer3 = self._make_layer(128, norm_fn, stride=1 + (downsample > 0))
        self.layer4 = self._make_layer(128, norm_fn, stride=2)
        self.layer5 = self._make_layer(128, norm_fn, stride=2)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, stride=1),
                          nn.Conv2d(128, dim[2], 3, padding=1)) for dim in output_dim)
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, stride=1),
                          nn.Conv2d(128, dim[1], 3, padding=1)) for dim in output_dim)
        self.outputs32 = nn.ModuleList(nn.Conv2d(128, dim[0], 3, padding=1)
                                       for dim in output_dim)

    _make_layer = BasicEncoder._make_layer

    def forward(self, x, num_layers: int = 3):
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        outputs08 = [f(x) for f in self.outputs08]
        y = self.layer4(x)
        outputs16 = [f(y) for f in self.outputs16]
        z = self.layer5(y)
        outputs32 = [f(z) for f in self.outputs32]
        return outputs08, outputs16, outputs32


# ---- core/update.py -------------------------------------------------------


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int, kernel_size: int = 3):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz = nn.Conv2d(c, hidden_dim, kernel_size, padding=kernel_size // 2)
        self.convr = nn.Conv2d(c, hidden_dim, kernel_size, padding=kernel_size // 2)
        self.convq = nn.Conv2d(c, hidden_dim, kernel_size, padding=kernel_size // 2)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1)
        self.convc1 = nn.Conv2d(cor_planes, 64, 1, padding=0)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 64, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))
        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


def pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def interp(x, dest):
    return F.interpolate(x, dest.shape[2:], mode="bilinear", align_corners=True)


class BasicMultiUpdateBlock(nn.Module):
    def __init__(self, corr_levels: int = 4, corr_radius: int = 4, hidden_dims=(128, 128, 128),
                 n_downsample: int = 2):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        encoder_output_dim = 128
        self.gru08 = ConvGRU(hidden_dims[2], encoder_output_dim + hidden_dims[1])
        self.gru16 = ConvGRU(hidden_dims[1], hidden_dims[0] + hidden_dims[2])
        self.gru32 = ConvGRU(hidden_dims[0], hidden_dims[1])
        self.flow_head = FlowHead(hidden_dims[2], hidden_dim=256)
        factor = 2 ** n_downsample
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dims[2], 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, (factor ** 2) * 9, 1, padding=0))

    def forward(self, net, inp, corr, flow):
        """(net, delta_flow): the source's block with n_gru_layers 3 and
        every level updated, without its mask, which the forward computes
        once, after the last iteration (`upsample_mask`)."""
        net[2] = self.gru32(net[2], *(inp[2]), pool2x(net[1]))
        net[1] = self.gru16(net[1], *(inp[1]), pool2x(net[0]), interp(net[2], net[1]))
        motion_features = self.encoder(flow, corr)
        net[0] = self.gru08(net[0], *(inp[0]), motion_features, interp(net[1], net[0]))
        return net, self.flow_head(net[0])

    def upsample_mask(self, net0):
        # scale mask to balance gradients
        return .25 * self.mask(net0)


# ---- core/corr.py and core/utils/utils.py ---------------------------------


def bilinear_sampler(img, coords):
    """Wrapper for grid_sample, uses pixel coordinates (RAFT-Stereo's: a
    1-high image keeps y as it is)."""
    H, W = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (W - 1) - 1
    if H > 1:
        ygrid = 2 * ygrid / (H - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


def coords_grid(batch: int, ht: int, wd: int, device):
    coords = torch.meshgrid(torch.arange(ht, device=device), torch.arange(wd, device=device),
                            indexing="ij")
    coords = torch.stack(coords[::-1], dim=0).float()
    return coords[None].repeat(batch, 1, 1, 1)


class CorrBlock1D:
    def __init__(self, fmap1, fmap2, num_levels: int = 4, radius: int = 4):
        self.num_levels = num_levels
        self.radius = radius
        self.corr_pyramid = []
        corr = CorrBlock1D.corr(fmap1, fmap2)
        batch, h1, w1, _, w2 = corr.shape
        corr = corr.reshape(batch * h1 * w1, 1, 1, w2)
        self.corr_pyramid.append(corr)
        for _ in range(self.num_levels):
            corr = F.avg_pool2d(corr, [1, 2], stride=[1, 2])
            self.corr_pyramid.append(corr)

    def __call__(self, coords):
        r = self.radius
        coords = coords[:, :1].permute(0, 2, 3, 1)
        batch, h1, w1, _ = coords.shape
        out_pyramid = []
        for i in range(self.num_levels):
            corr = self.corr_pyramid[i]
            dx = torch.linspace(-r, r, 2 * r + 1)
            dx = dx.view(2 * r + 1, 1).to(coords.device)
            x0 = dx + coords.reshape(batch * h1 * w1, 1, 1, 1) / 2 ** i
            y0 = torch.zeros_like(x0)
            coords_lvl = torch.cat([x0, y0], dim=-1)
            corr = bilinear_sampler(corr, coords_lvl)
            out_pyramid.append(corr.view(batch, h1, w1, -1))
        out = torch.cat(out_pyramid, dim=-1)
        return out.permute(0, 3, 1, 2).contiguous().float()

    @staticmethod
    def corr(fmap1, fmap2):
        B, D, H, W1 = fmap1.shape
        _, _, _, W2 = fmap2.shape
        fmap1 = fmap1.view(B, D, H, W1)
        fmap2 = fmap2.view(B, D, H, W2)
        corr = torch.einsum("aijk,aijh->ajkh", fmap1, fmap2)
        corr = corr.reshape(B, H, W1, 1, W2).contiguous()
        return corr / torch.sqrt(torch.tensor(D).float())


class InputPadder:
    """Pads images such that dimensions are divisible by `divis_by`."""

    def __init__(self, dims, mode: str = "sintel", divis_by: int = 8):
        self.ht, self.wd = dims[-2:]
        pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
        pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
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


# ---- core/raft_stereo.py --------------------------------------------------


class RAFTStereo(nn.Module):
    def __init__(self, hidden_dim: int = 128, corr_levels: int = 4, corr_radius: int = 4,
                 context_norm: str = "batch", n_downsample: int = 2):
        super().__init__()
        hidden_dims = context_dims = (hidden_dim,) * 3
        self.hidden_dims, self.n_downsample = hidden_dims, n_downsample
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.cnet = MultiBasicEncoder(output_dim=[hidden_dims, context_dims],
                                      norm_fn=context_norm, downsample=n_downsample)
        self.update_block = BasicMultiUpdateBlock(corr_levels, corr_radius, hidden_dims,
                                                  n_downsample)
        self.context_zqr_convs = nn.ModuleList(
            nn.Conv2d(context_dims[i], hidden_dims[i] * 3, 3, padding=3 // 2) for i in range(3))
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance", downsample=n_downsample)

    def initialize_flow(self, img):
        N, _, H, W = img.shape
        return coords_grid(N, H, W, img.device), coords_grid(N, H, W, img.device)

    def upsample_flow(self, flow, mask):
        """Upsample flow field [H/f, W/f, 2] -> [H, W, 2] using convex combination."""
        N, D, H, W = flow.shape
        factor = 2 ** self.n_downsample
        mask = mask.view(N, 1, 9, factor, factor, H, W)
        mask = torch.softmax(mask, dim=2)
        up_flow = F.unfold(factor * flow, [3, 3], padding=1)
        up_flow = up_flow.view(N, D, 9, 1, 1, H, W)
        up_flow = torch.sum(mask * up_flow, dim=2)
        up_flow = up_flow.permute(0, 1, 4, 2, 5, 3)
        return up_flow.reshape(N, D, factor * H, factor * W)

    def forward(self, image1, image2, iters: int = 32,
                forced: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Frames (B, H, W, 3) in [0, 255] -> {"flow": (B, H, W, 1) the
        x-flow at full resolution, "flow_history": (iters, B, H/4, W/4, 1)
        the coarse x-flow after each iteration, on the padded grid}.

        `forced`, a coarse x-flow history of another run (n, B, h, w, 1),
        makes iteration k > 0 start from that run's coordinates after
        iteration k - 1 (x = coords0 + `forced[k - 1]`, y = coords0's, for k
        <= n) instead of its own: each iteration's step is then taken from
        the other run's state, with this run's own hidden states, and the
        full-resolution flow is upsampled from the last such step."""
        padder = InputPadder(image1.permute(0, 3, 1, 2).shape, divis_by=32)
        image1, image2 = padder.pad(image1.permute(0, 3, 1, 2).float(),
                                    image2.permute(0, 3, 1, 2).float())
        image1 = (2 * (image1 / 255.0) - 1.0).contiguous()
        image2 = (2 * (image2 / 255.0) - 1.0).contiguous()

        cnet_list = self.cnet(image1, num_layers=3)
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2], dim=0)).split(
            [image1.shape[0]] * 2, dim=0)
        net_list = [torch.tanh(x[0]) for x in cnet_list]
        inp_list = [torch.relu(x[1]) for x in cnet_list]
        inp_list = [list(conv(i).split(split_size=conv.out_channels // 3, dim=1))
                    for i, conv in zip(inp_list, self.context_zqr_convs)]
        corr_fn = CorrBlock1D(fmap1.float(), fmap2.float(), radius=self.corr_radius,
                              num_levels=self.corr_levels)
        coords0, coords1 = self.initialize_flow(net_list[0])
        history = []
        for k in range(iters):
            if forced is not None and 0 < k <= forced.shape[0]:
                x = coords0[:, :1] + forced[k - 1].permute(0, 3, 1, 2)
                coords1 = torch.cat([x, coords0[:, 1:]], dim=1)
            coords1 = coords1.detach()
            corr = corr_fn(coords1)  # index correlation volume
            flow = coords1 - coords0
            net_list, delta_flow = self.update_block(net_list, inp_list, corr, flow)
            # in stereo mode, project flow onto epipolar
            delta_flow[:, 1] = 0.0
            coords1 = coords1 + delta_flow
            history.append((coords1 - coords0)[:, :1].permute(0, 2, 3, 1))
        flow_up = self.upsample_flow(coords1 - coords0,
                                     self.update_block.upsample_mask(net_list[0]))[:, :1]
        return {"flow": padder.unpad(flow_up).permute(0, 2, 3, 1),
                "flow_history": torch.stack(history)}
