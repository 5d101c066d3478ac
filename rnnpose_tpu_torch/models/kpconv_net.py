"""KPConv encoder-decoder 3D descriptor tower (port of
`rnnpose_tpu/models/kpconv_net.py`).

The reference's `KPSuperpoint3Dv2` (num_layers=4): simple, resnetb, then
(resnetb_strided, resnetb, resnetb) per further layer; a 1x1 bottleneck and
projection; (nearest upsample, unary) per decoder level with skip concats,
and `last_unary` to final_feats_dim + 2 channels, sliced, optionally L2
normalised, masked. The ragged stacked clouds of the reference are padded
static pyramids with validity masks (`PointPyramid`), the batch a leading
axis. Module and parameter names follow the reference's state-dict keys
(`encoder_blocks.i`, `decoder_blocks.i`, `bottle`, `proj_gnn`, `KPConv`,
`unary1`/`unary2`/`unary_shortcut`, `mlp`), so `models/convert.py` maps the
JAX package's parameter tree onto them one to one.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kpconv_ops
from ..ops.kernel_points import make_kernel_points

__all__ = ["KPConvConfig", "PointPyramid", "masked_instance_norm", "UnaryBlock",
           "KPConvLayer", "SimpleBlock", "ResnetBottleneckBlock", "KPFCNN"]


@dataclasses.dataclass(frozen=True)
class KPConvConfig:
    """The JAX package's `KPConvConfig` fields and defaults."""

    num_layers: int = 4
    first_subsampling_dl: float = 0.025
    conv_radius: float = 2.5
    kp_extent: float = 2.0          # relative; absolute = r * kp_extent / conv_radius
    num_kernel_points: int = 15
    in_features_dim: int = 1
    first_feats_dim: int = 128
    final_feats_dim: int = 32
    gnn_feats_dim: int = 128
    influence: str = "linear"
    aggregation: str = "sum"
    normalize_output: bool = True

    def layer_radius(self, layer: int) -> float:
        return self.first_subsampling_dl * self.conv_radius * (2.0 ** layer)


class PointPyramid:
    """Padded multi-resolution point pyramid. Per level l (0 = finest):
      points[l] (B, N_l, 3) f32; masks[l] (B, N_l) 1.0 for real points;
      neighbors[l] (B, N_l, K_l) int64 indices into level l (shadow = N_l);
      pools[l] (B, N_{l+1}, K_l) into level l; upsamples[l] (B, N_l, K') into
      level l+1.
    """

    def __init__(self, points, masks, neighbors, pools, upsamples):
        self.points = list(points)
        self.masks = list(masks)
        self.neighbors = list(neighbors)
        self.pools = list(pools)
        self.upsamples = list(upsamples)

    @property
    def num_levels(self) -> int:
        return len(self.points)

    def to(self, device) -> "PointPyramid":
        return PointPyramid(*([t.to(device) for t in ts] for ts in (
            self.points, self.masks, self.neighbors, self.pools, self.upsamples)))


def masked_instance_norm(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-cloud, per-channel normalisation of x (B, N, C) over the valid
    points of mask (B, N); padded rows come out zero."""
    m = mask[..., None]
    count = torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
    mean = torch.sum(x * m, dim=1, keepdim=True) / count
    var = torch.sum(torch.square(x - mean) * m, dim=1, keepdim=True) / count
    return (x - mean) * torch.rsqrt(var + eps) * m


class UnaryBlock(nn.Module):
    """Linear (no bias) + masked instance norm + leaky relu (0.1)."""

    def __init__(self, in_dim: int, out_dim: int, no_relu: bool = False):
        super().__init__()
        self.mlp = nn.Linear(in_dim, out_dim, bias=False)
        self.no_relu = no_relu

    def forward(self, x, mask):
        x = masked_instance_norm(self.mlp(x), mask)
        return x if self.no_relu else F.leaky_relu(x, 0.1)


class KPConvLayer(nn.Module):
    """One rigid KPConv: `weights` (P, C_in, C_out) and the fixed
    `kernel_points` (P, 3) of radius `radius` (a buffer: it is in the state
    dict, as in the reference, but never trained)."""

    def __init__(self, in_dim: int, out_dim: int, radius: float, extent: float,
                 num_kernel_points: int = 15, influence: str = "linear",
                 aggregation: str = "sum"):
        super().__init__()
        self.extent = extent
        self.influence = influence
        self.aggregation = aggregation
        self.weights = nn.Parameter(torch.empty(num_kernel_points, in_dim, out_dim))
        nn.init.normal_(self.weights, std=(num_kernel_points * in_dim) ** -0.5)
        self.register_buffer("kernel_points", torch.from_numpy(
            make_kernel_points(num_kernel_points, radius)))

    def forward(self, q_pts, s_pts, neighb_inds, x):
        return kpconv_ops.kpconv(q_pts, s_pts, neighb_inds, x, self.kernel_points,
                                 self.weights, self.extent, self.influence,
                                 self.aggregation)


def _kpconv_layer(in_dim, out_dim, radius, extent, cfg: KPConvConfig) -> KPConvLayer:
    return KPConvLayer(in_dim, out_dim, radius, extent, cfg.num_kernel_points,
                       cfg.influence, cfg.aggregation)


class SimpleBlock(nn.Module):
    """KPConv to out_dim // 2 + norm + leaky relu."""

    def __init__(self, in_dim, out_dim, radius, extent, cfg: KPConvConfig):
        super().__init__()
        self.KPConv = _kpconv_layer(in_dim, out_dim // 2, radius, extent, cfg)

    def forward(self, q_pts, s_pts, neighb_inds, x, mask_q):
        x = self.KPConv(q_pts, s_pts, neighb_inds, x)
        return F.leaky_relu(masked_instance_norm(x, mask_q), 0.1)


class ResnetBottleneckBlock(nn.Module):
    """unary(out // 4) -> KPConv(out // 4) -> unary(out) + shortcut. The
    strided form max-pools the shortcut over the pool neighbourhood.
    `unary1` exists only when in_dim != out // 4 and `unary_shortcut` only
    when in_dim != out, as in the reference."""

    def __init__(self, in_dim, out_dim, radius, extent, cfg: KPConvConfig,
                 strided: bool = False):
        super().__init__()
        self.strided = strided
        q = out_dim // 4
        self.unary1 = UnaryBlock(in_dim, q) if in_dim != q else None
        self.KPConv = _kpconv_layer(q, q, radius, extent, cfg)
        self.unary2 = UnaryBlock(q, out_dim, no_relu=True)
        self.unary_shortcut = (UnaryBlock(in_dim, out_dim, no_relu=True)
                               if in_dim != out_dim else None)

    def forward(self, q_pts, s_pts, neighb_inds, x, mask_q, mask_s=None):
        if mask_s is None:
            mask_s = mask_q  # non-strided: support level == query level
        y = self.unary1(x, mask_s) if self.unary1 is not None else x
        y = self.KPConv(q_pts, s_pts, neighb_inds, y)
        y = F.leaky_relu(masked_instance_norm(y, mask_q), 0.1)
        y = self.unary2(y, mask_q)
        shortcut = kpconv_ops.max_pool(x, neighb_inds) if self.strided else x
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, mask_q)
        return F.leaky_relu(y + shortcut, 0.1)


class NearestUpsample(nn.Module):
    """The decoder's parameter-free upsampling: each finer point takes its
    nearest coarser point's features."""

    def forward(self, x, upsample_inds):
        return kpconv_ops.closest_pool(x, upsample_inds)


class LastUnary(nn.Module):
    """The bare bias-free linear at the end of the decoder."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.mlp = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, x):
        return self.mlp(x)


class KPFCNN(nn.Module):
    """The encoder-decoder: a PointPyramid -> (B, N_0, final_feats_dim)
    features, zero on padded points."""

    def __init__(self, cfg: KPConvConfig = KPConvConfig()):
        super().__init__()
        self.cfg = cfg

        def rad(l):
            return cfg.layer_radius(l)

        def ext(l):
            return rad(l) * cfg.kp_extent / cfg.conv_radius

        out_dim = cfg.first_feats_dim
        blocks = [SimpleBlock(cfg.in_features_dim, out_dim, rad(0), ext(0), cfg),
                  ResnetBottleneckBlock(out_dim // 2, out_dim, rad(0), ext(0), cfg)]
        skip_dims: List[int] = []
        for layer in range(1, cfg.num_layers):
            skip_dims.append(out_dim)
            # The strided block keeps the width; the next one doubles it.
            blocks.append(ResnetBottleneckBlock(out_dim, out_dim, rad(layer - 1),
                                                ext(layer - 1), cfg, strided=True))
            blocks.append(ResnetBottleneckBlock(out_dim, 2 * out_dim, rad(layer),
                                                ext(layer), cfg))
            out_dim *= 2
            blocks.append(ResnetBottleneckBlock(out_dim, out_dim, rad(layer),
                                                ext(layer), cfg))
        self.encoder_blocks = nn.ModuleList(blocks)
        self.bottle = nn.Conv1d(out_dim, cfg.gnn_feats_dim, 1)
        self.proj_gnn = nn.Conv1d(cfg.gnn_feats_dim, cfg.gnn_feats_dim, 1)

        dec: List[nn.Module] = []
        cur = out_dim = cfg.gnn_feats_dim
        for i in range(cfg.num_layers - 1):
            out_dim //= 2
            in_dim = cur + skip_dims[cfg.num_layers - 2 - i]
            dec.append(NearestUpsample())
            if i < cfg.num_layers - 2:
                dec.append(UnaryBlock(in_dim, out_dim))
                cur = out_dim
            else:
                dec.append(LastUnary(in_dim, cfg.final_feats_dim + 2))
        self.decoder_blocks = nn.ModuleList(dec)

    @staticmethod
    def _pointwise(conv: nn.Conv1d, x):
        return F.linear(x, conv.weight[..., 0], conv.bias)

    def forward(self, pyr: PointPyramid, features: Optional[torch.Tensor] = None):
        cfg = self.cfg
        B, N0 = pyr.points[0].shape[:2]
        if features is None:
            features = torch.ones((B, N0, cfg.in_features_dim),
                                  dtype=pyr.points[0].dtype, device=pyr.points[0].device)
        enc = iter(self.encoder_blocks)
        p0, nb0, m0 = pyr.points[0], pyr.neighbors[0], pyr.masks[0]
        x = next(enc)(p0, p0, nb0, features, m0)
        x = next(enc)(p0, p0, nb0, x, m0)
        skips: List[torch.Tensor] = []
        for layer in range(1, cfg.num_layers):
            skips.append(x)
            pts, nb, m = pyr.points[layer], pyr.neighbors[layer], pyr.masks[layer]
            x = next(enc)(pts, pyr.points[layer - 1], pyr.pools[layer - 1], x, m,
                          pyr.masks[layer - 1])
            x = next(enc)(pts, pts, nb, x, m)
            x = next(enc)(pts, pts, nb, x, m)

        x = self._pointwise(self.proj_gnn, self._pointwise(self.bottle, x))

        dec = iter(self.decoder_blocks)
        for i in range(cfg.num_layers - 1):
            layer = cfg.num_layers - 1 - i  # coarse -> fine
            x = next(dec)(x, pyr.upsamples[layer - 1])
            x = torch.cat([x, skips.pop()], dim=-1)
            block = next(dec)
            x = block(x, pyr.masks[layer - 1]) if isinstance(block, UnaryBlock) else block(x)

        feats = x[..., : cfg.final_feats_dim]
        if cfg.normalize_output:
            # Clamping the squared norm keeps padded (zero) rows finite.
            sq = torch.sum(torch.square(feats), dim=-1, keepdim=True)
            feats = feats * torch.rsqrt(torch.clamp(sq, min=1e-16))
        return feats * pyr.masks[0][..., None]
