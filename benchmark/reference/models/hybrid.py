"""Hybrid 2D/3D descriptor nets (port of `rnnpose_tpu/models/hybrid.py`).

`HybridDescNet`: SuperPoint 2D descriptors of the image (`encode_2d`) and
the KPConv tower's 3D descriptors of the model cloud (`encode_3d`), in one
embedding space. `ContextFeatureNet`: a second KPConv tower for the 256-d
per-point context features. Submodules carry the reference's state-dict
names (`corr_fea_extractor_2d`, `corr_fea_extractor_3d`,
`context_fea_extractor_3d`). At eval the 3D outputs are per-class constants:
`models/engine.InferenceEngine` computes them once per class.
"""
from __future__ import annotations

import torch
from torch import nn

from .kpconv_net import KPConvConfig, KPFCNN, PointPyramid
from .superpoint import SuperPoint2D

__all__ = ["HybridDescNet", "ContextFeatureNet"]


class HybridDescNet(nn.Module):
    def __init__(self, descriptor_dim: int = 32,
                 kp_cfg: KPConvConfig = KPConvConfig(final_feats_dim=32),
                 mixed_precision: bool = True):
        super().__init__()
        self.corr_fea_extractor_2d = SuperPoint2D(
            descriptor_dim=descriptor_dim, mixed_precision=mixed_precision
        )
        self.corr_fea_extractor_3d = KPFCNN(kp_cfg)

    def encode_2d(self, image: torch.Tensor, tail_res: str = "full", *,
                  compute_scores: bool = False):
        """(B, H, W, 3) -> descriptors (B, H', W', D), or with
        `compute_scores` (saliency scores (B, H', W', 1), descriptors)."""
        return self.corr_fea_extractor_2d(image, tail_res=tail_res,
                                          compute_scores=compute_scores)

    def encode_3d(self, pyramid: PointPyramid) -> torch.Tensor:
        """Model-cloud pyramid -> (B, N, D) descriptors."""
        return self.corr_fea_extractor_3d(pyramid)


class ContextFeatureNet(nn.Module):
    """Per-point context features (the GRU's hidden state and input)."""

    def __init__(self, kp_cfg: KPConvConfig = KPConvConfig(
            final_feats_dim=256, normalize_output=False)):
        super().__init__()
        self.context_fea_extractor_3d = KPFCNN(kp_cfg)

    def forward(self, pyramid: PointPyramid) -> torch.Tensor:
        return self.context_fea_extractor_3d(pyramid)
