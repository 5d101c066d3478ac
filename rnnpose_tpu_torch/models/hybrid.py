"""Hybrid 2D/3D descriptor net (port of `rnnpose_tpu/models/hybrid.py`).

Only the 2D half is ported: at eval the per-class 3D descriptors are
computed once and cached, so the forward takes them as inputs. The KPConv
3D tower (`encode_3d`) is ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

import torch
from torch import nn

from .superpoint import SuperPoint2D

__all__ = ["HybridDescNet"]


class HybridDescNet(nn.Module):
    def __init__(self, descriptor_dim: int = 32, mixed_precision: bool = True):
        super().__init__()
        self.corr_fea_extractor_2d = SuperPoint2D(
            descriptor_dim=descriptor_dim, mixed_precision=mixed_precision
        )

    def encode_2d(self, image: torch.Tensor, tail_res: str = "full") -> torch.Tensor:
        """(B, H, W, 3) -> descriptors (B, H', W', D); the saliency scores
        come with the training path."""
        return self.corr_fea_extractor_2d(image, tail_res=tail_res)

    def encode_3d(self, pyramid):
        raise NotImplementedError(
            "the KPConv 3D descriptor tower is not ported yet (ROADMAP "
            "Queue 1 item 5); pass cached 3D descriptors to the forward"
        )
