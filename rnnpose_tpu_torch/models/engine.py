"""Inference engine: per-class 3D feature caching (port of
`rnnpose_tpu/models/engine.py`).

The model stays free of per-class state; this object owns the cache. One
`RNNPose.encode_3d` per class name, then every batch of that class runs the
forward with the cached features. The cache is keyed by the class name
alone, as the JAX engine's is, and the cached features carry the batch
axis of the pyramid they were computed from: serve one batch size per
class name. `encode_3d_calls` counts the tower runs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .kpconv_net import PointPyramid
from .rnnpose import RNNPose, RNNPoseInputs

__all__ = ["InferenceEngine"]


class InferenceEngine:
    def __init__(self, model: RNNPose):
        self.model = model
        self._cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.encode_3d_calls = 0

    def class_features(self, class_name: str, pyramid: PointPyramid):
        """(desc3d, ctx3d) of a class, computed on first request."""
        if class_name not in self._cache:
            self._cache[class_name] = self.model.encode_3d(pyramid)
            self.encode_3d_calls += 1
        return self._cache[class_name]

    def refine(self, class_name: str, inputs: RNNPoseInputs) -> Dict[str, Any]:
        """Refine one batch of poses of `class_name`: the model's eval
        outputs (Ti_pred etc.)."""
        desc3d, ctx3d = self.class_features(class_name, inputs.pyramid)
        return self.model(inputs, train=False, cached_desc3d=desc3d, cached_ctx3d=ctx3d)

    def evict(self, class_name: Optional[str] = None):
        """Drop one class's features, or all of them."""
        if class_name is None:
            self._cache.clear()
        else:
            self._cache.pop(class_name, None)
