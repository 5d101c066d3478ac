"""ICP pose refinement against the depth-lifted scene cloud (port of
`rnnpose_tpu/eval/icp.py`).

The reference carries a dormant Open3D ICP hook in its evaluator; this is a
fixed-iteration trimmed point-to-point ICP, batched over B:

* correspondences: pairwise squared distances (`ops/knn.pairwise_sqdist`)
  and a row argmin;
* pose update: weighted Kabsch (SVD of the 3x3 cross-covariance in f32,
  with the reflection corrected);
* a model point farther than `max_corr_dist` from its match gets weight 0
  this iteration (trimming); padded points are masked by their validity.

An iteration with fewer than 3 weighted correspondences keeps the pose.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..geometry.precise import peinsum, pmatmul
from ..ops.knn import pairwise_sqdist

__all__ = ["icp_refine"]


def _kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted rigid alignment src -> dst: (B, N, 3), (B, N, 3), (B, N) ->
    (B, 4, 4)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-6)[:, None]
    cs = torch.sum(src * w[..., None], dim=1) / wsum
    cd = torch.sum(dst * w[..., None], dim=1) / wsum
    s = src - cs[:, None]
    d = dst - cd[:, None]
    H = peinsum("bni,bnj->bij", s * w[..., None], d)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(wsum[:, 0]), torch.ones_like(wsum[:, 0]),
         torch.linalg.det(pmatmul(V, Ut))], dim=-1))
    R = pmatmul(V, pmatmul(D, Ut))
    t = cd - peinsum("bij,bj->bi", R, cs)
    T = torch.eye(4, dtype=src.dtype, device=src.device).repeat(src.shape[0], 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    return T


def icp_refine(
    T_init: torch.Tensor,
    model_points: torch.Tensor,
    scene_points: torch.Tensor,
    model_valid: Optional[torch.Tensor] = None,
    scene_valid: Optional[torch.Tensor] = None,
    num_iters: int = 10,
    max_corr_dist: float = 0.02,
) -> torch.Tensor:
    """Refine poses by point-to-point ICP (model -> scene, camera frame).

    Args:
      T_init: (B, 4, 4) initial model->camera poses.
      model_points: (B, N, 3) object-frame model points (padded ok).
      scene_points: (B, M, 3) camera-frame scene points (depth-lifted).
      model_valid / scene_valid: optional (B, N) / (B, M) masks.
      num_iters: ICP iterations.
      max_corr_dist: the trimming gate, in model units.
    Returns:
      (B, 4, 4) refined poses.
    """
    B, N, _ = model_points.shape
    mv = (torch.ones((B, N), dtype=model_points.dtype, device=model_points.device)
          if model_valid is None else model_valid.to(model_points.dtype))
    sv = (torch.ones(scene_points.shape[:2], dtype=scene_points.dtype,
                     device=scene_points.device)
          if scene_valid is None else scene_valid.to(scene_points.dtype))
    eye = torch.eye(4, dtype=T_init.dtype, device=T_init.device)
    T = T_init
    for _ in range(num_iters):
        x = peinsum("bij,bnj->bni", T[:, :3, :3], model_points) + T[:, None, :3, 3]
        d2 = pairwise_sqdist(x, scene_points)                       # (B, N, M)
        d2 = torch.where(sv[:, None, :] > 0, d2, torch.full_like(d2, 1e9))
        nn = torch.argmin(d2, dim=-1)                                # (B, N)
        dmin = torch.sqrt(torch.gather(d2, 2, nn[..., None])[..., 0])
        y = torch.gather(scene_points, 1, nn[..., None].expand(B, N, 3))
        w = mv * (dmin < max_corr_dist).to(mv.dtype)
        enough = (torch.sum(w, dim=-1) >= 3.0)[:, None, None]
        dT = torch.where(enough, _kabsch(x, y, w), eye)
        T = pmatmul(dT, T)
    return T
