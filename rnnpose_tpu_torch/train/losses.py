"""Training losses (port of `rnnpose_tpu/train/losses.py`).

* `circle_loss` / `match_recall`: the D3Feat-style circle loss over a
  fixed-size 2D-3D correspondence set, with a validity mask in place of the
  reference's boolean indexing (reference `losses.py:179-236`). Both take
  optional leading batch dimensions and return one value per sample.
* `point_alignment_loss`: mean |R_p X + t_p - (R_g X + t_g)| * 3 per sample,
  MEAN over the batch (reference `losses.py:307-340`; see the JAX module on
  why a mean).
* `sequence_flow_loss`: RAFT's gamma-weighted flow loss
  (`PoseRefiner.py:29-55`).
* `refiner_loss`: the per-iteration motion losses over the refinement
  history (`PoseRefiner.py:378-426`), all iterations at once over a
  flattened (iteration x batch) axis instead of the JAX package's vmap.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Optional

import torch
import torch.nn.functional as F

from ..geometry import lm as lm_lib

if TYPE_CHECKING:  # annotation only: models.rnnpose imports this module
    from ..models.refiner import RefinerOutputs

__all__ = [
    "CircleLossConfig",
    "circle_loss",
    "match_recall",
    "point_alignment_loss",
    "sequence_flow_loss",
    "RefinerLossConfig",
    "refiner_loss",
]

EPS = 1e-5         # depth epsilon, equal to models.refiner.EPS
MAX_ERROR = 100.0  # reproj clamp (reference `PoseRefiner.py:23`)
MAX_FLOW = 400.0   # flow-magnitude cutoff (reference `PoseRefiner.py:26`)
_BIG = 1e5


@dataclasses.dataclass(frozen=True)
class CircleLossConfig:
    """Mirrors `config/linemod/template_fw0.5.yml:95-103`."""

    pos_radius: float = 0.011      # pos_radius + 1e-3 numeric guard
    safe_radius: float = 0.02
    pos_margin: float = 0.1
    neg_margin: float = 1.4
    pos_optimal: float = 0.1
    neg_optimal: float = 1.4
    log_scale: float = 16.0
    max_points: int = 256
    weight: float = 0.001


def _pairwise_dist(a, b):
    """(..., P, C) x (..., Q, C) -> (..., P, Q) Euclidean distances."""
    d2 = (torch.sum(a * a, -1)[..., :, None] + torch.sum(b * b, -1)[..., None, :]
          - 2.0 * (a @ b.transpose(-1, -2)))
    return torch.sqrt(torch.clamp(d2, min=1e-12))


def _masked_mean(x, m):
    m = m.to(x.dtype)
    return torch.sum(x * m, -1) / torch.clamp(torch.sum(m, -1), min=1.0)


def circle_loss(
    src_pts: torch.Tensor,    # (..., P, 3) selected lifted points
    tgt_pts: torch.Tensor,    # (..., P, 3) selected model points
    src_feats: torch.Tensor,  # (..., P, C) 2D descriptors at those pixels
    tgt_feats: torch.Tensor,  # (..., P, C) 3D descriptors
    valid: torch.Tensor,      # (..., P) 1.0 for real correspondence rows
    cfg: CircleLossConfig = CircleLossConfig(),
) -> torch.Tensor:
    """Circle loss on correspondence pairs, one value per sample (reference
    `losses.py:179-220`). Padded rows and columns are deselected as
    anchors, and padded pairs leave the logsumexps (-inf), so the loss does
    not depend on the padding size. The pair weights are detached."""
    coords_dist = _pairwise_dist(src_pts, tgt_pts)
    feats_dist = _pairwise_dist(src_feats, tgt_feats)

    pair_valid = (valid[..., :, None] * valid[..., None, :]) > 0
    pos_mask = (coords_dist < cfg.pos_radius) & pair_valid
    neg_mask = (coords_dist > cfg.safe_radius) & pair_valid
    row_sel = (pos_mask.sum(-1) > 0) & (neg_mask.sum(-1) > 0)
    col_sel = (pos_mask.sum(-2) > 0) & (neg_mask.sum(-2) > 0)

    fd = feats_dist.detach()
    big = torch.full_like(fd, _BIG)
    pos_weight = torch.clamp(torch.where(pos_mask, fd, -big) - cfg.pos_optimal, min=0.0)
    neg_weight = torch.clamp(cfg.neg_optimal - torch.where(neg_mask, fd, big), min=0.0)

    logits_pos = cfg.log_scale * (feats_dist - cfg.pos_margin) * pos_weight
    logits_neg = cfg.log_scale * (cfg.neg_margin - feats_dist) * neg_weight
    # Real zero-weight pairs contribute exp(0) = 1, as in the reference;
    # padded pairs are excluded entirely.
    neg_inf = torch.full_like(logits_pos, float("-inf"))
    logits_pos = torch.where(pair_valid, logits_pos, neg_inf)
    logits_neg = torch.where(pair_valid, logits_neg, neg_inf)
    loss_row = F.softplus(torch.logsumexp(logits_pos, -1)
                          + torch.logsumexp(logits_neg, -1)) / cfg.log_scale
    loss_col = F.softplus(torch.logsumexp(logits_pos, -2)
                          + torch.logsumexp(logits_neg, -2)) / cfg.log_scale
    return (_masked_mean(loss_row, row_sel) + _masked_mean(loss_col, col_sel)) / 2.0


@torch.no_grad()
def match_recall(
    src_pts, tgt_pts, src_feats, tgt_feats, valid,
    cfg: CircleLossConfig = CircleLossConfig(),
) -> torch.Tensor:
    """Feature-match recall, one value per sample (reference
    `losses.py:223-236`)."""
    coords_dist = _pairwise_dist(src_pts, tgt_pts)
    feats_dist = _pairwise_dist(src_feats, tgt_feats)
    pair_valid = (valid[..., :, None] * valid[..., None, :]) > 0
    has_pos = ((coords_dist < cfg.pos_radius) & pair_valid).sum(-1) > 0
    feats_dist = torch.where(pair_valid, feats_dist, torch.full_like(feats_dist, _BIG))
    sel = torch.argmin(feats_dist, dim=-1, keepdim=True)
    sel_dist = torch.gather(coords_dist, -1, sel)[..., 0]
    hit = (sel_dist < cfg.pos_radius) & has_pos
    return hit.sum(-1).to(coords_dist.dtype) / torch.clamp(
        has_pos.sum(-1).to(coords_dist.dtype), min=1e-12)


def _alignment_error(R_pred, t_pred, R_tgt, t_tgt, points, point_valid=None):
    """mean |pred(X) - gt(X)| * 3 per sample: R (..., 3, 3), t (..., 3),
    points (..., N, 3), point_valid (..., N) -> (...)."""
    diff = (torch.einsum("...ij,...nj->...ni", R_pred, points) + t_pred[..., None, :]) - (
        torch.einsum("...ij,...nj->...ni", R_tgt, points) + t_tgt[..., None, :])
    a = torch.abs(diff)
    if point_valid is None:
        return torch.mean(a, dim=(-2, -1)) * 3.0
    m = point_valid[..., None]
    return torch.sum(a * m, dim=(-2, -1)) / torch.clamp(
        torch.sum(m, dim=(-2, -1)) * 3.0, min=1.0) * 3.0


def point_alignment_loss(
    R_pred, t_pred, R_tgt, t_tgt, points, point_valid=None
) -> torch.Tensor:
    """3D alignment: mean |pred(X) - gt(X)| * 3 per sample, MEAN over the
    batch. R (B, 3, 3), t (B, 3), points (B, N, 3), point_valid (B, N)."""
    return torch.mean(_alignment_error(R_pred, t_pred, R_tgt, t_tgt, points, point_valid))


def sequence_flow_loss(
    flow_preds: torch.Tensor,  # (T, B, H, W, 2)
    flow_gt: torch.Tensor,     # (B, H, W, 2)
    valid: torch.Tensor,       # (B, H, W)
    gamma: float = 0.8,
    max_flow: float = MAX_FLOW,
) -> torch.Tensor:
    """RAFT sequence loss (reference `PoseRefiner.py:29-55`): the mean L1
    flow error over valid pixels of each prediction, weighted by gamma to
    the power of its distance from the last."""
    mag = torch.linalg.norm(flow_gt, dim=-1)
    v = ((valid >= 0.5) & (mag < max_flow)).to(flow_gt.dtype)
    n = flow_preds.shape[0]
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=flow_gt.dtype,
                                    device=flow_gt.device)
    per = torch.mean(torch.abs(flow_preds - flow_gt[None]) * v[None, ..., None],
                     dim=(1, 2, 3, 4))
    return torch.sum(weights * per)


@dataclasses.dataclass(frozen=True)
class RefinerLossConfig:
    """Weights from `template_fw0.5.yml:78-81`."""

    flow_weight: float = 0.5       # TRAIN_FLOW_WEIGHT
    reproj_weight: float = 0.0     # TRAIN_REPROJ_WEIGHT
    pcalign_weight: float = 1.0    # TRAIN_PCALIGN_WEIGHT
    gamma: float = 0.8


def refiner_loss(
    outs: "RefinerOutputs",
    model_points: torch.Tensor,      # (B, N, 3) original (unnormalized) points
    point_valid: Optional[torch.Tensor] = None,
    cfg: RefinerLossConfig = RefinerLossConfig(),
    gru_iters: int = 4,
    legacy_tij_clobber: bool = True,
) -> Dict[str, torch.Tensor]:
    """Per-iteration motion losses over the refinement history (reference
    `compute_loss`, `PoseRefiner.py:378-426`): total_loss sums every
    iteration's weighted terms; flow_loss, reproj_loss and loss_3d_proj
    report the LAST iteration's, as the reference's logs do.

    `legacy_tij_clobber` reproduces the reference's aliasing quirk (see the
    JAX module): the last inner iteration's Tij of every non-final render
    iteration reads as the identity, so its pose terms carry no gradient.
    The history must hold the full-res flow (`emit_full_flow`).
    """
    Tij = outs.Tij_history
    T, B = Tij.shape[:2]
    if legacy_tij_clobber:
        i = torch.arange(T, device=Tij.device)
        clobbered = (i % gru_iters == gru_iters - 1) & (i < T - gru_iters)
        eye = torch.eye(4, dtype=Tij.dtype, device=Tij.device)
        Tij = torch.where(clobbered[:, None, None, None], eye, Tij)
    depth = outs.syn_depth_history.repeat_interleave(gru_iters, dim=0) + EPS  # (T, B, S, S)
    flat = lambda x: x.reshape((T * B,) + x.shape[2:])  # noqa: E731
    intr = flat(outs.intrinsics_history)
    flow_pred, vp = lm_lib.induced_flow(flat(Tij), flat(depth), intr)
    flow_star, vs = lm_lib.induced_flow(flat(outs.Tij_gt_history), flat(depth), intr)
    valid = vp * vs

    # One flow prediction per iteration: the sequence loss's gamma weight
    # is 1 (see `sequence_flow_loss` in the JAX module).
    mag = torch.linalg.norm(flow_star, dim=-1)
    v = ((valid >= 0.5) & (mag < MAX_FLOW)).to(flow_star.dtype)
    err = torch.abs(flat(outs.flow_history) - flow_star)
    l_flow = torch.mean((err * v[..., None]).reshape(T, -1), dim=1)
    l_reproj = torch.mean((valid[..., None] * torch.clamp(
        torch.abs(flow_pred - flow_star), 0.0, MAX_ERROR)).reshape(T, -1), dim=1)

    Ti = outs.Ti_history
    Tj_pred = Tij @ Ti
    Tj_gt = outs.Tij_gt_history @ Ti
    pts = model_points.expand(T, *model_points.shape)
    pv = None if point_valid is None else point_valid.expand(T, *point_valid.shape)
    l_3d = torch.mean(_alignment_error(Tj_pred[..., :3, :3], Tj_pred[..., :3, 3],
                                       Tj_gt[..., :3, :3], Tj_gt[..., :3, 3], pts, pv), dim=1)

    total = (cfg.pcalign_weight * torch.sum(l_3d) + cfg.flow_weight * torch.sum(l_flow)
             + cfg.reproj_weight * torch.sum(l_reproj))
    return {
        "total_loss": total,
        "flow_loss": l_flow[-1],
        "reproj_loss": l_reproj[-1],
        "loss_3d_proj": l_3d[-1],
    }
