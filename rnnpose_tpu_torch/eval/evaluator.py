"""Per-class pose evaluators, LINEMOD and YCB protocols (port of
`rnnpose_tpu/eval/evaluator.py`). `weighted_reduce_metrics`, the
seq_len-weighted reduction of their summaries across processes, lives in
`parallel/collectives.py` and is re-exported here.

A `PoseEvaluator` accumulates, per frame, ADD(-S) under 0.1 / 0.05 / 0.02
of the diameter, Proj2D under 5 px (in the pixels of the camera the caller
passes: the original camera, not the crop's), 5cm5deg, and the raw errors;
`summarize()` gives the means and the sequence length. Symmetric classes
(eggbox, glue) use ADD-S. The metrics run in torch on `device`; the records
are host-side Python, as the reference's are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel.collectives import weighted_reduce_metrics  # noqa: F401  (re-export)
from . import metrics as M

__all__ = ["SYMMETRIC_CLASSES", "PoseEvaluator", "YCBEvaluator", "weighted_reduce_metrics"]

SYMMETRIC_CLASSES = ("eggbox", "glue")


@dataclasses.dataclass
class PoseEvaluator:
    """Accumulates pose metrics for ONE object class.

    Args:
      class_name: object class (selects ADD vs ADD-S).
      diameter: object diameter in the model unit.
      model_points: (N, 3) model points of the ADD computation.
      point_valid: optional (N,) validity mask of padded points.
      icp_refine: refine each pose by ICP (`eval/icp.py`) against the
        depth-lifted scene cloud before the metrics; `evaluate` then needs
        `scene_points`.
      device: where the metrics run.
    """

    class_name: str
    diameter: float
    model_points: np.ndarray
    point_valid: Optional[np.ndarray] = None
    icp_refine: bool = False
    icp_iters: int = 10
    icp_max_corr_dist: float = 0.02
    symmetric_override: Optional[bool] = None  # None -> by the class table
    device: str = "cpu"

    def __post_init__(self):
        self.symmetric = (self.symmetric_override if self.symmetric_override is not None
                          else self.class_name in SYMMETRIC_CLASSES)
        self._records: List[Dict[str, float]] = []

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def evaluate(
        self,
        T_pred: np.ndarray,
        T_gt: np.ndarray,
        K: np.ndarray,
        scene_points: Optional[np.ndarray] = None,
        scene_valid: Optional[np.ndarray] = None,
    ):
        """Accumulate one (batched) prediction. T_*: (B, 4, 4), K: (B, 4).
        scene_points: (B, M, 3) camera-frame depth-lifted points, read only
        with `icp_refine`."""
        B = len(T_pred)
        pts = self._t(self.model_points)[None].expand(B, -1, -1)
        vv = None if self.point_valid is None else self._t(self.point_valid)[None].expand(B, -1)
        Tp, Tg = self._t(T_pred), self._t(T_gt)
        if self.icp_refine:
            if scene_points is None:
                raise ValueError("icp_refine=True needs scene_points")
            from .icp import icp_refine

            Tp = icp_refine(Tp, pts, self._t(scene_points), model_valid=vv,
                            scene_valid=None if scene_valid is None else self._t(scene_valid),
                            num_iters=self.icp_iters, max_corr_dist=self.icp_max_corr_dist)
        Rp, tp, Rg, tg = Tp[:, :3, :3], Tp[:, :3, 3], Tg[:, :3, :3], Tg[:, :3, 3]
        add, adds, proj, terr, rerr = (x.cpu().numpy() for x in (
            M.add_error(Rp, tp, Rg, tg, pts, vv),
            M.adds_error(Rp, tp, Rg, tg, pts, vv),
            M.projection_2d_error(Rp, tp, Rg, tg, pts, self._t(K), vv),
            M.translation_error(tp, tg),
            M.rotation_error_deg(Rp, Rg),
        ))
        used = adds if self.symmetric else add
        for b in range(B):
            d = float(used[b])
            self._records.append({
                "add01": float(d < 0.1 * self.diameter),
                "add005": float(d < 0.05 * self.diameter),
                "add002": float(d < 0.02 * self.diameter),
                "proj5": float(proj[b] < 5.0),
                "cm5deg5": float((terr[b] < 0.05) & (rerr[b] < 5.0)),
                "trans_err": float(terr[b]),
                "rot_err_deg": float(rerr[b]),
                "add_dist": d,
                "add_dist_raw": float(add[b]),
                "adds_dist_raw": float(adds[b]),
            })

    def summarize(self) -> Dict[str, float]:
        """Means and seq_len."""
        n = len(self._records)
        if n == 0:
            return {"seq_len": 0}
        out = {k: float(np.mean([r[k] for r in self._records])) for k in self._records[0]}
        out["seq_len"] = n
        return out

    def reset(self):
        self._records.clear()


@dataclasses.dataclass
class YCBEvaluator(PoseEvaluator):
    """The YCB-Video protocol on top of `PoseEvaluator`: the YCB symmetric
    set, and in `summarize()` the PoseCNN AUC metrics (area under the
    accuracy-threshold curve for 0..0.1 m, per sample clip(1 - d / 0.1, 0,
    1)) of ADD and ADD-S, plus ADD-S < 2 cm."""

    auc_max_m: float = 0.1

    def __post_init__(self):
        from ..data.ycb import YCB_SYMMETRIC

        if self.symmetric_override is None:
            self.symmetric_override = self.class_name in YCB_SYMMETRIC
        super().__post_init__()

    def summarize(self) -> Dict[str, float]:
        out = super().summarize()
        if not self._records:
            return out
        add = np.asarray([r["add_dist_raw"] for r in self._records])
        adds = np.asarray([r["adds_dist_raw"] for r in self._records])
        out["add_auc"] = float(np.mean(np.clip(1.0 - add / self.auc_max_m, 0.0, 1.0)))
        out["adds_auc"] = float(np.mean(np.clip(1.0 - adds / self.auc_max_m, 0.0, 1.0)))
        out["adds2cm"] = float(np.mean(adds < 0.02))
        return out
