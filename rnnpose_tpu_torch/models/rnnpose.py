"""RNNPose forward and training loss (port of
`rnnpose_tpu/models/rnnpose.py`).

`RNNPose.encode_3d(pyramid)` runs the two KPConv towers over the model
cloud: the per-class 3D descriptors and context features, which
`models/engine.InferenceEngine` computes once per class and caches.
`RNNPose.forward(inputs, train, cached_desc3d, cached_ctx3d)`: the
SuperPoint 2D descriptors of the image, the 3D features (the cached ones, or
the towers over `inputs.pyramid`), then the PoseRefiner. Eval
(`train=False`) runs without autograd; `train=True` runs with it, the
full-res descriptor tail, the saliency head and the full-res flow, and adds
the losses (`loss`): the circle loss over `inputs.corr` plus the motion
losses over the refinement history. `apply_parity_preset` gives the
reference-exact eval configuration (`tools/eval.py --parity` in the JAX
package).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Type

import torch
from torch import nn

from ..train import losses as loss_lib
from ..utils import profiling
from .hybrid import ContextFeatureNet, HybridDescNet
from .kpconv_net import KPConvConfig, PointPyramid
from .refiner import MeshAssets, PoseRefiner, RefinerConfig, RefinerOutputs

__all__ = ["RNNPoseConfig", "CorrespondenceSet", "RNNPoseInputs", "RNNPose",
           "apply_parity_preset", "init_random_", "register_posenet", "get_posenet_class"]

_POSENET_REGISTRY: Dict[str, Type[nn.Module]] = {}


def register_posenet(cls):
    """Name -> class registry (the reference's `register_posenet`)."""
    _POSENET_REGISTRY[cls.__name__] = cls
    return cls


def get_posenet_class(name: str):
    return _POSENET_REGISTRY[name]


@dataclasses.dataclass(frozen=True)
class RNNPoseConfig:
    """The JAX package's `RNNPoseConfig` fields and defaults. `circle` and
    `motion` configure the training losses."""

    descriptor_dim: int = 32
    ctx_dim: int = 256
    desc_kp: KPConvConfig = KPConvConfig(final_feats_dim=32)
    ctx_kp: KPConvConfig = KPConvConfig(final_feats_dim=256, normalize_output=False)
    refiner: RefinerConfig = RefinerConfig()
    circle: loss_lib.CircleLossConfig = loss_lib.CircleLossConfig()
    motion: loss_lib.RefinerLossConfig = loss_lib.RefinerLossConfig()
    desc2d_eval_tail_res: str = "half"  # eval only: training runs the
                                        # full-res tail


def apply_parity_preset(cfg: RNNPoseConfig) -> RNNPoseConfig:
    """The reference-exact eval configuration (the JAX package's
    `config/defaults.apply_parity_preset`): LM residuals and similarity on
    the full crop, f32 everywhere, the reference's byte-range encoder input
    quirk, and the full-resolution SuperPoint descriptor tail."""
    return dataclasses.replace(
        cfg,
        desc2d_eval_tail_res="full",
        refiner=dataclasses.replace(
            cfg.refiner,
            lm_res="full",
            corr_weight_res="full",
            mixed_precision=False,
            legacy_squash_255=True,
        ),
    )


class CorrespondenceSet(NamedTuple):
    """Fixed-size 2D-3D correspondence sample for the circle loss. Rows are
    fg correspondences (pixel <-> model point), bg pixels (is_bg = 1:
    sentinel coordinates, the 2D descriptor on both sides) or padding
    (valid = 0)."""

    px: torch.Tensor          # (B, P, 2) int64 pixel coords (x, y)
    src_pts: torch.Tensor     # (B, P, 3) lifted 3D points (1e6 sentinel for bg)
    tgt_pts: torch.Tensor     # (B, P, 3) model points (1e6 sentinel for bg)
    model_idx: torch.Tensor   # (B, P) int64 index into the model cloud
    is_bg: torch.Tensor       # (B, P) 1.0 for background rows
    valid: torch.Tensor       # (B, P) 1.0 for real rows


class RNNPoseInputs(NamedTuple):
    """One batch of a single object class."""

    image: torch.Tensor            # (B, H, W, 3) in [0, 1]
    intrinsics: torch.Tensor       # (B, 4)
    T_init: torch.Tensor           # (B, 4, 4)
    T_gt: Optional[torch.Tensor]   # (B, 4, 4) or None
    mesh: MeshAssets
    model_points: torch.Tensor     # (B, N, 3)
    point_valid: torch.Tensor      # (B, N)
    pyramid: Optional[PointPyramid] = None  # over the model cloud (level 0 ==
                                            # mesh verts); read without caches
    corr: Optional[CorrespondenceSet] = None  # training only


def _exact_f32(t: torch.Tensor) -> None:
    """On the card, turn TF32 off for matmuls and cuDNN: pose, geometry, LM
    and the towers' contractions run in exact f32 in the JAX package, and
    the f32 convolutions of `mixed_precision=False` should too."""
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _check_corr(inputs: RNNPoseInputs) -> None:
    """The JAX package's assert on a training batch, as a ValueError."""
    if inputs.corr is None:
        raise ValueError("training requires a CorrespondenceSet (inputs.corr)")


@register_posenet
class RNNPose(nn.Module):
    """Full model. `plain_raster`: see `PoseRefiner`."""

    def __init__(self, cfg: RNNPoseConfig = RNNPoseConfig(), plain_raster: bool = False):
        super().__init__()
        self.cfg = cfg
        self.hybrid_desc_net = HybridDescNet(
            cfg.descriptor_dim, cfg.desc_kp, mixed_precision=cfg.refiner.mixed_precision
        )
        self.ctx_fea_net = ContextFeatureNet(cfg.ctx_kp)
        self.motion_net = PoseRefiner(cfg.refiner, plain_raster=plain_raster)

    @torch.no_grad()
    def encode_3d(self, pyramid: PointPyramid):
        """Per-class 3D constants: (desc3d (B, N, D) unit-norm on real points,
        ctx3d (B, N, C)), zero on padded points. Sets TF32 off on the card,
        as `forward` does."""
        _exact_f32(pyramid.points[0])
        return self.hybrid_desc_net.encode_3d(pyramid), self.ctx_fea_net(pyramid)

    def forward(
        self,
        inputs: RNNPoseInputs,
        train: bool = False,
        cached_desc3d: Optional[torch.Tensor] = None,
        cached_ctx3d: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Refined poses for one batch; with `train` also the losses (loss,
        circle_loss, recall, flow_loss, reproj_loss, loss_3d_proj) and the
        saliency scores (scores_2d).

        cached_desc3d (B, V, D) and cached_ctx3d (B, V, 256) are the outputs
        of `encode_3d` for this class; each one that is None is computed from
        `inputs.pyramid` (with gradient under `train`). Training needs
        `inputs.corr`. On the card this sets
        `torch.backends.cuda.matmul.allow_tf32 = False` and
        `torch.backends.cudnn.allow_tf32 = False` (see `_exact_f32`).
        """
        if not train:
            with torch.no_grad():
                return self._forward(inputs, False, cached_desc3d, cached_ctx3d)
        _check_corr(inputs)
        return self._forward(inputs, True, cached_desc3d, cached_ctx3d)

    def _forward(self, inputs, train, desc3d, ctx3d):
        _exact_f32(inputs.image)
        if desc3d is None or ctx3d is None:
            if inputs.pyramid is None:
                raise ValueError("without cached 3D features the forward needs inputs.pyramid")
            if desc3d is None:
                desc3d = self.hybrid_desc_net.encode_3d(inputs.pyramid)
            if ctx3d is None:
                ctx3d = self.ctx_fea_net(inputs.pyramid)
        # Training always runs the full-res tail (the circle loss reads the
        # descriptors at full-res pixels) and the saliency head.
        scores2d = None
        tail = "full" if train else self.cfg.desc2d_eval_tail_res
        profiling.mark("encode")  # the refiner marks its own stages (`utils/profiling`)
        desc2d = self.hybrid_desc_net.encode_2d(inputs.image, tail, compute_scores=train)
        if train:
            scores2d, desc2d = desc2d
        # The full-res convex-upsampled flow when the loss or a full-res LM
        # or similarity reads it.
        rcfg = self.cfg.refiner
        emit_full_flow = train or not (
            rcfg.lm_res == "eighth"
            and (not rcfg.with_corr_weight or rcfg.corr_weight_res == "eighth")
        )
        outs = self.motion_net(
            image=inputs.image,
            T_init=inputs.T_init,
            intrinsics=inputs.intrinsics,
            mesh=inputs.mesh,
            ctx_fea_3d=ctx3d,
            geofea_3d=desc3d,
            geofea_2d=desc2d,
            T_gt=inputs.T_gt,
            emit_full_flow=emit_full_flow,
            geofea_2d_scale=inputs.image.shape[1] // desc2d.shape[1],
        )
        ret = {"Ti_pred": outs.Ti_pred, "Tij": outs.Tij,
               "scores_2d": scores2d, "refiner": outs}
        if train:
            ret.update(self.loss(inputs, desc2d, desc3d, outs))
        return ret

    def loss(self, inputs: RNNPoseInputs, desc2d: torch.Tensor, desc3d: torch.Tensor,
             outs: RefinerOutputs) -> Dict[str, torch.Tensor]:
        """Circle loss + motion losses (reference `RNNPose.py:225-302`):
        loss, circle_loss, recall (batch means) and the motion terms of
        `train/losses.refiner_loss`."""
        cfg = self.cfg
        _check_corr(inputs)
        corr = inputs.corr
        b =torch.arange(desc2d.shape[0], device=desc2d.device)[:, None]
        d2 = desc2d[b, corr.px[..., 1], corr.px[..., 0]]           # (B, P, D)
        d3 = desc3d[b, corr.model_idx]                             # (B, P, D)
        tgt_feats = torch.where(corr.is_bg[..., None] > 0, d2, d3)
        circle = loss_lib.circle_loss(corr.src_pts, corr.tgt_pts, d2, tgt_feats,
                                      corr.valid, cfg.circle).mean()
        recall = loss_lib.match_recall(corr.src_pts, corr.tgt_pts, d2, tgt_feats,
                                       corr.valid * (1.0 - corr.is_bg), cfg.circle).mean()
        motion = loss_lib.refiner_loss(outs, inputs.model_points, inputs.point_valid,
                                       cfg.motion, cfg.refiner.gru_iters)
        return {
            "loss": cfg.circle.weight * circle + motion["total_loss"],
            "circle_loss": circle,
            "recall": recall,
            "flow_loss": motion["flow_loss"],
            "reproj_loss": motion["reproj_loss"],
            "loss_3d_proj": motion["loss_3d_proj"],
        }


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter from `generator` (in place): conv,
    linear and KPConv weights normal with std 1/sqrt(fan_in), biases zero,
    the similarity sigma one, as the flax initialisers do. The KPConv kernel
    points are buffers and stay as they are."""
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() >= 2:
            # fan_in: C_in * kh * kw of a conv or linear weight (out first);
            # P * C_in of a KPConv weight (P, C_in, C_out).
            kpconv = name.endswith("KPConv.weights")
            fan_in = p.shape[0] * p.shape[1] if kpconv else p[0].numel()
            noise = torch.randn(p.shape, generator=generator, dtype=p.dtype)
            p.copy_(noise / fan_in ** 0.5)
        else:
            p.fill_(1.0)
    return model
