"""RNNPose eval forward (port of `rnnpose_tpu/models/rnnpose.py`).

`RNNPose.forward(inputs, train=False, cached_desc3d, cached_ctx3d)`: the
SuperPoint 2D descriptors of the image, then the PoseRefiner with the
per-class 3D descriptors and context features a caller computed once and
cached (the KPConv towers that compute them are not ported yet, ROADMAP
Queue 1 item 5; training is item 6). `apply_parity_preset` gives the
reference-exact eval configuration (`tools/eval.py --parity` in the JAX
package).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from .hybrid import HybridDescNet
from .refiner import MeshAssets, PoseRefiner, RefinerConfig

__all__ = ["RNNPoseConfig", "RNNPoseInputs", "RNNPose", "apply_parity_preset",
           "init_random_"]


@dataclasses.dataclass(frozen=True)
class RNNPoseConfig:
    """The JAX package's `RNNPoseConfig` fields. `desc_kp`, `ctx_kp`,
    `circle` and `motion` configure the KPConv towers and the losses, which
    this package does not run yet; they are accepted and unused."""

    descriptor_dim: int = 32
    ctx_dim: int = 256
    desc_kp: Any = None
    ctx_kp: Any = None
    refiner: RefinerConfig = RefinerConfig()
    circle: Any = None
    motion: Any = None
    desc2d_eval_tail_res: str = "half"


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


class RNNPoseInputs(NamedTuple):
    """One eval batch of a single object class."""

    image: torch.Tensor            # (B, H, W, 3) in [0, 1]
    intrinsics: torch.Tensor       # (B, 4)
    T_init: torch.Tensor           # (B, 4, 4)
    T_gt: Optional[torch.Tensor]   # (B, 4, 4) or None
    mesh: MeshAssets
    model_points: torch.Tensor     # (B, N, 3)
    point_valid: torch.Tensor      # (B, N)


class RNNPose(nn.Module):
    """Full model, eval forward with cached 3D features. `plain_raster`:
    see `PoseRefiner`."""

    def __init__(self, cfg: RNNPoseConfig = RNNPoseConfig(), plain_raster: bool = False):
        super().__init__()
        self.cfg = cfg
        self.hybrid_desc_net = HybridDescNet(
            cfg.descriptor_dim, mixed_precision=cfg.refiner.mixed_precision
        )
        self.motion_net = PoseRefiner(cfg.refiner, plain_raster=plain_raster)

    @torch.no_grad()
    def forward(
        self,
        inputs: RNNPoseInputs,
        train: bool = False,
        cached_desc3d: Optional[torch.Tensor] = None,
        cached_ctx3d: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Refined poses for one batch.

        cached_desc3d (B, V, D) unit-norm and cached_ctx3d (B, V, 256) are
        the per-class outputs of the 3D towers. On the card this sets
        `torch.backends.cuda.matmul.allow_tf32 = False` and
        `torch.backends.cudnn.allow_tf32 = False`: pose, geometry and LM
        contractions must run in exact f32, and the f32 convolutions of
        `mixed_precision=False` should too.
        """
        if train:
            raise NotImplementedError(
                "train=True is not ported yet (ROADMAP Queue 1 item 6)")
        if cached_desc3d is None or cached_ctx3d is None:
            raise NotImplementedError(
                "the KPConv 3D towers are not ported yet (ROADMAP Queue 1 "
                "item 5); pass cached_desc3d and cached_ctx3d")
        if inputs.image.is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        desc2d = self.hybrid_desc_net.encode_2d(
            inputs.image, tail_res=self.cfg.desc2d_eval_tail_res
        )
        # The full-res convex-upsampled flow only when a full-res LM or
        # similarity reads it.
        rcfg = self.cfg.refiner
        emit_full_flow = not (
            rcfg.lm_res == "eighth"
            and (not rcfg.with_corr_weight or rcfg.corr_weight_res == "eighth")
        )
        outs = self.motion_net(
            image=inputs.image,
            T_init=inputs.T_init,
            intrinsics=inputs.intrinsics,
            mesh=inputs.mesh,
            ctx_fea_3d=cached_ctx3d,
            geofea_3d=cached_desc3d,
            geofea_2d=desc2d,
            T_gt=inputs.T_gt,
            emit_full_flow=emit_full_flow,
            geofea_2d_scale=inputs.image.shape[1] // desc2d.shape[1],
        )
        return {"Ti_pred": outs.Ti_pred, "Tij": outs.Tij,
                "scores_2d": None, "refiner": outs}


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter from `generator` (in place): conv
    kernels normal with std 1/sqrt(fan_in), biases zero, the similarity
    sigma one, as the flax initialisers do."""
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            noise = torch.randn(p.shape, generator=generator, dtype=p.dtype)
            p.copy_(noise / fan_in ** 0.5)
        else:
            p.fill_(1.0)
    return model
