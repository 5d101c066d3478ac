"""PoseRefiner: render -> flow -> LM pose refinement (port of
`rnnpose_tpu/models/refiner.py`), for evaluation and training.

Per render iteration: the zoom crop from the projected vertices, the
rasterization at crop resolution, the observed crop, the RAFT encoder on
both crops, the correlation pyramid, then `gru_iters` inner steps
(pose-induced coords, corr lookup + SepConvGRU, descriptor similarity, one
LM step). The JAX `nn.scan` becomes a Python loop.

Two raster branches, picked as the JAX package picks them
(`fused = corr_weight_res == 'eighth' and no backface culling and the crop a
multiple of 16`):
* fused (the TPU-first serving defaults, and training): one sweep that also
  interpolates RGB + camera-frame normals
  (`render/raster.rasterize_with_vis_attrs`: `zbuffer_sweep_rows_attrs`, or
  `zbuffer_sweep_tiled_attrs_batched` under `RNNPOSE_RASTER_GRID=tile`),
  barycentrics and 3D features on the 1/8 grid only;
* non-fused (the reference-exact `apply_parity_preset`, backface culling,
  other crop sizes): `rasterize` (`zbuffer_sweep_tiled`) with full-res
  barycentrics, optionally over the per-pose compacted front faces.
`lm_res` and `corr_weight_res` pick the grid of the LM residuals and of the
similarity: 'eighth' (the 1/8 grid the flow lives on) or 'full' (the crop,
on the convex-upsampled flow). With `with_corr_weight=False` the LM weight
is the rendered depth mask on the LM's grid.

Gradients (the reference's placements, `PoseRefiner.py:141,248-251,
319-321`): the rasterization, the rendering pose, the crop intrinsics, the
rendered depth and Tij across inner steps are detached; gradients flow
through the interpolated 3D features, the 2D descriptors, the flow network,
the similarity weights and each LM step. Activations are stored for the
backward: `remat`, like `scan_unroll` and `corr_impl`, is a TPU/compile
knob, accepted and ignored.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry import crop as crop_lib
from ..geometry import lm as lm_lib
from ..geometry import projective as proj
from ..geometry import se3 as se3_lib
from ..geometry.precise import fma
from ..ops import corr as corr_ops
from ..ops.sampler import bilinear_sample, separable_crop_sample
from ..render.raster import (
    Fragments,
    compute_bary,
    interpolate_attributes,
    rasterize,
    rasterize_with_vis_attrs,
)
from ..render.shading import headlight_shade
from .cfnet import GRUFlowStep, ImageFeaEncoder, downsample_flow, split_context

__all__ = ["RefinerConfig", "MeshAssets", "RefinerOutputs", "PoseRefiner",
           "zoom_crop", "backface_keep"]

EPS = 1e-5  # depth epsilon (reference `PoseRefiner.py:21`)


@dataclasses.dataclass(frozen=True)
class RefinerConfig:
    """Same fields and defaults as the JAX package's `RefinerConfig`."""

    render_iters: int = 3
    gru_iters: int = 4
    optim_iters: int = 1
    zoom_crop_size: int = 240
    margin_ratio: float = 0.4
    corr_radius: int = 4
    corr_levels: int = 4
    hidden_dim: int = 128
    context_dim: int = 128
    feature_scale: float = 0.1
    with_corr_weight: bool = True
    lm_lambda: float = 1e-4
    ep_lambda: float = 100.0
    raster_chunk: int = 128
    remat: bool = False            # accepted, ignored (activations are stored)
    mixed_precision: bool = True   # bf16 SuperPoint, encoder and GRU convs
    corr_weight_res: str = "eighth"
    emit_full_flow: bool = True    # RNNPose passes False for the 1/8-grid eval
    backface_cull: bool = False
    corr_impl: str = "mulreduce"   # accepted, ignored (TPU lowering choice)
    scan_unroll: int = 1           # accepted, ignored (TPU lowering choice)
    lm_res: str = "eighth"
    legacy_squash_255: bool = False

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.mixed_precision else None

    @property
    def lm_config(self) -> lm_lib.LMConfig:
        return lm_lib.LMConfig(lm_lambda=self.lm_lambda, ep_lambda=self.ep_lambda)


class MeshAssets(NamedTuple):
    """Static per-class mesh, padded to fixed budgets."""

    verts: torch.Tensor       # (V, 3) object-frame vertices
    faces: torch.Tensor       # (F, 3) int64
    colors: torch.Tensor      # (V, 3) in [0, 1]
    vert_valid: torch.Tensor  # (V,) 1.0 for real vertices
    face_valid: torch.Tensor  # (F,) bool
    normals: Optional[torch.Tensor] = None  # (V, 3) object-frame normals


class RefinerOutputs(NamedTuple):
    """Histories stacked as (render_iters * gru_iters, B, ...) where noted."""

    Ti_pred: torch.Tensor
    Tij: torch.Tensor
    flow_history: torch.Tensor       # (T, B, S, S, 2), or (T, B, S/8, S/8, 2)
                                     # without emit_full_flow
    Tij_history: torch.Tensor
    Ti_history: torch.Tensor
    Tij_gt_history: torch.Tensor
    intrinsics_history: torch.Tensor
    syn_depth_history: torch.Tensor  # (R, B, S, S)
    weight: torch.Tensor             # (B, S, S, 1) last similarity weight
    syn_img: torch.Tensor
    image_crop: torch.Tensor
    valid_mask: torch.Tensor


def zoom_crop(Ti_render, mesh: MeshAssets, intrinsics, h_img: int, w_img: int,
              out_size: int, margin: float):
    """The reference zoom crop of a pose: (verts_cam (B, V, 3), crop_params
    (B, 4), K_crop (B, 4)).

    The crop box is the integer bbox of the projected valid vertices (round,
    then clamp to the image), the window is centred on the projected object
    origin (`geometry/crop.reference_crop_params`)."""
    verts_cam = proj.transform_points(Ti_render, mesh.verts[None])
    uv, _ = proj.project(verts_cam, intrinsics[:, None, :])
    vvalid = (mesh.vert_valid[None] > 0) & (verts_cam[..., 2] > proj.MIN_DEPTH)
    big = torch.full_like(uv[..., 0], 1e9)
    x0 = torch.where(vvalid, uv[..., 0], big).amin(dim=1)
    y0 = torch.where(vvalid, uv[..., 1], big).amin(dim=1)
    x1 = torch.where(vvalid, uv[..., 0], -big).amax(dim=1)
    y1 = torch.where(vvalid, uv[..., 1], -big).amax(dim=1)
    none_valid = ~torch.any(vvalid, dim=1)

    def snap(v, hi, empty):
        v = torch.clamp(torch.round(v), 0, hi)
        return torch.where(none_valid, torch.full_like(v, empty), v)

    bbox = torch.stack([
        snap(x0, w_img - 1, 0.0), snap(y0, h_img - 1, 0.0),
        snap(x1, w_img - 1, float(w_img - 1)), snap(y1, h_img - 1, float(h_img - 1)),
    ], dim=-1)
    center_uv, _ = proj.project(Ti_render[:, None, :3, 3], intrinsics[:, None, :])
    crop_params = crop_lib.reference_crop_params(
        center_uv[:, 0], bbox, margin, ratio=float(h_img) / float(w_img)
    )
    return verts_cam, crop_params, crop_lib.crop_intrinsics(intrinsics, crop_params, out_size)


def backface_keep(Ti_render, mesh: MeshAssets, chunk: int):
    """The per-pose backface test with a silhouette margin: (face_keep
    (B, F) bool, compact_to). A face is kept when its outward normal is
    within ~78 degrees of facing the camera; the sweep is compacted to 5/8
    of the face budget (a closed, consistently wound mesh shows ~50%
    backfaces every frame)."""
    R = Ti_render[:, :3, :3]
    n_face = mesh.normals[mesh.faces].mean(dim=1)             # (F, 3)
    c_face = mesh.verts[mesh.faces].mean(dim=1)
    n_cam = torch.einsum("bij,fj->bfi", R, n_face)
    c_cam = proj.transform_points(Ti_render, c_face[None])
    dot = torch.sum(n_cam * c_cam, dim=-1)
    norm = torch.linalg.norm(n_cam, dim=-1) * torch.clamp(
        torch.linalg.norm(c_cam, dim=-1), min=1e-6)
    F_total = mesh.faces.shape[0]
    return dot < 0.2 * norm, (F_total * 5 // 8) // chunk * chunk


class PoseRefiner(nn.Module):
    """The recurrent 6-DoF refinement engine.

    `plain_raster=True` runs every raster sweep through its plain PyTorch
    version on any device (the kernels' reference); by default a CUDA tensor
    goes through the CUDA kernels.
    """

    def __init__(self, cfg: RefinerConfig = RefinerConfig(), plain_raster: bool = False):
        super().__init__()
        self.cfg = cfg
        self.plain_raster = plain_raster
        self.image_fea_enc = ImageFeaEncoder(dtype=cfg.compute_dtype)
        self.cf_net = GRUFlowStep(cfg.corr_levels, cfg.corr_radius, cfg.compute_dtype)
        # The similarity's temperature exists only with the similarity, as
        # in the JAX parameter tree.
        self.sigma = (nn.ParameterList([nn.Parameter(torch.ones(1))])
                      if cfg.with_corr_weight else None)

    def _inner_step(self, cfg: RefinerConfig, Tij, h, inv):
        """One GRU + similarity-weight + LM iteration."""
        S = cfg.zoom_crop_size
        s8 = S // 8
        dev = Tij.device
        grid_lr = proj.coords_grid(s8, s8, device=dev)[None]
        syn_depth = inv["syn_depth"]
        if cfg.lm_res == "eighth":
            # Everything pose-related on the 1/8 grid: the flow init is the
            # pose-induced flow of the subsampled depth.
            depth_lr = syn_depth[:, 4::8, 4::8]
            K_lr = inv["K_crop"] / 8.0
            reproj_lr, _ = lm_lib.pose_transform_coords(Tij, depth_lr + EPS, K_lr)
            coords_lr = torch.where((depth_lr > EPS)[..., None], reproj_lr, grid_lr)
        else:
            # The full-res pose-induced flow, downsampled (reference 324-328).
            grid = proj.coords_grid(S, S, device=dev)[None]
            reproj, _ = lm_lib.pose_transform_coords(Tij, syn_depth + EPS, inv["K_crop"])
            flow_init = (reproj - grid) * (syn_depth > EPS)[..., None].to(reproj.dtype)
            coords_lr = grid_lr + downsample_flow(flow_init, 8)

        h, coords_lr, flow = self.cf_net(
            h, inv["inp"], inv["pyramid"], coords_lr, grid_lr,
            emit_full_flow=cfg.emit_full_flow,
        )
        if cfg.emit_full_flow:
            target = flow + proj.coords_grid(S, S, device=dev)[None]

        # Descriptor similarity w = exp(-|1 - <d3, warp(d2)>| / sigma),
        # masked by the rendered depth; without it, the full-res depth mask.
        if not cfg.with_corr_weight:
            weight = (syn_depth > 0)[..., None].to(torch.float32)
        elif cfg.corr_weight_res == "eighth":
            warped = bilinear_sample(inv["geofea2_lr"], coords_lr)
            dot = torch.sum(inv["geofea1_lr"] * warped, dim=-1, keepdim=True)
            mask = syn_depth[:, 4::8, 4::8] > 0
        else:
            # The reference's quirk, reproduced: its normalised grid uses the
            # align_corners=True formula but grid_sample reads it with
            # align_corners=False, so it samples at u * S/(S-1) - 0.5
            # (contracted into one multiply-add, as XLA does: `precise`).
            tq = fma(target, S / (S - 1.0), -0.5)
            warped = bilinear_sample(inv["geofea2_crop"], tq)
            dot = torch.sum(inv["geofea1"] * warped, dim=-1, keepdim=True)
            mask = syn_depth > 0
        if cfg.with_corr_weight:
            weight = torch.exp(-torch.abs(1.0 - dot) / self.sigma[0])
            weight = weight * mask[..., None].to(weight.dtype)

        if cfg.lm_res == "eighth":
            w_lr = (weight if cfg.with_corr_weight
                    else (depth_lr > 0)[..., None].to(coords_lr.dtype))
            Tij = lm_lib.reprojection_optim(
                Tij, coords_lr, w_lr.expand(coords_lr.shape), depth_lr + EPS, K_lr,
                num_iters=cfg.optim_iters, cfg=cfg.lm_config,
            )
        else:
            w_full = weight
            if w_full.shape[1] != S:
                # 1/8-grid similarity, full-res LM: upsample the weight.
                w_full = to_full(w_full, S) * (syn_depth > 0)[..., None].to(w_full.dtype)
            Tij = lm_lib.reprojection_optim(
                Tij, target, w_full.expand(target.shape), syn_depth + EPS,
                inv["K_crop"], num_iters=cfg.optim_iters, cfg=cfg.lm_config,
            )
        return Tij, h, flow, weight

    def forward(
        self,
        image: torch.Tensor,          # (B, H, W, 3) observed image, [0, 1]
        T_init: torch.Tensor,         # (B, 4, 4) initial pose
        intrinsics: torch.Tensor,     # (B, 4) full-image intrinsics
        mesh: MeshAssets,
        ctx_fea_3d: torch.Tensor,     # (B, V, >=256) context features
        geofea_3d: torch.Tensor,      # (B, V, D) 3D descriptors
        geofea_2d: torch.Tensor,      # (B, H', W', D) 2D descriptors
        T_gt: Optional[torch.Tensor] = None,
        emit_full_flow: Optional[bool] = None,
        geofea_2d_scale: int = 1,     # geofea_2d is at 1/scale resolution
    ) -> RefinerOutputs:
        cfg = self.cfg
        if emit_full_flow is not None and emit_full_flow != cfg.emit_full_flow:
            cfg = dataclasses.replace(cfg, emit_full_flow=emit_full_flow)
        if not cfg.emit_full_flow and (
            cfg.lm_res != "eighth"
            or (cfg.with_corr_weight and cfg.corr_weight_res != "eighth")
        ):
            raise ValueError(
                "emit_full_flow=False requires the 1/8-grid LM and similarity")
        if cfg.lm_res == "eighth" and cfg.with_corr_weight and cfg.corr_weight_res != "eighth":
            raise ValueError(
                "lm_res='eighth' requires corr_weight_res='eighth' when "
                "similarity weighting is on")
        use_geo = geofea_3d is not None and geofea_2d is not None
        if cfg.with_corr_weight and not use_geo:
            raise ValueError("with_corr_weight requires geofea_2d/geofea_3d inputs")

        B = image.shape[0]
        S = cfg.zoom_crop_size
        s8 = S // 8
        eighth = cfg.corr_weight_res == "eighth"
        h_img, w_img = image.shape[1], image.shape[2]
        eye = torch.eye(4, dtype=T_init.dtype, device=T_init.device).expand(B, 4, 4)
        Ti, Tij = T_init, eye
        gx = torch.arange(s8, dtype=torch.float32, device=image.device) * 8.0 + 4.5
        pix_xy = torch.stack(torch.meshgrid(gx, gx, indexing="xy"), dim=-1)
        feat_attrs = torch.cat([ctx_fea_3d, geofea_3d], dim=-1) if use_geo else ctx_fea_3d
        c_ctx = ctx_fea_3d.shape[-1]
        enc_scale = (1.0 / 255.0) if cfg.legacy_squash_255 else 1.0
        use_pallas = False if self.plain_raster else None

        hist = {k: [] for k in ("flow", "Tij", "Ti", "Tij_gt", "K_crop")}
        syn_depths = []
        for _ in range(cfg.render_iters):
            Ti = Tij @ Ti
            Tij = eye
            Ti_render = Ti.detach()
            verts_cam, crop_params, K_crop = zoom_crop(
                Ti_render, mesh, intrinsics, h_img, w_img, S, cfg.margin_ratio
            )
            K_crop = K_crop.detach()

            attrs = [mesh.colors[None].expand(B, -1, -1)]
            if mesh.normals is not None:
                R = Ti_render[:, :3, :3]
                attrs.append(torch.einsum("bij,vj->bvi", R, mesh.normals))
            vis_attrs = torch.cat(attrs, dim=-1)
            face_keep = compact_to = None
            if cfg.backface_cull and mesh.normals is not None:
                face_keep, compact_to = backface_keep(Ti_render, mesh, cfg.raster_chunk)

            if eighth and face_keep is None and S % 16 == 0:
                attr_vis, syn_depth, fid = rasterize_with_vis_attrs(
                    verts_cam, mesh.faces, K_crop, vis_attrs, S, S,
                    face_valid=mesh.face_valid, chunk=cfg.raster_chunk, plain=self.plain_raster,
                )
                fid_lr = fid[:, 4::8, 4::8]
                bary_lr = compute_bary(
                    verts_cam, mesh.faces, K_crop, fid_lr, pix_xy, mesh.face_valid
                )
                frags_lr = Fragments(fid_lr, bary_lr, syn_depth[:, 4::8, 4::8])
            else:
                frags = rasterize(
                    verts_cam, mesh.faces, K_crop, S, S, face_valid=mesh.face_valid,
                    chunk=cfg.raster_chunk, use_pallas=use_pallas,
                    face_keep=face_keep, compact_to=compact_to,
                )
                syn_depth = frags.zbuf
                attr_vis = interpolate_attributes(frags, mesh.faces, vis_attrs)
                frags_lr = Fragments(*(x[:, 4::8, 4::8] for x in frags))
            syn_img = attr_vis[..., :3]
            if mesh.normals is not None:
                syn_img = headlight_shade(syn_img, attr_vis[..., 3:])

            # Features where their consumers read them: the 1/8 grid, or the
            # full crop for the reference-exact similarity.
            feat = interpolate_attributes(frags_lr if eighth else frags, mesh.faces, feat_attrs)
            cfea = feat[..., :c_ctx] * cfg.feature_scale

            image_crop = separable_crop_sample(image, crop_params, S)
            fmap1, fmap2 = self.image_fea_enc(syn_img * enc_scale, image_crop * enc_scale)
            inv = {
                "pyramid": corr_ops.build_corr_pyramid(fmap1, fmap2, cfg.corr_levels),
                "syn_depth": syn_depth,
                "K_crop": K_crop,
            }
            h, inv["inp"] = split_context(
                cfea, cfg.hidden_dim, cfg.context_dim, cfg.compute_dtype,
                out_hw=(s8, s8),
            )
            # With align_corners=False sampling, dividing the crop by the
            # descriptor field's scale is exact.
            cp_geo = crop_params / float(geofea_2d_scale)
            if use_geo and eighth:
                inv["geofea2_lr"] = separable_crop_sample(geofea_2d, cp_geo, s8)
                inv["geofea1_lr"] = feat[..., c_ctx:]
            elif use_geo:
                inv["geofea2_crop"] = separable_crop_sample(geofea_2d, cp_geo, S)
                inv["geofea1"] = feat[..., c_ctx:]

            for _ in range(cfg.gru_iters):
                Tij, h, flow, weight = self._inner_step(cfg, Tij.detach(), h, inv)
                hist["flow"].append(flow)
                hist["Tij"].append(Tij)

            Ti_sg = Ti.detach()
            if T_gt is not None:
                Tij_gt = (T_gt @ se3_lib.se3_inverse(Ti_sg)).detach()
            else:
                Tij_gt = eye
            for key, val in (("Ti", Ti_sg), ("Tij_gt", Tij_gt), ("K_crop", K_crop)):
                hist[key] += [val] * cfg.gru_iters
            syn_depths.append(syn_depth)

        Ti = Tij @ Ti
        if weight.shape[1] != S:
            # The 1/8-grid similarity of the last step, upsampled once.
            weight = to_full(weight, S) * (syn_depth > 0)[..., None].to(weight.dtype)
        return RefinerOutputs(
            Ti_pred=Ti,
            Tij=Tij,
            flow_history=torch.stack(hist["flow"]),
            Tij_history=torch.stack(hist["Tij"]),
            Ti_history=torch.stack(hist["Ti"]),
            Tij_gt_history=torch.stack(hist["Tij_gt"]),
            intrinsics_history=torch.stack(hist["K_crop"]),
            syn_depth_history=torch.stack(syn_depths),
            weight=weight,
            syn_img=syn_img,
            image_crop=image_crop,
            valid_mask=(syn_depth > 0).to(image.dtype),
        )


def to_full(x: torch.Tensor, size: int) -> torch.Tensor:
    """Half-pixel bilinear upsampling of (B, h, w, C) to (B, size, size, C)
    (equal to `jax.image.resize(..., 'bilinear')` when upsampling)."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                        mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1)
