"""Deterministic synthetic scene: an icosphere object, a GT pose, a noisy
init pose, an observed image rendered with the port's rasterizer, the
KPConv pyramid over the mesh vertices and, for training, a fixed-size 2D-3D
correspondence set.

Port of `rnnpose_tpu/data/synthetic.py::make_synthetic_inputs`: it makes the
same `np.random.RandomState` draws in the same order, so both packages
build the same scene (and correspondence set) from one seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.kpconv_net import KPConvConfig
from ..models.refiner import MeshAssets
from ..models.rnnpose import CorrespondenceSet, RNNPoseInputs
from ..render import mesh as mesh_lib
from ..render.raster import rasterize_with_vis_attrs
from ..render.shading import compute_vertex_normals, headlight_shade
from . import pyramid as pyr_lib
from .poses import sample_noisy_poses

__all__ = ["SyntheticConfig", "make_icosphere", "make_capsule", "kpconv_config",
           "make_synthetic_inputs"]


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    image_size: int = 320
    batch_size: int = 1
    num_verts: int = 512          # padded vertex budget
    num_faces: int = 1024         # padded face budget
    subdivisions: int = 3
    object_scale: float = 0.06    # ~12 cm object
    distance: float = 0.6
    fx: float = 572.4114          # LINEMOD intrinsics
    fy: float = 573.57043
    seed: int = 0
    kp_layers: int = 3
    kp_dl: float = 0.012
    num_corr: int = 256           # correspondence rows (90% fg, 10% bg)


def make_icosphere(subdivisions: int = 3, radius: float = 1.0) -> mesh_lib.TriMesh:
    """Icosahedron subdivided `subdivisions` times (642 verts at 3), with a
    positional pseudo-texture."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts = list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts[a] + verts[b]) / 2.0
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts)
                verts.append(m)
            return edge_mid[key]

        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(new_faces, np.int64)
    verts = (v * radius).astype(np.float32)
    colors = (0.5 + 0.5 * np.sin(verts * 40.0)).astype(np.float32)
    return mesh_lib.TriMesh(verts, f.astype(np.int32), colors)


def make_capsule(
    subdivisions: int = 3, radius: float = 1.0, cap_sep: float = 3.0
) -> mesh_lib.TriMesh:
    """An icosphere with its hemispheres pulled `cap_sep * radius` apart
    along z: (2 + cap_sep) r long, 2r wide (2.5:1 at the default)."""
    m = make_icosphere(subdivisions, radius)
    verts = m.verts.copy()
    shift = np.where(verts[:, 2] >= 0.0, 1.0, -1.0) * (cap_sep * radius / 2.0)
    verts[:, 2] += shift.astype(np.float32)
    colors = (0.5 + 0.5 * np.sin(verts * 40.0)).astype(np.float32)
    return mesh_lib.TriMesh(verts, m.faces, colors)


def kpconv_config(cfg: SyntheticConfig) -> KPConvConfig:
    """The KPConv configuration the scene's pyramid is built with (the
    second value the JAX package's `make_synthetic_inputs` returns)."""
    return KPConvConfig(num_layers=cfg.kp_layers, first_subsampling_dl=cfg.kp_dl,
                        first_feats_dim=64, final_feats_dim=32, gnn_feats_dim=64)


def make_synthetic_inputs(
    cfg: SyntheticConfig = SyntheticConfig(), device="cpu", with_corr: bool = False,
) -> RNNPoseInputs:
    """Build one batch on `device`; with `with_corr`, with the
    correspondence set of the training loss."""
    from scipy.spatial.transform import Rotation

    rs = np.random.RandomState(cfg.seed)
    B, S = cfg.batch_size, cfg.image_size

    mesh = make_icosphere(cfg.subdivisions, cfg.object_scale)
    mesh = mesh_lib.simplify_mesh(mesh, cfg.num_verts, cfg.num_faces)
    mesh = mesh_lib.orient_faces_outward(mesh)
    mesh = mesh_lib.pad_mesh(mesh, cfg.num_verts, cfg.num_faces)

    intrinsics = np.tile(
        np.asarray([[cfg.fx, cfg.fy, S / 2.0, S / 2.0]], np.float32), (B, 1)
    )
    T_gt = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        T_gt[b, :3, :3] = Rotation.random(random_state=rs).as_matrix()
        T_gt[b, :3, 3] = [
            rs.uniform(-0.03, 0.03),
            rs.uniform(-0.03, 0.03),
            cfg.distance * rs.uniform(0.9, 1.1),
        ]
    T_init = sample_noisy_poses(T_gt, rs)

    # Observed image: the mesh rasterized at the GT pose (colors + headlight
    # shading) over a noise background, plus mild pixel noise.
    normals = compute_vertex_normals(mesh.verts, mesh.faces[: mesh.num_faces])
    verts_cam = (
        np.einsum("bij,vj->bvi", T_gt[:, :3, :3], mesh.verts)
        + T_gt[:, None, :3, 3]
    ).astype(np.float32)
    attrs_np = np.concatenate(
        [
            np.tile(mesh.vert_colors[None], (B, 1, 1)),
            np.einsum("bij,vj->bvi", T_gt[:, :3, :3], normals),
        ],
        axis=-1,
    ).astype(np.float32)
    face_valid_np = np.arange(cfg.num_faces) < mesh.num_faces

    def dev(a):
        return torch.as_tensor(a, device=device)

    faces = dev(mesh.faces.astype(np.int64))
    attr_img, _, fid = rasterize_with_vis_attrs(
        dev(verts_cam), faces, dev(intrinsics), dev(attrs_np), S, S,
        face_valid=dev(face_valid_np),
    )
    shaded = headlight_shade(attr_img[..., :3], attr_img[..., 3:6]).cpu().numpy()
    fg = fid.cpu().numpy() >= 0
    image = rs.rand(B, S, S, 3).astype(np.float32) * 0.1
    image[fg] = np.clip(
        shaded[fg] + rs.randn(int(fg.sum()), 3).astype(np.float32) * 0.02,
        0.0, 1.0,
    )

    # The KPConv pyramid over the real vertices; level 0 padded to the
    # vertex budget (features align with vertices), later levels to a
    # multiple of 8. No random draws.
    pyr = pyr_lib.build_pyramid_arrays(mesh.verts[: mesh.num_verts], kpconv_config(cfg),
                                       [24] * cfg.kp_layers)
    sizes = [cfg.num_verts] + [
        int(np.ceil(len(pyr.points[l]) / 8) * 8) for l in range(1, cfg.kp_layers)
    ]
    pyramid = pyr_lib.pad_and_batch_pyramids([pyr] * B, level_sizes=sizes).to(device)

    corr = None
    if with_corr:
        P = cfg.num_corr
        n_fg = int(P * 0.9)
        px = np.zeros((B, P, 2), np.int64)
        src_pts = np.full((B, P, 3), 1e6, np.float32)
        tgt_pts = np.full((B, P, 3), 1e6, np.float32)
        model_idx = np.zeros((B, P), np.int64)
        is_bg = np.ones((B, P), np.float32)
        fid_np = fid.cpu().numpy()
        for b in range(B):
            # Correspondences from vertices visible in this frame's raster
            # (front surface, as lifted depth gives them), bg rows at random
            # pixels.
            vis_faces = np.unique(fid_np[b][fg[b]])
            vis_verts = np.unique(mesh.faces[vis_faces].ravel())
            vis_idx = vis_verts[rs.randint(0, len(vis_verts), size=n_fg)]
            uvb = _project(mesh.verts[vis_idx], T_gt[b:b + 1], intrinsics[b:b + 1])[0]
            px[b, :n_fg] = np.clip(np.round(uvb), 0, S - 1).astype(np.int64)
            src_pts[b, :n_fg] = mesh.verts[vis_idx] + rs.randn(n_fg, 3) * 1e-3
            tgt_pts[b, :n_fg] = mesh.verts[vis_idx]
            model_idx[b, :n_fg] = vis_idx
            is_bg[b, :n_fg] = 0.0
            px[b, n_fg:] = rs.randint(0, S, size=(P - n_fg, 2))
        corr = CorrespondenceSet(
            px=dev(px), src_pts=dev(src_pts), tgt_pts=dev(tgt_pts),
            model_idx=dev(model_idx), is_bg=dev(is_bg),
            valid=dev(np.ones((B, P), np.float32)),
        )

    vert_valid = (np.arange(cfg.num_verts) < mesh.num_verts).astype(np.float32)
    mesh_assets = MeshAssets(
        verts=dev(mesh.verts),
        faces=faces,
        colors=dev(mesh.vert_colors),
        vert_valid=dev(vert_valid),
        face_valid=dev(face_valid_np),
        normals=dev(normals),
    )
    return RNNPoseInputs(
        image=dev(image),
        intrinsics=dev(intrinsics),
        T_init=dev(T_init),
        T_gt=dev(T_gt),
        mesh=mesh_assets,
        model_points=dev(np.tile(mesh.verts[None], (B, 1, 1))),
        point_valid=dev(np.tile(vert_valid[None], (B, 1))),
        pyramid=pyramid,
        corr=corr,
    )


def _project(verts, T, K):
    """(V, 3), (B, 4, 4), (B, 4) -> (B, V, 2) pixel coords (numpy)."""
    vc = np.einsum("bij,vj->bvi", T[:, :3, :3], verts) + T[:, None, :3, 3]
    z = np.maximum(vc[..., 2], 1e-6)
    u = K[:, None, 0] * vc[..., 0] / z + K[:, None, 2]
    v = K[:, None, 1] * vc[..., 1] / z + K[:, None, 3]
    return np.stack([u, v], axis=-1)
