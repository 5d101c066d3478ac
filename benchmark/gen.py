"""Seeded generators of the benchmark's inputs and weights, frozen here so
that a change to the program cannot move them.

Everything is drawn from the run's `--seed` through `numpy.random.SeedSequence`
(any non-negative whole number, however large), one stream per purpose:
the scene (poses, image noise, correspondences) on the host with numpy, the
weights and the per-request jitter and noise on the device with a
`torch.Generator`. The same seed gives the same scene, the same weights
and the same request stream; the program and the reference are handed the
same tensors, each wrapped in its own types (`as_inputs`).

* `make_weights`: a state dict by parameter name by the rule of
  `rnnpose_tpu_torch.models.rnnpose.init_random_` (biases zero, vectors
  one, every other tensor normal with std 1/sqrt(fan_in)), drawn on the
  device in one call;
* `make_scene`: the icosphere mesh, B ground-truth poses and noisy initial
  poses, the observed image rendered with the reference's plain raster over
  a noise background, and the KPConv pyramid over the mesh vertices;
* `make_corr`: a training correspondence set (90% foreground rows from the
  vertices visible in each frame, 10% background pixels), as
  `rnnpose_tpu_torch/data/synthetic.py` draws it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference.data import pyramid as pyr_lib
from .reference.data.poses import sample_noisy_poses
from .reference.models.kpconv_net import KPConvConfig
from .reference.render import mesh as mesh_lib
from .reference.render.raster import rasterize_with_vis_attrs
from .reference.render.shading import compute_vertex_normals, headlight_shade

__all__ = ["seeds", "make_weights", "Scene", "make_scene", "make_corr", "as_inputs",
           "kpconv_config", "icosphere"]

# Stream names; each gets its own entropy from the run's seed.
STREAMS = ("scene", "weights", "requests", "check")


def seeds(seed: int) -> Dict[str, int]:
    """One 63-bit seed per stream, from any whole number."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return {name: int(s.generate_state(2, np.uint64)[0] >> np.uint64(1))
            for name, s in zip(STREAMS, ss.spawn(len(STREAMS)))}


def _host_rng(seed: int) -> np.random.RandomState:
    return np.random.RandomState(np.random.SeedSequence(seed).generate_state(8))


@torch.no_grad()
def make_weights(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every parameter of `model` (the port's module tree
    and the reference's name them alike), on `device`, by init_random_'s
    rule. KPConv weights (P, C_in, C_out) have fan_in P * C_in; a conv or
    linear weight (out first) the numel of one output's slice."""
    gen = torch.Generator(device=device).manual_seed(seed)
    named = list(model.named_parameters())
    drawn = [(n, p) for n, p in named if not n.endswith("bias") and p.dim() >= 2]
    noise = torch.randn(sum(p.numel() for _, p in drawn), generator=gen, device=device)
    out, at = {}, 0
    for name, p in drawn:
        kpconv = name.endswith("KPConv.weights")
        fan_in = p.shape[0] * p.shape[1] if kpconv else p[0].numel()
        out[name] = noise[at:at + p.numel()].view(p.shape) / fan_in ** 0.5
        at += p.numel()
    for name, p in named:
        if name.endswith("bias"):
            out[name] = torch.zeros(p.shape, device=device)
        elif name not in out:
            out[name] = torch.ones(p.shape, device=device)
    return out


def icosphere(subdivisions: int, radius: float) -> mesh_lib.TriMesh:
    """An icosahedron subdivided `subdivisions` times, with a positional
    pseudo-texture (`rnnpose_tpu_torch/data/synthetic.make_icosphere`)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                  [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                  [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdivisions):
        edge_mid, new_faces, verts = {}, [], list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts[a] + verts[b]) / 2.0
                edge_mid[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return edge_mid[key]

        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.asarray(verts), np.asarray(new_faces, np.int64)
    verts = (v * radius).astype(np.float32)
    colors = (0.5 + 0.5 * np.sin(verts * 40.0)).astype(np.float32)
    return mesh_lib.TriMesh(verts, f.astype(np.int32), colors)


def kpconv_config(cfg: dict) -> KPConvConfig:
    """The KPConv configuration the pyramid is built with: the towers'
    layers and first voxel (the pyramid reads nothing else)."""
    return KPConvConfig(num_layers=cfg["kp_layers"], first_subsampling_dl=cfg["kp_dl"])


@dataclasses.dataclass
class Scene:
    """One batch of B frames of one object, as plain tensors on the device."""

    image: torch.Tensor        # (B, H, W, 3) in [0, 1]
    intrinsics: torch.Tensor   # (B, 4)
    T_gt: torch.Tensor         # (B, 4, 4)
    T_init: torch.Tensor       # (B, 4, 4)
    mesh: Dict[str, torch.Tensor]   # verts, faces, colors, vert_valid, face_valid, normals
    model_points: torch.Tensor      # (B, V, 3)
    point_valid: torch.Tensor       # (B, V)
    pyramid: Dict[str, List[torch.Tensor]]  # points, masks, neighbors, pools, upsamples
    fid: np.ndarray                 # (B, H, W) face ids of the observed render (host)
    mesh_np: mesh_lib.TriMesh = None


def make_scene(cfg: dict, batch: int, seed: int, device) -> Scene:
    """The configuration's object in `batch` frames, drawn from `seed`."""
    from scipy.spatial.transform import Rotation

    rs = _host_rng(seed)
    B, S = batch, cfg["image_size"]
    V, F = cfg["num_verts"], cfg["num_faces"]
    mesh = icosphere(cfg["subdivisions"], cfg["object_scale"])
    mesh = mesh_lib.simplify_mesh(mesh, V, F)
    mesh = mesh_lib.orient_faces_outward(mesh)
    mesh = mesh_lib.pad_mesh(mesh, V, F)

    intrinsics = np.tile(np.asarray([[cfg["fx"], cfg["fy"], S / 2.0, S / 2.0]], np.float32),
                         (B, 1))
    T_gt = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        T_gt[b, :3, :3] = Rotation.random(random_state=rs).as_matrix()
        T_gt[b, :3, 3] = [rs.uniform(-0.03, 0.03), rs.uniform(-0.03, 0.03),
                          cfg["distance"] * rs.uniform(0.9, 1.1)]
    T_init = sample_noisy_poses(T_gt, rs)

    normals = compute_vertex_normals(mesh.verts, mesh.faces[: mesh.num_faces])
    verts_cam = (np.einsum("bij,vj->bvi", T_gt[:, :3, :3], mesh.verts)
                 + T_gt[:, None, :3, 3]).astype(np.float32)
    attrs = np.concatenate([np.tile(mesh.vert_colors[None], (B, 1, 1)),
                            np.einsum("bij,vj->bvi", T_gt[:, :3, :3], normals)],
                           axis=-1).astype(np.float32)
    face_valid = np.arange(F) < mesh.num_faces

    def dev(a):
        return torch.as_tensor(a, device=device)

    faces = dev(mesh.faces.astype(np.int64))
    attr_img, _, fid = rasterize_with_vis_attrs(dev(verts_cam), faces, dev(intrinsics),
                                                dev(attrs), S, S, face_valid=dev(face_valid))
    shaded = headlight_shade(attr_img[..., :3], attr_img[..., 3:6]).cpu().numpy()
    fid = fid.cpu().numpy()
    fg = fid >= 0
    image = rs.rand(B, S, S, 3).astype(np.float32) * 0.1
    image[fg] = np.clip(shaded[fg] + rs.randn(int(fg.sum()), 3).astype(np.float32) * 0.02,
                        0.0, 1.0)

    pyr = pyr_lib.build_pyramid_arrays(mesh.verts[: mesh.num_verts], kpconv_config(cfg),
                                       [cfg["kp_neighbors"]] * cfg["kp_layers"])
    sizes = [V] + [int(np.ceil(len(pyr.points[l]) / 8) * 8) for l in range(1, cfg["kp_layers"])]
    pyramid = pyr_lib.pad_and_batch_pyramids([pyr] * B, level_sizes=sizes)
    vert_valid = (np.arange(V) < mesh.num_verts).astype(np.float32)
    return Scene(
        image=dev(image), intrinsics=dev(intrinsics), T_gt=dev(T_gt), T_init=dev(T_init),
        mesh=dict(verts=dev(mesh.verts), faces=faces, colors=dev(mesh.vert_colors),
                  vert_valid=dev(vert_valid), face_valid=dev(face_valid), normals=dev(normals)),
        model_points=dev(np.tile(mesh.verts[None], (B, 1, 1))),
        point_valid=dev(np.tile(vert_valid[None], (B, 1))),
        pyramid={k: [t.to(device) for t in getattr(pyramid, k)]
                 for k in ("points", "masks", "neighbors", "pools", "upsamples")},
        fid=fid, mesh_np=mesh)


def make_corr(scene: Scene, num_corr: int, seed: int) -> Dict[str, torch.Tensor]:
    """A correspondence set over the scene's frames, drawn from `seed`."""
    rs = _host_rng(seed)
    B, S = scene.fid.shape[0], scene.fid.shape[1]
    P, n_fg = num_corr, int(num_corr * 0.9)
    verts, faces = scene.mesh_np.verts, scene.mesh_np.faces
    T = scene.T_gt.cpu().numpy()
    K = scene.intrinsics.cpu().numpy()
    px = np.zeros((B, P, 2), np.int64)
    src = np.full((B, P, 3), 1e6, np.float32)
    tgt = np.full((B, P, 3), 1e6, np.float32)
    idx = np.zeros((B, P), np.int64)
    is_bg = np.ones((B, P), np.float32)
    for b in range(B):
        vis_faces = np.unique(scene.fid[b][scene.fid[b] >= 0])
        vis_verts = np.unique(faces[vis_faces].ravel())
        pick = vis_verts[rs.randint(0, len(vis_verts), size=n_fg)]
        vc = verts[pick] @ T[b, :3, :3].T + T[b, :3, 3]
        z = np.maximum(vc[:, 2], 1e-6)
        uv = np.stack([K[b, 0] * vc[:, 0] / z + K[b, 2], K[b, 1] * vc[:, 1] / z + K[b, 3]], -1)
        px[b, :n_fg] = np.clip(np.round(uv), 0, S - 1).astype(np.int64)
        src[b, :n_fg] = verts[pick] + rs.randn(n_fg, 3) * 1e-3
        tgt[b, :n_fg] = verts[pick]
        idx[b, :n_fg] = pick
        is_bg[b, :n_fg] = 0.0
        px[b, n_fg:] = rs.randint(0, S, size=(P - n_fg, 2))
    device = scene.image.device
    return {k: torch.as_tensor(v, device=device) for k, v in dict(
        px=px, src_pts=src, tgt_pts=tgt, model_idx=idx, is_bg=is_bg,
        valid=np.ones((B, P), np.float32)).items()}


def as_inputs(side, scene: Scene, image=None, T_init=None, corr: Optional[dict] = None,
              pyramid: bool = True):
    """The scene as `side`'s `RNNPoseInputs` (side: the module that defines
    RNNPoseInputs, MeshAssets, CorrespondenceSet and PointPyramid, i.e. the
    program's `models.rnnpose` + `models.kpconv_net` or the reference's),
    with the image and initial pose replaced where given."""
    rn, kp = side
    pyr = (kp.PointPyramid(*(scene.pyramid[k] for k in
                             ("points", "masks", "neighbors", "pools", "upsamples")))
           if pyramid else None)
    return rn.RNNPoseInputs(
        image=scene.image if image is None else image, intrinsics=scene.intrinsics,
        T_init=scene.T_init if T_init is None else T_init, T_gt=scene.T_gt,
        mesh=rn.MeshAssets(**scene.mesh), model_points=scene.model_points,
        point_valid=scene.point_valid, pyramid=pyr,
        corr=None if corr is None else rn.CorrespondenceSet(**corr))
