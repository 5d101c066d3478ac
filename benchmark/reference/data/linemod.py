"""The training sample path of a LINEMOD-format data set, frozen here: a
copy of what `rnnpose_tpu_torch/data/linemod.py` runs for a training frame
(`LinemodSynRealDataset.sample_at` without a VOC background, the class's
mesh and normalised KPConv pyramid, `collate_samples`) and the index
stream of `data/samplers.GivenIterationSampler` in one process, over the
reference's PNG reader, preprocessing, augmentation and pyramid (numpy
only: the program builds the pyramid with its native ops where they
build, which may order neighbours at equal distance differently).

`TrainFrames(...).batch(j, B)` reads batch j of the training stream as
the program's loader reads it when no frame is skipped: stream positions
j * B .. j * B + B - 1, the frame at each from the sampler's seed-7
permutations, the sample's randomness from (seed, position).
"""
from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..models.kpconv_net import KPConvConfig
from ..models.refiner import MeshAssets
from ..models.rnnpose import RNNPoseInputs
from ..render import mesh as mesh_lib
from ..render.shading import compute_vertex_normals
from . import imageio
from . import preprocess as prep
from . import pyramid as pyr_lib
from .poses import pose_padding, reorthonormalize, sample_noisy_poses
from .transforms import make_transforms

__all__ = ["TrainFrames", "frame_at", "collate"]

SAMPLER_SEED = 7


def frame_at(num_frames: int, positions: Sequence[int]) -> List[int]:
    """The frame index at each stream position: the sampler's seed-7
    permutations of the frames, one after another (one process, from the
    start of the stream)."""
    rs = np.random.RandomState(SAMPLER_SEED)
    reps = max(positions) // num_frames + 1
    idx = np.concatenate([rs.permutation(num_frames) for _ in range(reps)])
    return [int(idx[p]) for p in positions]


def _project_points(pts: np.ndarray, RT: np.ndarray, K: np.ndarray) -> np.ndarray:
    pc = pts @ RT[:3, :3].T + RT[:3, 3]
    z = np.maximum(pc[:, 2], 1e-6)
    return np.stack([K[0, 0] * pc[:, 0] / z + K[0, 2], K[1, 1] * pc[:, 1] / z + K[1, 2]],
                    axis=-1)


class TrainFrames:
    """The training frames of one class of a LINEMOD-format set (`info_path`
    under `root`, meshes under `model_dir`), sampled as the program's
    training dataset samples them."""

    def __init__(self, info_path: str, root: str, model_dir: str, kp_cfg: KPConvConfig,
                 prep_cfg: prep.PreprocessConfig, neighbor_limits: Sequence[int],
                 max_verts: int, max_faces: int, seed: int = 0):
        with open(info_path, "rb") as f:
            info = pickle.load(f)
        if len(info) != 1:
            raise ValueError(f"{info_path}: one class expected, got {sorted(info)}")
        (self.cls, self.frames), = info.items()
        if any(fr.get("is_syn") or "syn" in str(fr.get("rgb_observed_path", ""))
               or fr.get("pose_noisy_rendered") is not None for fr in self.frames):
            raise ValueError(f"{info_path}: synthetic or pre-rendered frames are not covered")
        self.root, self.model_dir, self.kp_cfg, self.prep_cfg = root, model_dir, kp_cfg, prep_cfg
        self.neighbor_limits = list(neighbor_limits)
        self.max_verts, self.max_faces, self.seed = max_verts, max_faces, seed
        self.transform = make_transforms(True, seed)
        self._assets = None
        self._lock = threading.Lock()

    def assets(self) -> Dict[str, Any]:
        """The class's padded mesh, model points and normalised pyramid."""
        with self._lock:
            if self._assets is None:
                self._assets = self._build_assets()
            return self._assets

    def _build_assets(self) -> Dict[str, Any]:
        path = os.path.join(self.model_dir, self.cls, "textured.obj")
        m = mesh_lib.load_mesh(path)
        m = mesh_lib.simplify_mesh(m, self.max_verts, self.max_faces)
        m = mesh_lib.orient_faces_outward(m)
        n_v, n_f = m.num_verts, m.num_faces
        m = mesh_lib.pad_mesh(m, self.max_verts, self.max_faces)
        pts = m.verts[:n_v]
        pts_norm, _, _, scale = prep.normalize_model(pts, np.eye(3, 4, dtype=np.float32))
        pyr = pyr_lib.build_pyramid_arrays(pts_norm, self.kp_cfg, self.neighbor_limits)
        level_sizes = [self.max_verts] + [int(np.ceil(len(pyr.points[l]) / 8) * 8)
                                          for l in range(1, self.kp_cfg.num_layers)]
        pad_pts = np.zeros((self.max_verts, 3), np.float32)
        pad_pts[:n_v] = pts
        pad_norm = np.zeros((self.max_verts, 3), np.float32)
        pad_norm[:n_v] = pts_norm
        valid = (np.arange(self.max_verts) < n_v).astype(np.float32)
        return dict(
            mesh=dict(verts=m.verts, faces=m.faces, colors=m.vert_colors, vert_valid=valid,
                      face_valid=np.arange(self.max_faces) < n_f,
                      normals=compute_vertex_normals(m.verts, m.faces[:n_f])),
            model_points=pad_pts, model_points_norm=pad_norm, point_valid=valid, scale=scale,
            pyramid=pyr, level_sizes=level_sizes)

    def sample_at(self, idx: int, position: int) -> Dict[str, Any]:
        """Frame `idx` with its randomness a function of (seed, position)."""
        mix = (self.seed * 0x9E3779B97F4A7C15 + position * 0xBF58476D1CE4E5B9
               ) & 0xFFFFFFFFFFFFFFFF
        mix ^= mix >> 31
        return self.sample(idx, np.random.RandomState(mix % (2**32)))

    def sample(self, idx: int, rs: np.random.RandomState) -> Dict[str, Any]:
        fr = self.frames[idx]
        a = self.assets()
        image = imageio.read_rgb(os.path.join(self.root, fr["rgb_observed_path"]))
        image = image.astype(np.float32) / 255.0
        depth = imageio.read_png(os.path.join(self.root, fr["depth_gt_observed_path"]))
        depth = depth.astype(np.float32)
        if depth.max() > 100:  # a millimetre PNG
            depth = depth / 1000.0
        K = np.asarray(fr["K"], np.float32)
        RT_gt = np.asarray(fr["gt_pose"], np.float32)[:3, :4]
        RT_init = sample_noisy_poses(pose_padding(RT_gt[None]), rs)[0, :3, :4].copy()
        RT_init[:3, :3] = reorthonormalize(RT_init[:3, :3])

        uv = _project_points(a["model_points"][a["point_valid"] > 0], RT_init, K)
        mask = np.zeros(depth.shape, bool)
        pix = np.round(uv).astype(np.int64)
        ok = ((pix[:, 0] >= 0) & (pix[:, 0] < mask.shape[1])
              & (pix[:, 1] >= 0) & (pix[:, 1] < mask.shape[0]))
        mask[pix[ok, 1], pix[ok, 0]] = True
        image_c, depth_c, _, K_c = prep.patch_crop(
            image, depth, mask, K, margin_ratio=self.prep_cfg.crop_margin_ratio,
            output_size=self.prep_cfg.crop_size)
        image_c = self.transform(image_c, rs)

        _, RT_norm, _, _ = prep.normalize_model(a["model_points"][a["point_valid"] > 0], RT_gt)
        pts_cam, px = prep.mask_depth_to_points(depth_c, K_c)
        lifted = prep.lift_to_model_frame(pts_cam, RT_norm, a["scale"])
        model_norm = a["model_points_norm"][a["point_valid"] > 0]
        pairs = prep.get_correspondences(lifted, model_norm, self.prep_cfg.correspondence_radius)
        corr = prep.build_correspondence_set(lifted, px, model_norm, pairs, depth_c > 0,
                                             self.prep_cfg, rs)
        return {"image": image_c.astype(np.float32),
                "intrinsics": np.asarray([K_c[0, 0], K_c[1, 1], K_c[0, 2], K_c[1, 2]],
                                         np.float32),
                "T_gt": pose_padding(RT_gt), "T_init": pose_padding(RT_init), "corr": corr}

    def positions(self, batch_index: int, batch_size: int) -> List[tuple]:
        """(frame, position) of each sample of batch `batch_index`."""
        pos = list(range(batch_index * batch_size, (batch_index + 1) * batch_size))
        return list(zip(frame_at(len(self.frames), pos), pos))


def collate(frames: TrainFrames, samples: List[Dict[str, Any]], device) -> RNNPoseInputs:
    """Stack samples of the class into the reference's `RNNPoseInputs` on
    `device`."""
    a = frames.assets()
    B = len(samples)

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    pyr = pyr_lib.pad_and_batch_pyramids([a["pyramid"]] * B, level_sizes=a["level_sizes"])
    pyramid = type(pyr)(*([t.to(device) for t in ts] for ts in (
        pyr.points, pyr.masks, pyr.neighbors, pyr.pools, pyr.upsamples)))
    corr = type(samples[0]["corr"])(*[dev(np.stack([getattr(s["corr"], f) for s in samples]))
                                      for f in samples[0]["corr"]._fields])
    m = a["mesh"]
    return RNNPoseInputs(
        image=dev(np.stack([s["image"] for s in samples])),
        intrinsics=dev(np.stack([s["intrinsics"] for s in samples])),
        T_init=dev(np.stack([s["T_init"] for s in samples])),
        T_gt=dev(np.stack([s["T_gt"] for s in samples])),
        mesh=MeshAssets(verts=dev(m["verts"]), faces=dev(m["faces"], torch.int64),
                        colors=dev(m["colors"]), vert_valid=dev(m["vert_valid"]),
                        face_valid=dev(m["face_valid"]), normals=dev(m["normals"])),
        model_points=dev(np.tile(a["model_points"][None], (B, 1, 1))),
        point_valid=dev(np.tile(a["point_valid"][None], (B, 1))),
        pyramid=pyramid, corr=corr)
