"""LINEMOD / Occlusion-LINEMOD dataset in the DeepIM info-pickle format
(port of `rnnpose_tpu/data/linemod.py`).

* `.info` pickles {class: [frame dicts]} are merged (several files, each
  with its own dataset root);
* RGB frames (PNG or JPEG) and depth PNGs are read with the port's codecs
  (`data/imageio.py`);
* each class's mesh is loaded from OBJ/PLY once, simplified to the static
  budget, wound outward and padded, with its normalised KPConv pyramid;
* train: noisy init poses sampled around GT unless the info carries
  `pose_noisy_rendered`; eval: PoseCNN/PVNet init poses from result files,
  with the blender->bop conversion for PVNet;
* the init rotation is re-orthonormalised (SVD);
* a degenerate training frame (too few correspondences) raises
  `preprocess.TooFewCorrespondences`; the caller moves to the next index.

* synthetic frames (`is_syn`, or "syn" in the RGB path) get a random VOC
  background (`diningtable_trainval` list, JPEG, resized to the frame)
  behind their depth mask when `voc_root` is set; the draw comes first in
  the sample's random stream, before the crop, the noisy pose and the
  correspondences, as in the JAX package.

Samples are unbatched numpy dicts; `collate_samples` stacks a
single-class batch into the port's `RNNPoseInputs` on a given device.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.kpconv_net import KPConvConfig
from ..models.refiner import MeshAssets
from ..models.rnnpose import CorrespondenceSet, RNNPoseInputs
from ..render import mesh as mesh_lib
from ..render.shading import compute_vertex_normals
from . import imageio
from . import preprocess as prep
from . import pyramid as pyr_lib
from .dataset import Dataset, register_dataset
from .poses import pose_padding, reorthonormalize, sample_noisy_poses
from .transforms import make_transforms

__all__ = ["LinemodSynRealDataset", "ClassAssets", "collate_samples", "quat_pose_to_matrix"]


def quat_pose_to_matrix(pose7: np.ndarray) -> np.ndarray:
    """PoseCNN [qw qx qy qz tx ty tz] -> (3, 4)."""
    q = pose7[:4] / np.linalg.norm(pose7[:4])
    w, x, y, z = q
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    return np.concatenate([R, pose7[4:7, None].astype(np.float32)], axis=1)


@dataclasses.dataclass
class ClassAssets:
    """Per-class constants, computed once (numpy): the padded mesh, its
    model points and the normalised pyramid."""

    mesh: MeshAssets
    model_points: np.ndarray        # (V, 3) original metric points (padded)
    model_points_norm: np.ndarray   # (V, 3) normalised (padded)
    point_valid: np.ndarray         # (V,)
    center: np.ndarray
    scale: float
    pyramid_arrays: pyr_lib.PyramidArrays
    level_sizes: List[int]


@register_dataset
class LinemodSynRealDataset(Dataset):
    def __init__(
        self,
        info_paths: Sequence[str],
        root_paths: Sequence[str],
        model_dir: str,
        kp_cfg: KPConvConfig,
        is_train: bool = True,
        class_names: Optional[Sequence[str]] = None,
        prep_cfg: prep.PreprocessConfig = prep.PreprocessConfig(),
        neighbor_limits: Optional[Sequence[int]] = None,
        init_pose_type: str = "POSECNN_LINEMOD",
        init_pose_paths: Optional[Dict[str, str]] = None,
        blender_to_bop_path: Optional[str] = None,
        voc_root: Optional[str] = None,
        max_verts: int = 2048,
        max_faces: int = 4096,
        seed: int = 0,
    ):
        if len(info_paths) != len(root_paths):
            raise ValueError(f"{len(info_paths)} info files but {len(root_paths)} roots")
        self.is_train = is_train
        self.root_paths = list(root_paths)
        self.model_dir = model_dir
        self.kp_cfg = kp_cfg
        self.prep_cfg = prep_cfg
        self.voc_root = voc_root
        self.max_verts = max_verts
        self.max_faces = max_faces
        self.seed = seed
        self.rs = np.random.RandomState(seed)
        self.rgb_transform = make_transforms(is_train, seed)
        self.init_pose_type = init_pose_type

        self.frames: List[Dict[str, Any]] = []
        for ds_idx, ipath in enumerate(info_paths):
            with open(ipath, "rb") as f:
                info = pickle.load(f)
            for cls, frames in info.items():
                if class_names is not None and cls not in class_names:
                    continue
                for fr in frames:
                    rec = dict(fr)
                    rec["class_name"] = cls
                    rec["dataset_idx"] = ds_idx
                    self.frames.append(rec)

        self.class_names = sorted({f["class_name"] for f in self.frames})
        self.cls2idx = {c: i for i, c in enumerate(self.class_names)}

        self.init_poses = None
        self.blender_to_bop = None
        if not is_train and init_pose_paths:
            path = init_pose_paths.get(init_pose_type)
            if path and os.path.exists(path):
                if path.endswith(".pkl"):
                    with open(path, "rb") as f:
                        self.init_poses = pickle.load(f)
                else:
                    self.init_poses = np.load(path, allow_pickle=True).flat[0]
            if blender_to_bop_path and os.path.exists(blender_to_bop_path):
                self.blender_to_bop = np.load(blender_to_bop_path, allow_pickle=True).flat[0]

        self._assets: Dict[str, ClassAssets] = {}
        self._assets_lock = threading.Lock()
        self._neighbor_limits = list(neighbor_limits) if neighbor_limits else None

    def class_assets(self, cls: str) -> ClassAssets:
        """The class's mesh and pyramid, built on first request (once: the
        prefetch threads that ask together wait for the first)."""
        with self._assets_lock:
            if cls not in self._assets:
                self._assets[cls] = self._build_class_assets(cls)
            return self._assets[cls]

    def _build_class_assets(self, cls: str) -> ClassAssets:
        mesh_path = None
        for ext in (".obj", ".ply"):
            for cand in (
                os.path.join(self.model_dir, cls, f"textured{ext}"),
                os.path.join(self.model_dir, f"{cls}{ext}"),
            ):
                if os.path.exists(cand):
                    mesh_path = cand
                    break
            if mesh_path:
                break
        if mesh_path is None:
            raise FileNotFoundError(f"no mesh for class {cls} under {self.model_dir}")
        # Simplified once to the static raster budget (watertight vertex
        # clustering), wound outward for the backface-culled sweep, padded.
        m = mesh_lib.load_mesh(mesh_path)
        m = mesh_lib.simplify_mesh(m, self.max_verts, self.max_faces)
        m = mesh_lib.orient_faces_outward(m)
        n_real_v, n_real_f = m.num_verts, m.num_faces
        m = mesh_lib.pad_mesh(m, self.max_verts, self.max_faces)

        pts = m.verts[:n_real_v]
        pts_norm, _, center, scale = prep.normalize_model(pts, np.eye(3, 4, dtype=np.float32))
        if self._neighbor_limits is None:
            self._neighbor_limits = pyr_lib.calibrate_neighbor_limits([pts_norm], self.kp_cfg)
        pyr = pyr_lib.build_pyramid_arrays(pts_norm, self.kp_cfg, self._neighbor_limits)
        level_sizes = [self.max_verts] + [
            int(np.ceil(len(pyr.points[l]) / 8) * 8) for l in range(1, self.kp_cfg.num_layers)
        ]

        pad_pts = np.zeros((self.max_verts, 3), np.float32)
        pad_pts[:n_real_v] = pts
        pad_norm = np.zeros((self.max_verts, 3), np.float32)
        pad_norm[:n_real_v] = pts_norm
        valid = (np.arange(self.max_verts) < n_real_v).astype(np.float32)

        return ClassAssets(
            mesh=MeshAssets(
                verts=m.verts,
                faces=m.faces,
                colors=m.vert_colors,
                vert_valid=valid,
                face_valid=(np.arange(self.max_faces) < n_real_f),
                normals=compute_vertex_normals(m.verts, m.faces[:n_real_f]),
            ),
            model_points=pad_pts,
            model_points_norm=pad_norm,
            point_valid=valid,
            center=center,
            scale=scale,
            pyramid_arrays=pyr,
            level_sizes=level_sizes,
        )

    def __len__(self):
        return len(self.frames)

    def _load_image(self, path: str) -> np.ndarray:
        return imageio.read_rgb(path).astype(np.float32) / 255.0

    def _load_depth(self, path: str) -> np.ndarray:
        d = imageio.read_png(path).astype(np.float32)
        if d.max() > 100:  # a millimetre PNG
            d = d / 1000.0
        return d

    def _paste_voc_background(self, image: np.ndarray, fg_mask: np.ndarray,
                              rs: np.random.RandomState) -> np.ndarray:
        """A random VOC background (JPEG) behind a synthetic frame. Without
        the list file the image comes back unchanged and nothing is drawn;
        a background that cannot be read (missing, not an image, corrupt:
        where cv2.imread returns None) leaves it unchanged after the draw."""
        if self.voc_root is None:
            return image
        list_path = os.path.join(
            self.voc_root, "VOCdevkit/VOC2012/ImageSets/Main/diningtable_trainval.txt")
        if not os.path.exists(list_path):
            return image
        with open(list_path) as f:
            names = [line.split()[0] for line in f if line.strip()]
        name = names[rs.randint(len(names))]
        bg_path = os.path.join(self.voc_root, "VOCdevkit/VOC2012/JPEGImages", f"{name}.jpg")
        try:
            bg = imageio.read_rgb(bg_path)
        except (OSError, ValueError):
            return image
        bg = prep.resize_linear(bg.astype(np.float32) / 255.0, (image.shape[1], image.shape[0]))
        m = fg_mask[..., None].astype(np.float32)
        return image * m + bg * (1 - m)

    def _init_pose_for_eval(self, cls: str, frame_idx: int, RT_gt: np.ndarray) -> np.ndarray:
        """The PoseCNN / PVNet initial pose of a frame, else GT."""
        if self.init_poses is None:
            return RT_gt.copy()
        if self.init_pose_type == "POSECNN_LINEMOD":
            rec = self.init_poses[cls][frame_idx]
            RT = quat_pose_to_matrix(np.asarray(rec["pose"], np.float32))
        else:  # PVNet variants: blender frame -> bop frame
            RT = np.asarray(self.init_poses[cls][frame_idx], np.float32).copy()
            if self.blender_to_bop is not None:
                conv = self.blender_to_bop[cls]
                RT[:3, :3] = RT[:3, :3] @ conv[:3, :3].T
                RT[:3, 3:] = -RT[:3, :3] @ conv[:3, 3:] + RT[:3, 3:]
        return RT[:3, :4]

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        """An unbatched sample dict; augmentation draws from the
        dataset-lifetime stream `self.rs` (not thread-safe in training: the
        training loader uses `sample_at`)."""
        return self.sample(idx, self.rs)

    def sample_at(self, idx: int, position: int) -> Dict[str, Any]:
        """`__getitem__` with its randomness a pure function of (seed,
        position), `position` being the sample's place in the training
        stream: thread-safe prefetch and bit-reproducible resume."""
        mix = (self.seed * 0x9E3779B97F4A7C15 + position * 0xBF58476D1CE4E5B9
               ) & 0xFFFFFFFFFFFFFFFF
        mix ^= mix >> 31
        return self.sample(idx, np.random.RandomState(mix % (2**32)))

    def sample(self, idx: int, rs: np.random.RandomState) -> Dict[str, Any]:
        fr = self.frames[idx]
        cls = fr["class_name"]
        assets = self.class_assets(cls)
        root = self.root_paths[fr["dataset_idx"]]

        image = self._load_image(os.path.join(root, fr["rgb_observed_path"]))
        depth = self._load_depth(os.path.join(root, fr["depth_gt_observed_path"]))
        K = np.asarray(fr["K"], np.float32)
        RT_gt = np.asarray(fr["gt_pose"], np.float32)[:3, :4]

        if fr.get("is_syn", False) or "syn" in str(fr.get("rgb_observed_path", "")):
            image = self._paste_voc_background(image, depth > 0, rs)

        if self.is_train:
            if fr.get("pose_noisy_rendered") is not None:
                RT_init = np.asarray(fr["pose_noisy_rendered"], np.float32)[:3, :4]
            else:
                RT_init = sample_noisy_poses(pose_padding(RT_gt[None]), rs)[0, :3, :4]
        else:
            if self.init_poses is not None and "index" not in fr:
                # A positional fallback would misalign init poses once info
                # files are merged or classes filtered.
                raise KeyError(
                    f"frame {idx} ({cls}) has no 'index' field; regenerate "
                    "the .info file with tools/generate_data_info.py so "
                    "eval init poses can be aligned explicitly"
                )
            RT_init = self._init_pose_for_eval(cls, fr.get("index", idx), RT_gt)
        RT_init = RT_init.copy()
        RT_init[:3, :3] = reorthonormalize(RT_init[:3, :3])

        # The object-centric crop around the init pose's projected model.
        uv = _project_points(assets.model_points[assets.point_valid > 0], RT_init, K)
        mask = np.zeros(depth.shape, bool)
        pix = np.round(uv).astype(np.int64)
        ok = ((pix[:, 0] >= 0) & (pix[:, 0] < mask.shape[1])
              & (pix[:, 1] >= 0) & (pix[:, 1] < mask.shape[0]))
        mask[pix[ok, 1], pix[ok, 0]] = True
        image_c, depth_c, _, K_c = prep.patch_crop(
            image, depth, mask, K,
            margin_ratio=self.prep_cfg.crop_margin_ratio,
            output_size=self.prep_cfg.crop_size,
        )
        if self.is_train:
            image_c = self.rgb_transform(image_c, rs)

        _, RT_norm, _, _ = prep.normalize_model(
            assets.model_points[assets.point_valid > 0], RT_gt)
        corr = None
        if self.is_train:
            pts_cam, px = prep.mask_depth_to_points(depth_c, K_c)
            lifted = prep.lift_to_model_frame(pts_cam, RT_norm, assets.scale)
            model_norm = assets.model_points_norm[assets.point_valid > 0]
            pairs = prep.get_correspondences(lifted, model_norm,
                                             self.prep_cfg.correspondence_radius)
            corr = prep.build_correspondence_set(lifted, px, model_norm, pairs, depth_c > 0,
                                                 self.prep_cfg, rs)

        return {
            "class_name": cls,
            "image": image_c.astype(np.float32),
            "intrinsics": np.asarray([K_c[0, 0], K_c[1, 1], K_c[0, 2], K_c[1, 2]], np.float32),
            # The pre-crop camera: Proj2D thresholds in original-image pixels.
            "orig_intrinsics": np.asarray([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32),
            "T_gt": pose_padding(RT_gt),
            "T_init": pose_padding(RT_init),
            "corr": corr,
            "assets": assets,
            # The cropped depth (m) for consumers outside the model (ICP).
            "depth": depth_c.astype(np.float32),
        }


def _project_points(pts: np.ndarray, RT: np.ndarray, K: np.ndarray) -> np.ndarray:
    pc = pts @ RT[:3, :3].T + RT[:3, 3]
    z = np.maximum(pc[:, 2], 1e-6)
    return np.stack([K[0, 0] * pc[:, 0] / z + K[0, 2], K[1, 1] * pc[:, 1] / z + K[1, 2]],
                    axis=-1)


def collate_samples(samples: List[Dict[str, Any]], device="cpu") -> RNNPoseInputs:
    """Stack single-class samples into the port's `RNNPoseInputs`, every
    tensor on `device`."""
    classes = {s["class_name"] for s in samples}
    if len(classes) != 1:
        raise ValueError(f"batch must be single-class, got {classes}")
    assets: ClassAssets = samples[0]["assets"]
    B = len(samples)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    pyramid = pyr_lib.pad_and_batch_pyramids(
        [assets.pyramid_arrays] * B, level_sizes=assets.level_sizes).to(device)
    corr = None
    if samples[0]["corr"] is not None:
        corr = CorrespondenceSet(*[
            dev(np.stack([getattr(s["corr"], f) for s in samples]))
            for f in CorrespondenceSet._fields
        ])
    m = assets.mesh
    mesh = MeshAssets(
        verts=dev(m.verts), faces=dev(m.faces, torch.int64), colors=dev(m.colors),
        vert_valid=dev(m.vert_valid), face_valid=dev(m.face_valid),
        normals=dev(m.normals),
    )
    return RNNPoseInputs(
        image=dev(np.stack([s["image"] for s in samples])),
        intrinsics=dev(np.stack([s["intrinsics"] for s in samples])),
        T_init=dev(np.stack([s["T_init"] for s in samples])),
        T_gt=dev(np.stack([s["T_gt"] for s in samples])),
        mesh=mesh,
        model_points=dev(np.tile(assets.model_points[None], (B, 1, 1))),
        point_valid=dev(np.tile(assets.point_valid[None], (B, 1))),
        pyramid=pyramid,
        corr=corr,
    )
