"""Default experiment schema and typed-config builders (port of
`rnnpose_tpu/config/defaults.py`).

The schema mirrors the reference per-object template
(`config/linemod/template_fw0.5.yml:1-177`) key for key, so one YAML file
configures both packages; `build_*` turn the merged dict into the typed
configs the model and the trainer take, and `build_dataset` the LINEMOD
dataset of a reader section.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict

from ..models.kpconv_net import KPConvConfig
from ..models.refiner import RefinerConfig
from ..models.rnnpose import RNNPoseConfig
from ..train.losses import CircleLossConfig, RefinerLossConfig
from ..train.optim import OptimizerConfig

__all__ = [
    "default_config",
    "build_model_config",
    "build_optimizer_config",
    "build_dataset",
]

# Host preprocess knobs exposed through YAML (null = library default); see
# `data/preprocess.PreprocessConfig` + the dataset mesh budgets.
_PREPROCESS_KEYS = {
    "crop_size": None,
    "crop_margin_ratio": None,
    "num_corr": None,
    "correspondence_radius": None,
    "min_correspondences": None,
    "max_points": None,
    "bg_fraction": None,
    "max_verts": None,
    "max_faces": None,
    "neighbor_limits": None,
}


def default_config() -> Dict[str, Any]:
    """The full default experiment dict (YAML-merge base)."""
    kpconv = {
        "num_layers": 4,
        "kp_extent": 2.0,
        "batch_norm_momentum": 0.02,
        "use_batch_norm": True,
        "in_points_dim": 3,
        "fixed_kernel_points": "center",
        "kp_influence": "linear",
        "aggregation_mode": "sum",
        "modulated": False,
        "first_subsampling_dl": 0.025,
        "conv_radius": 2.5,
        "deform_radius": 5.0,
        "in_features_dim": 1,
        "first_feats_dim": 128,
        "num_kernel_points": 15,
        "final_feats_dim": 32,
        "gnn_feats_dim": 128,
        "normalize_output": True,
    }
    return {
        "basic": {
            "input_h": 320,
            "input_w": 320,
            "render_image_size": [320, 320],
            "zoom_crop_size": [240, 240],
            "batch_size": 1,
        },
        "lm": {"lm_lambda": 1.0e-4, "ep_lambda": 100.0},
        "model": {
            "network_class_name": "RNNPose",
            "descriptor_dim": 32,
            "seq_names": [],
            "descriptor_net": {
                "keypoints_detector_2d": {
                    "input_dim": 3,
                    "descriptor_dim": 32,
                    "normalize_output": True,
                },
                "keypoints_detector_3d": dict(kpconv),
                "context_fea_extractor_3d": {
                    **copy.deepcopy(kpconv),
                    "final_feats_dim": 256,
                    "normalize_output": False,
                },
            },
            "motion_net": {
                "iter_count": 4,
                "render_iter_count": 3,
                "optim_iter_count": 1,
                "train_flow_weight": 0.5,
                "train_reproj_weight": 0.0,
                "train_pcalign_weight": 1.0,
                "with_corr_weight": True,
                "online_crop": True,
                "margin_ratio": 0.4,
                "flow_net": "raft",
                # rematerialize the inner-scan backward: -44% peak HBM at
                # B=8 and ~3% faster steps, but measured to DEGRADE
                # learning in a same-seed overfit A/B (BENCHLOG r5 #4) —
                # opt-in memory knob, off by default
                "remat": False,
                "raster": {"max_verts": 2048, "max_faces": 4096, "chunk": 512},
            },
        },
        "loss": {
            "metric_loss": {
                "pos_radius": 0.01,
                "safe_radius": 0.02,
                "pos_margin": 0.1,
                "neg_margin": 1.4,
                "max_points": 256,
                "matchability_radius": 0.06,
                "weight": 0.001,
            }
        },
        "train_config": {
            "optimizer": {
                "adam_optimizer": {
                    "learning_rate": {
                        "one_cycle": {
                            "lr_max": 1.0e-4,
                            "moms": [0.95, 0.85],
                            "div_factor": 10.0,
                            "pct_start": 0.01,
                        }
                    },
                    "amsgrad": False,
                    "weight_decay": 1.0e-4,
                },
                "fixed_weight_decay": True,
            },
            "steps": 200000,
            "steps_per_eval": 10000,
            "grad_clip": 10.0,
            "freeze_patterns": [],
        },
        "train_input_reader": {
            "dataset": {
                "dataset_class_name": "LinemodSynRealDataset",
                "kwargs": {
                    "info_paths": [],
                    "root_paths": [],
                    "model_dir": "",
                    "class_names": [],
                    "voc_root": "",
                    # host preprocess knobs (data/preprocess.PreprocessConfig
                    # + mesh budgets); null = library default.
                    "preprocess": dict(_PREPROCESS_KEYS),
                },
            },
            "batch_size": 1,
            "max_model_points": 20000,
        },
        "eval_input_reader": {
            "dataset": {
                "dataset_class_name": "LinemodSynRealDataset",
                "kwargs": {
                    "info_paths": [],
                    "root_paths": [],
                    "model_dir": "",
                    "class_names": [],
                    "init_pose_type": "POSECNN_LINEMOD",
                    # {type: path} map of detector init-pose files (PoseCNN
                    # pickle / PVNet npy — reference linemod_dataset.py:179-199)
                    "init_pose_paths": None,
                    "blender_to_bop_path": None,
                    "preprocess": dict(_PREPROCESS_KEYS),
                },
            },
            "batch_size": 1,
        },
    }


def _kp_from_dict(d: Dict[str, Any]) -> KPConvConfig:
    return KPConvConfig(
        num_layers=d["num_layers"],
        first_subsampling_dl=d["first_subsampling_dl"],
        conv_radius=d["conv_radius"],
        kp_extent=d["kp_extent"],
        num_kernel_points=d["num_kernel_points"],
        in_features_dim=d["in_features_dim"],
        first_feats_dim=d["first_feats_dim"],
        final_feats_dim=d["final_feats_dim"],
        gnn_feats_dim=d["gnn_feats_dim"],
        influence=d.get("kp_influence", "linear"),
        aggregation=d.get("aggregation_mode", "sum"),
        normalize_output=d.get("normalize_output", True),
    )


def build_model_config(cfg: Dict[str, Any]) -> RNNPoseConfig:
    m = cfg["model"]
    mn = m["motion_net"]
    ml = cfg["loss"]["metric_loss"]
    refiner = RefinerConfig(
        render_iters=mn["render_iter_count"],
        gru_iters=mn["iter_count"],
        optim_iters=mn["optim_iter_count"],
        zoom_crop_size=cfg["basic"]["zoom_crop_size"][0],
        margin_ratio=mn["margin_ratio"],
        with_corr_weight=mn["with_corr_weight"],
        lm_lambda=cfg["lm"]["lm_lambda"],
        ep_lambda=cfg["lm"]["ep_lambda"],
        raster_chunk=mn["raster"]["chunk"],
        remat=mn.get("remat", False),
    )
    return RNNPoseConfig(
        descriptor_dim=m["descriptor_dim"],
        desc_kp=_kp_from_dict(m["descriptor_net"]["keypoints_detector_3d"]),
        ctx_kp=_kp_from_dict(m["descriptor_net"]["context_fea_extractor_3d"]),
        refiner=refiner,
        circle=CircleLossConfig(
            pos_radius=ml["pos_radius"] + 1e-3,
            safe_radius=ml["safe_radius"],
            pos_margin=ml["pos_margin"],
            neg_margin=ml["neg_margin"],
            max_points=ml["max_points"],
            weight=ml["weight"],
        ),
        motion=RefinerLossConfig(
            flow_weight=mn["train_flow_weight"],
            reproj_weight=mn["train_reproj_weight"],
            pcalign_weight=mn["train_pcalign_weight"],
        ),
    )


def build_optimizer_config(cfg: Dict[str, Any]) -> OptimizerConfig:
    tc = cfg["train_config"]
    oc = tc["optimizer"]["adam_optimizer"]
    one = oc["learning_rate"]["one_cycle"]
    return OptimizerConfig(
        lr_max=one["lr_max"],
        moms=tuple(one["moms"]),
        div_factor=one["div_factor"],
        pct_start=one["pct_start"],
        weight_decay=oc["weight_decay"],
        amsgrad=oc.get("amsgrad", False),
        total_steps=tc["steps"],
        grad_clip=tc.get("grad_clip", 10.0),
        freeze_patterns=tuple(tc.get("freeze_patterns", [])),
    )


def build_dataset(cfg: Dict[str, Any], kp_cfg, is_train: bool):
    """`data/linemod.LinemodSynRealDataset` of the train or eval reader
    section. The `preprocess` block maps onto `data/preprocess.
    PreprocessConfig` and the dataset's mesh budgets; null entries keep the
    library defaults."""
    from ..data.linemod import LinemodSynRealDataset
    from ..data.preprocess import PreprocessConfig

    section = "train_input_reader" if is_train else "eval_input_reader"
    dcfg = cfg[section]["dataset"]["kwargs"]
    prep_over = {k: v for k, v in (dcfg.get("preprocess") or {}).items() if v is not None}
    extra: Dict[str, Any] = {}
    for key in ("max_verts", "max_faces", "neighbor_limits"):
        if key in prep_over:
            extra[key] = prep_over.pop(key)
    prep_cfg = dataclasses.replace(PreprocessConfig(), **prep_over)
    if is_train:
        extra["voc_root"] = dcfg.get("voc_root") or None
    else:
        extra["init_pose_type"] = dcfg.get("init_pose_type", "POSECNN_LINEMOD")
        extra["init_pose_paths"] = dcfg.get("init_pose_paths")
        extra["blender_to_bop_path"] = dcfg.get("blender_to_bop_path")
    return LinemodSynRealDataset(
        info_paths=dcfg["info_paths"],
        root_paths=dcfg["root_paths"],
        model_dir=dcfg["model_dir"],
        kp_cfg=kp_cfg,
        is_train=is_train,
        class_names=dcfg.get("class_names") or None,
        prep_cfg=prep_cfg,
        **extra,
    )
