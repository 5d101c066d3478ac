"""The model of a configuration file, as the program's classes or the
reference's.

`side(name)` is ("program" or "reference") -> the pair of modules that
define the model's classes (`models.rnnpose`, `models.kpconv_net`). The
program is imported only when asked for, so the reference and the tests
of the reference never load it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

import torch

__all__ = ["side", "model_config", "build_model", "load_weights"]

_MODULES = {"program": "rnnpose_tpu_torch", "reference": "benchmark.reference"}


def side(name: str):
    pkg = _MODULES[name]
    return (importlib.import_module(f"{pkg}.models.rnnpose"),
            importlib.import_module(f"{pkg}.models.kpconv_net"))


def model_config(mods, cfg: dict, f32: bool = False, render_iters: Optional[int] = None):
    """`mods`' RNNPoseConfig for configuration file `cfg`: its towers,
    refiner and precision, and the reference-exact preset where
    `cfg["parity"]`. `f32` turns mixed precision off (the reference);
    `render_iters` overrides the refiner's render iterations."""
    rn, kp = mods
    tower = dict(num_layers=cfg["kp_layers"], first_subsampling_dl=cfg["kp_dl"],
                 first_feats_dim=cfg["kp_first_feats_dim"],
                 gnn_feats_dim=cfg["kp_gnn_feats_dim"])
    refiner = rn.RefinerConfig(
        render_iters=cfg["render_iters"] if render_iters is None else render_iters,
        gru_iters=cfg["gru_iters"], optim_iters=cfg["optim_iters"],
        zoom_crop_size=cfg["zoom_crop_size"], corr_levels=cfg["corr_levels"],
        corr_radius=cfg["corr_radius"], hidden_dim=cfg["hidden_dim"],
        context_dim=cfg["context_dim"], raster_chunk=cfg["raster_chunk"],
        mixed_precision=cfg["mixed_precision"])
    out = rn.RNNPoseConfig(
        descriptor_dim=cfg["descriptor_dim"], ctx_dim=cfg["ctx_dim"],
        desc_kp=kp.KPConvConfig(final_feats_dim=cfg["descriptor_dim"], **tower),
        ctx_kp=kp.KPConvConfig(final_feats_dim=cfg["ctx_dim"], normalize_output=False, **tower),
        refiner=refiner)
    if cfg["parity"]:
        out = rn.apply_parity_preset(out)
    if f32:
        out = dataclasses.replace(
            out, refiner=dataclasses.replace(out.refiner, mixed_precision=False))
    return out


def build_model(mods, cfg: dict, device, **kw) -> torch.nn.Module:
    rn, _ = mods
    return rn.RNNPose(model_config(mods, cfg, **kw)).to(device)


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into every parameter of `model`, by name."""
    params = dict(model.named_parameters())
    if params.keys() != weights.keys():
        raise KeyError(f"parameters differ: {sorted(params.keys() ^ weights.keys())[:5]}")
    for name, p in params.items():
        p.copy_(weights[name])
