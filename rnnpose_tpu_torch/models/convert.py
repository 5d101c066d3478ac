"""Weight bridge from the JAX package's flax parameter tree (port of the
routes of `rnnpose_tpu/models/convert.py` that this package owns).

`load_jax_params(model, flax_params)` takes the flax tree as nested dicts of
numpy arrays, maps each leaf to the reference torch key
(`hybrid_desc_net.corr_fea_extractor_2d.*`, `motion_net.image_fea_enc.*`,
`motion_net.cf_net.*`, `motion_net.sigma.0`), converts flax HWIO conv
kernels to OIHW, and loads the result strictly.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["SUPERPOINT_MAP", "RAFT_ENCODER_MAP", "RAFT_UPDATE_MAP",
           "REFINER_MAP", "slice_routes", "flax_to_state_dict", "load_jax_params"]

# torch module path -> flax module path, relative to each route's roots.
SUPERPOINT_MAP: Dict[str, Tuple[str, ...]] = {
    **{f"conv{i}{ab}": (f"conv{i}{ab}",) for i in (1, 2, 3, 4) for ab in "ab"},
    "convPa.0": ("convPa",),
    "convPb": ("convPb",),
    "convDa": ("convDa",),
    "convDb": ("convDb",),
    "decode1.1": ("decode1",),
    "decode2.1": ("decode2",),
    "decode3.1": ("decode3",),
}

RAFT_ENCODER_MAP: Dict[str, Tuple[str, ...]] = {
    "fnet.conv1": ("fnet", "conv1"),
    "fnet.conv2": ("fnet", "conv2"),
    **{f"fnet.layer{l}.{b}.{c}": ("fnet", f"layer{l}_{b}", c)
       for l in (1, 2, 3) for b in (0, 1) for c in ("conv1", "conv2")},
    **{f"fnet.layer{l}.0.downsample.0": ("fnet", f"layer{l}_0", "downsample")
       for l in (2, 3)},
}

RAFT_UPDATE_MAP: Dict[str, Tuple[str, ...]] = {
    **{f"update_block.encoder.{c}": ("update_block", "encoder", c)
       for c in ("convc1", "convc2", "convf1", "convf2", "conv")},
    **{f"update_block.gru.conv{g}{i}": ("update_block", "gru", f"conv{g}_{hv}")
       for g in "zrq" for i, hv in ((1, "h"), (2, "v"))},
    "update_block.flow_head.conv1": ("update_block", "flow_head", "conv1"),
    "update_block.flow_head.conv2": ("update_block", "flow_head", "conv2"),
    "update_block.mask.0": ("update_block", "mask1"),
    "update_block.mask.2": ("update_block", "mask2"),
}

# Direct (non-conv) leaves: torch key -> flax leaf path.
REFINER_MAP: Dict[str, Tuple[str, ...]] = {"sigma.0": ("sigma",)}


def slice_routes():
    """(torch key prefix, conv map, direct map, flax root) of every route
    this package owns."""
    return [
        ("hybrid_desc_net.corr_fea_extractor_2d.", SUPERPOINT_MAP, {},
         ("hybrid", "desc2d")),
        ("motion_net.image_fea_enc.", RAFT_ENCODER_MAP, {},
         ("motion", "image_fea_enc")),
        ("motion_net.cf_net.", RAFT_UPDATE_MAP, {},
         ("motion", "inner", "cf_step")),
        ("motion_net.", {}, REFINER_MAP, ("motion", "inner")),
    ]


def _get(tree, path):
    for p in path:
        if not isinstance(tree, Mapping) or p not in tree:
            return None
        tree = tree[p]
    return tree


def flax_to_state_dict(flax_params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Reference-keyed, torch-shaped arrays for every leaf of the routes."""
    p = flax_params.get("params", flax_params)
    sd: Dict[str, np.ndarray] = {}
    for prefix, conv_map, direct_map, root in slice_routes():
        sub = _get(p, root)
        if sub is None:
            continue
        for tkey, path in conv_map.items():
            node = _get(sub, path)
            if node is None:
                continue
            sd[prefix + tkey + ".weight"] = np.transpose(
                np.asarray(node["kernel"]), (3, 2, 0, 1))
            if "bias" in node:
                sd[prefix + tkey + ".bias"] = np.asarray(node["bias"])
        for tkey, path in direct_map.items():
            leaf = _get(sub, path)
            if leaf is not None:
                sd[prefix + tkey] = np.asarray(leaf)
    return sd


def load_jax_params(model: nn.Module, flax_params: Dict[str, Any]) -> nn.Module:
    """Load a flax parameter tree into the port's `RNNPose` (strict: every
    parameter of the model is set and every converted leaf is used)."""
    sd = {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in flax_to_state_dict(flax_params).items()
    }
    model.load_state_dict(sd, strict=True)
    return model
