"""Weight bridge from the JAX package's flax parameter tree (port of the
routes of `rnnpose_tpu/models/convert.py`).

`load_jax_params(model, flax_params)` takes the flax tree as nested dicts of
numpy arrays, maps each leaf to its reference torch key
(`hybrid_desc_net.corr_fea_extractor_{2d,3d}.*`,
`ctx_fea_net.context_fea_extractor_3d.*`, `motion_net.image_fea_enc.*`,
`motion_net.cf_net.*`, `motion_net.sigma.0`), converts it by its kind, and
loads the result strictly. Kinds, as in the JAX module: `conv` (flax HWIO
kernel -> OIHW, plus bias), `conv1d` (flax Dense (I, O) -> Conv1d (O, I, 1),
plus bias), `linear_w` (flax Dense kernel (I, O) -> Linear weight (O, I)),
`direct` (as is: KPConv weights and kernel points, sigma).
`flax_paths(model)` names each parameter of the port by its flax path, as
the JAX package's `train/optim.freeze_mask` names it, so one regex freezes
the same tensors in both packages.
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["SUPERPOINT_MAP", "RAFT_ENCODER_MAP", "RAFT_UPDATE_MAP", "REFINER_MAP",
           "TOWER_PREFIXES", "kpconv_tower_map", "routes", "flax_to_state_dict",
           "load_jax_params", "flax_paths", "IGNORED_KEY_PATTERNS",
           "load_reference_state_dict"]

NameMap = Dict[str, Tuple[Tuple[str, ...], str]]

# torch key -> (flax path, kind), relative to each route's roots. Keys of the
# `conv`/`conv1d` kinds are module paths (`.weight`/`.bias` follow); keys of
# the `direct`/`linear_w` kinds are full parameter names.
SUPERPOINT_MAP: NameMap = {
    **{f"conv{i}{ab}": ((f"conv{i}{ab}",), "conv") for i in (1, 2, 3, 4) for ab in "ab"},
    "convPa.0": (("convPa",), "conv"),
    "convPb": (("convPb",), "conv"),
    "convDa": (("convDa",), "conv"),
    "convDb": (("convDb",), "conv"),
    "decode1.1": (("decode1",), "conv"),
    "decode2.1": (("decode2",), "conv"),
    "decode3.1": (("decode3",), "conv"),
}

RAFT_ENCODER_MAP: NameMap = {
    "fnet.conv1": (("fnet", "conv1"), "conv"),
    "fnet.conv2": (("fnet", "conv2"), "conv"),
    **{f"fnet.layer{l}.{b}.{c}": (("fnet", f"layer{l}_{b}", c), "conv")
       for l in (1, 2, 3) for b in (0, 1) for c in ("conv1", "conv2")},
    **{f"fnet.layer{l}.0.downsample.0": (("fnet", f"layer{l}_0", "downsample"), "conv")
       for l in (2, 3)},
}

RAFT_UPDATE_MAP: NameMap = {
    **{f"update_block.encoder.{c}": (("update_block", "encoder", c), "conv")
       for c in ("convc1", "convc2", "convf1", "convf2", "conv")},
    **{f"update_block.gru.conv{g}{i}": (("update_block", "gru", f"conv{g}_{hv}"), "conv")
       for g in "zrq" for i, hv in ((1, "h"), (2, "v"))},
    "update_block.flow_head.conv1": (("update_block", "flow_head", "conv1"), "conv"),
    "update_block.flow_head.conv2": (("update_block", "flow_head", "conv2"), "conv"),
    "update_block.mask.0": (("update_block", "mask1"), "conv"),
    "update_block.mask.2": (("update_block", "mask2"), "conv"),
}

REFINER_MAP: NameMap = {"sigma.0": (("sigma",), "direct")}

TOWER_PREFIXES = ("hybrid_desc_net.corr_fea_extractor_3d.",
                  "ctx_fea_net.context_fea_extractor_3d.")
_TOWER_ROOTS = (("hybrid", "desc3d"), ("ctx", "ctx3d"))


def kpconv_tower_map(num_layers: int = 4) -> NameMap:
    """Name map of one KPConv tower (`models/kpconv_net.KPFCNN`): encoder
    blocks 0 (simple), 1 (resnetb), then (strided, resnetb, resnetb) per
    further layer; decoder unaries at the odd indices, `last_unary` last."""
    m: NameMap = {}

    def kpconv(prefix, flax_name):
        for leaf in ("weights", "kernel_points"):
            m[f"{prefix}.KPConv.{leaf}"] = ((flax_name, "KPConv", leaf), "direct")

    def resblock(prefix, flax_name):
        kpconv(prefix, flax_name)
        for u in ("unary1", "unary2", "unary_shortcut"):
            m[f"{prefix}.{u}.mlp.weight"] = ((flax_name, u, "mlp", "kernel"), "linear_w")

    kpconv("encoder_blocks.0", "enc_simple")
    resblock("encoder_blocks.1", "enc_resnetb_0")
    i = 2
    for layer in range(1, num_layers):
        for name in (f"enc_strided_{layer}", f"enc_resnetb_{layer}a", f"enc_resnetb_{layer}b"):
            resblock(f"encoder_blocks.{i}", name)
            i += 1
    m["bottle"] = (("bottle",), "conv1d")
    m["proj_gnn"] = (("proj_gnn",), "conv1d")
    for j in range(num_layers - 2):
        m[f"decoder_blocks.{2 * j + 1}.mlp.weight"] = ((f"dec_unary_{j}", "mlp", "kernel"),
                                                      "linear_w")
    m[f"decoder_blocks.{2 * num_layers - 3}.mlp.weight"] = (("last_unary", "kernel"), "linear_w")
    return m


def _get(tree, path):
    for p in path:
        if not isinstance(tree, Mapping) or p not in tree:
            return None
        tree = tree[p]
    return tree


def _tower_layers(sub) -> int:
    return 1 + sum(k.startswith("enc_strided_") for k in sub)


def routes(flax_params: Dict[str, Any]):
    """(torch key prefix, name map, flax root) of every route, the towers'
    maps sized by the layers the tree holds."""
    p = flax_params.get("params", flax_params)
    return _routes([_tower_layers(sub) if sub else 4
                    for sub in (_get(p, root) for root in _TOWER_ROOTS)])


def _routes(tower_layers):
    towers = [(prefix, kpconv_tower_map(n), root)
              for prefix, root, n in zip(TOWER_PREFIXES, _TOWER_ROOTS, tower_layers)]
    return [
        ("hybrid_desc_net.corr_fea_extractor_2d.", SUPERPOINT_MAP, ("hybrid", "desc2d")),
        *towers,
        ("motion_net.image_fea_enc.", RAFT_ENCODER_MAP, ("motion", "image_fea_enc")),
        ("motion_net.cf_net.", RAFT_UPDATE_MAP, ("motion", "inner", "cf_step")),
        ("motion_net.", REFINER_MAP, ("motion", "inner")),
    ]


_WEIGHT = {
    "conv": lambda a: np.transpose(a, (3, 2, 0, 1)),
    "conv1d": lambda a: np.transpose(a, (1, 0))[..., None],
}
_LEAF = {
    "direct": lambda a: a,
    "linear_w": lambda a: np.transpose(a, (1, 0)),
}


def flax_to_state_dict(flax_params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Reference-keyed, torch-shaped arrays for every leaf the routes reach."""
    p = flax_params.get("params", flax_params)
    sd: Dict[str, np.ndarray] = {}
    for prefix, name_map, root in routes(flax_params):
        sub = _get(p, root)
        if sub is None:
            continue
        for tkey, (path, kind) in name_map.items():
            node = _get(sub, path)
            if node is None:
                continue
            if kind in _LEAF:
                sd[prefix + tkey] = _LEAF[kind](np.asarray(node))
                continue
            sd[prefix + tkey + ".weight"] = _WEIGHT[kind](np.asarray(node["kernel"]))
            if "bias" in node:
                sd[prefix + tkey + ".bias"] = np.asarray(node["bias"])
    return sd


def load_jax_params(model: nn.Module, flax_params: Dict[str, Any]) -> nn.Module:
    """Load a flax `RNNPose` parameter tree into the port's `RNNPose`,
    strictly: every parameter and buffer of the model is set, from a leaf of
    the right shape. A tree without a KPConv tower at all (a JAX model
    initialised with cached 3D features creates none) leaves that tower of
    the model as it is; a tower that is present must be complete."""
    sd = {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in flax_to_state_dict(flax_params).items()
    }
    p = flax_params.get("params", flax_params)
    own = model.state_dict()
    for prefix, root in zip(TOWER_PREFIXES, _TOWER_ROOTS):
        if _get(p, root) is None:
            sd.update({k: v for k, v in own.items() if k.startswith(prefix)})
    model.load_state_dict(sd, strict=True)
    return model


def flax_paths(model: nn.Module) -> Dict[str, str]:
    """The '/'-joined flax path (`params/hybrid/desc2d/conv1a/kernel`, ...)
    of every parameter of the port's `RNNPose`, keyed by its torch name.
    Raises KeyError naming any parameter no route reaches."""
    cfg = model.cfg
    paths: Dict[str, str] = {}
    for prefix, name_map, root in _routes((cfg.desc_kp.num_layers, cfg.ctx_kp.num_layers)):
        for tkey, (path, kind) in name_map.items():
            base = "/".join(("params",) + root + path)
            if kind in _LEAF:
                paths[prefix + tkey] = base
            else:
                paths[prefix + tkey + ".weight"] = base + "/kernel"
                paths[prefix + tkey + ".bias"] = base + "/bias"
    names = [n for n, _ in model.named_parameters()]
    missing = [n for n in names if n not in paths]
    if missing:
        raise KeyError(f"no flax path for {missing}")
    return {n: paths[n] for n in names}


# Reference checkpoint keys the model has no tensor for (as in the JAX
# package's `models/convert.IGNORED_KEY_PATTERNS`).
IGNORED_KEY_PATTERNS: Tuple[str, ...] = (
    r"(^|\.)epsilon$",          # unused scalar, `descriptor3D.py:40`
    r"(^|\.)global_step$",      # step buffer, `RNNPose.py:84-94`
    r"running_(mean|var)$",
    r"num_batches_tracked$",
)


def load_reference_state_dict(model: nn.Module, path: str) -> nn.Module:
    """Load a reference-layout torch checkpoint (a full-model `.tckpt` state
    dict, optionally under a `state_dict` key) into the port's `RNNPose`,
    strictly, after dropping the keys of `IGNORED_KEY_PATTERNS`."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, Mapping) and "state_dict" in raw:
        raw = raw["state_dict"]
    sd = {k: v for k, v in raw.items()
          if not any(re.search(p, k) for p in IGNORED_KEY_PATTERNS)}
    model.load_state_dict(sd, strict=True)
    return model
