"""Checkpoints with manifest semantics (port of
`rnnpose_tpu/train/checkpoint.py`).

A `checkpoints.json` manifest names the latest checkpoint and all kept
ones; checkpoints are step-suffixed (`rnnpose-<step>`), the oldest pruned
beyond `max_to_keep`, and every write is atomic (temporary file, then
rename). A checkpoint is one `torch.save` file of {model, optimizer, step}
(the JAX package writes an orbax directory of {params, opt_state, step}).

Under a process group `save_checkpoint` is collective, as orbax's save is:
rank 0 writes, then every rank waits at a barrier, so no rank reads (a
`--resume`) or prunes a partial file; `model_dir` is storage every rank
sees, and every rank restores from it.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..parallel.mesh import barrier, process_index

__all__ = [
    "save_checkpoint",
    "latest_checkpoint",
    "restore_checkpoint",
    "try_restore_latest",
]

_MANIFEST = "checkpoints.json"


def _manifest_path(model_dir: str) -> str:
    return os.path.join(model_dir, _MANIFEST)


def _read_manifest(model_dir: str) -> Dict[str, Any]:
    p = _manifest_path(model_dir)
    if not os.path.exists(p):
        return {"latest_ckpt": None, "all_ckpts": []}
    with open(p) as f:
        return json.load(f)


def _write_manifest(model_dir: str, m: Dict[str, Any]):
    tmp = _manifest_path(model_dir) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(m, f, indent=2)
    os.replace(tmp, _manifest_path(model_dir))


def save_checkpoint(model_dir: str, state: Dict[str, Any], step: int,
                    name: str = "rnnpose", max_to_keep: int = 8) -> str:
    """Write `{name}-{step}` under model_dir (`state` plus the step), update
    the manifest and prune the oldest beyond `max_to_keep`. Returns the
    checkpoint's path. Every rank of a process group calls it; rank 0
    writes."""
    ckpt_name = f"{name}-{step}"
    path = os.path.abspath(os.path.join(model_dir, ckpt_name))
    if process_index() == 0:
        os.makedirs(model_dir, exist_ok=True)
        torch.save(dict(state, step=step), path + ".tmp")
        os.replace(path + ".tmp", path)

        m = _read_manifest(model_dir)
        m["all_ckpts"] = [c for c in m.get("all_ckpts", []) if c != ckpt_name]
        m["all_ckpts"].append(ckpt_name)
        m["latest_ckpt"] = ckpt_name
        while len(m["all_ckpts"]) > max_to_keep:
            victim = os.path.join(model_dir, m["all_ckpts"].pop(0))
            if os.path.isfile(victim):
                os.remove(victim)
        _write_manifest(model_dir, m)
    barrier()
    return path


def latest_checkpoint(model_dir: str, name: str = "rnnpose") -> Optional[str]:
    """Path of the newest checkpoint per the manifest, or None."""
    m = _read_manifest(model_dir)
    latest = m.get("latest_ckpt")
    if latest is None or not latest.startswith(name):
        cands = [c for c in m.get("all_ckpts", []) if c.startswith(name)]
        if not cands:
            return None
        latest = cands[-1]
    path = os.path.join(model_dir, latest)
    return os.path.abspath(path) if os.path.isfile(path) else None


def restore_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
    """The saved dict ({model, optimizer, step}), tensors on `map_location`
    (default: where they were saved)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def try_restore_latest(model_dir: str, map_location=None, name: str = "rnnpose"):
    """Restore the newest checkpoint if there is one, else None (reference
    `try_restore_latest_checkpoints`, `torchplus/train/checkpoint.py:149-218`)."""
    path = latest_checkpoint(model_dir, name)
    return None if path is None else restore_checkpoint(path, map_location)
