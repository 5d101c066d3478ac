"""Experiment-config I/O with strict merging (port of
`rnnpose_tpu/utils/config_io.py`).

Load a config file, merge a custom config over the defaults with an
intersection check (a key of the custom file that the defaults lack raises:
a typo), and save the resolved config next to the run. A file whose body,
after its leading `#` comment lines, is a JSON object is parsed with `json`
(what `save_cfg` and the fixture writer emit, and YAML readers also read);
`yaml` is imported only for a real YAML file.
"""
from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Dict, Sequence, Union

__all__ = ["read_yaml", "update_dict", "merge_cfg", "save_cfg"]


def read_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    body = "\n".join(line for line in text.splitlines() if not line.lstrip().startswith("#"))
    if body.lstrip().startswith("{"):
        return json.loads(body)
    import yaml

    return yaml.safe_load(text) or {}


def update_dict(base: Dict, custom: Dict, path: str = "") -> Dict:
    """Recursive merge of `custom` into `base`; unknown keys raise
    (reference `update_dict`, `config_io.py:40-66`)."""
    out = copy.deepcopy(base)
    for k, v in custom.items():
        here = f"{path}.{k}" if path else str(k)
        if k not in base:
            raise KeyError(f"config key '{here}' not present in the defaults — typo?")
        if isinstance(v, dict) and isinstance(base[k], dict):
            out[k] = update_dict(base[k], v, here)
        else:
            out[k] = copy.deepcopy(v)
    return out


def merge_cfg(paths: Union[str, Sequence[str]], defaults: Dict[str, Any] | None = None
              ) -> Dict[str, Any]:
    """Load one or more YAMLs; later files merge over earlier ones. With
    `defaults` given, every file must be a subset of the default schema."""
    if isinstance(paths, str):
        paths = [paths]
    cfg = copy.deepcopy(defaults) if defaults is not None else {}
    for p in paths:
        custom = read_yaml(p)
        cfg = custom if defaults is None and not cfg else update_dict(cfg, custom)
    return cfg


def save_cfg(cfg: Dict[str, Any], out_path: str, source: str = ""):
    """Save the resolved config as JSON under a `#` comment header (valid
    YAML too)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    header = (f"# resolved config, saved {time.strftime('%Y-%m-%d %H:%M:%S')}\n"
              + (f"# source: {source}\n" if source else ""))
    with open(out_path, "w") as f:
        f.write(header)
        json.dump(cfg, f, indent=2)
        f.write("\n")
