"""Per-object experiment configs (port of `rnnpose_tpu/tools/make_configs.py`).

Writes one config per LINEMOD class that overrides only the class-dependent
fields of the default schema (`config/defaults.py`): the class name, the
train and eval `.info` files and roots, and the eval's init-pose source
(PVNet's for Occlusion LINEMOD). The files carry the JAX tool's `.yml`
names and hold JSON, which `utils/config_io.read_yaml` reads and any YAML
reader reads too (no PyYAML needed).

Usage:
  python -m rnnpose_tpu_torch.tools.make_configs --out_dir config/linemod \\
      --info_root /data/infos --data_root /data/LM6d [--occ] [--classes cat ape]
"""
from __future__ import annotations

import argparse
import json
import os

from ..data.linemod_config import LINEMOD_CLASSES


def class_config(cls: str, info_root: str, data_root: str, occ: bool = False):
    suffix = "occ" if occ else "std"
    return {
        "model": {"seq_names": [cls]},
        "train_input_reader": {
            "dataset": {
                "kwargs": {
                    "info_paths": [
                        os.path.join(info_root, f"{cls}_train_real.info"),
                        os.path.join(info_root, f"{cls}_train_syn.info"),
                    ],
                    "root_paths": [data_root, data_root],
                    "model_dir": os.path.join(data_root, "models"),
                    "class_names": [cls],
                }
            }
        },
        "eval_input_reader": {
            "dataset": {
                "kwargs": {
                    "info_paths": [os.path.join(info_root, f"{cls}_test_{suffix}.info")],
                    "root_paths": [data_root],
                    "model_dir": os.path.join(data_root, "models"),
                    "class_names": [cls],
                    # Occlusion LINEMOD evaluates from PVNet inits.
                    "init_pose_type": "PVNET_LINEMOD_OCC" if occ else "POSECNN_LINEMOD",
                }
            }
        },
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="per-class LINEMOD configs")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--info_root", default="EXPDATA/infos")
    p.add_argument("--data_root", default="EXPDATA/LM6d_converted")
    p.add_argument("--occ", action="store_true")
    p.add_argument("--classes", nargs="*", default=None)
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    names = []
    for cls in args.classes or LINEMOD_CLASSES:
        name = f"{cls}_fw0.5{'_occ' if args.occ else ''}.yml"
        with open(os.path.join(args.out_dir, name), "w") as f:
            json.dump(class_config(cls, args.info_root, args.data_root, args.occ), f, indent=1)
            f.write("\n")
        print(f"wrote {name}")
        names.append(name)
    return names


if __name__ == "__main__":
    main()
