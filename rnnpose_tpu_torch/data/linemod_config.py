"""LINEMOD constants (port of `rnnpose_tpu/data/linemod_config.py`):
object diameters, class tables and the cameras."""
from __future__ import annotations

import numpy as np

__all__ = ["DIAMETERS_CM", "LINEMOD_CLASSES", "CLASS_TO_IDX", "LINEMOD_K", "BLENDER_K",
           "diameter_m"]

# Object diameters in cm.
DIAMETERS_CM = {
    "ape": 9.74298,
    "benchvise": 28.6908,
    "bowl": 17.1185,
    "cam": 17.1593,
    "can": 19.3416,
    "cat": 15.2633,
    "cup": 12.5961,
    "driller": 25.9425,
    "duck": 10.7131,
    "eggbox": 17.6364,
    "glue": 16.4857,
    "holepuncher": 14.8204,
    "iron": 30.3153,
    "lamp": 28.5155,
    "phone": 20.8394,
}

LINEMOD_CLASSES = (
    "ape", "benchvise", "cam", "can", "cat", "driller", "duck",
    "eggbox", "glue", "holepuncher", "iron", "lamp", "phone",
)

# The DeepIM LM6d class index table ('bowl' (3) and 'cup' (7) are excluded).
CLASS_TO_IDX = {
    "ape": 1, "benchvise": 2, "camera": 4, "cam": 4, "can": 5, "cat": 6,
    "driller": 8, "duck": 9, "eggbox": 10, "glue": 11, "holepuncher": 12,
    "iron": 13, "lamp": 14, "phone": 15,
}

# The LINEMOD camera.
LINEMOD_K = np.array(
    [
        [572.4114, 0.0, 325.2611],
        [0.0, 573.57043, 242.04899],
        [0.0, 0.0, 1.0],
    ],
    np.float32,
)

BLENDER_K = np.array(
    [[700.0, 0.0, 320.0], [0.0, 700.0, 240.0], [0.0, 0.0, 1.0]], np.float32
)


def diameter_m(class_name: str) -> float:
    """Diameter in meters (models are in meters in the BOP convention)."""
    return DIAMETERS_CM[class_name] / 100.0
