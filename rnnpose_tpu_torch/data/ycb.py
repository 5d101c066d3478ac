"""BOP-YCB class tables (port of `rnnpose_tpu/data/ycb.py`)."""
from __future__ import annotations

__all__ = ["BOP_YCB_CLASSES", "YCB_SYMMETRIC", "bop_ycb_class2idx", "bop_ycb_idx2class"]

BOP_YCB_CLASSES = (
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser", "024_bowl",
    "025_mug", "035_power_drill", "036_wood_block", "037_scissors",
    "040_large_marker", "051_large_clamp", "052_extra_large_clamp",
    "061_foam_brick",
)

bop_ycb_class2idx = {c: i + 1 for i, c in enumerate(BOP_YCB_CLASSES)}
bop_ycb_idx2class = {i + 1: c for i, c in enumerate(BOP_YCB_CLASSES)}

# YCB-Video symmetric objects (ADD-S metric).
YCB_SYMMETRIC = (
    "024_bowl", "036_wood_block", "051_large_clamp",
    "052_extra_large_clamp", "061_foam_brick",
)
