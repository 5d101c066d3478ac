"""Host-side data: the LINEMOD dataset (PNG codec, preprocessing,
augmentation, prefetch), pose sampling, the KPConv pyramid and the synthetic
scene."""
