"""RGB augmentation of a training sample, frozen here: a copy of
`rnnpose_tpu_torch/data/transforms.py` (numpy).

Train: a Gaussian blur with probability 0.5 (kernel size drawn from
{3, 5, 7, 9}) and a colour jitter (brightness 0.1, contrast 0.1, saturation
0.05, hue 0.05); eval: identity. The blur is `cv2.GaussianBlur(img, (k, k),
0)` in numpy: OpenCV's fixed kernels for sigma 0 at these sizes, applied
separably with BORDER_REFLECT_101.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["make_transforms", "random_blur", "color_jitter", "gaussian_kernel",
           "gaussian_blur"]

# OpenCV's kernels for sigma <= 0 at sizes 3, 5, 7 and 9.
_SMALL_GAUSSIAN = {
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
    9: (0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375, 0.19921875, 0.1171875,
        0.05078125, 0.015625),
}


def gaussian_kernel(k: int) -> np.ndarray:
    """`cv2.getGaussianKernel(k, 0, CV_32F)` for k in {3, 5, 7, 9}, as a
    (k,) f32 array."""
    return np.asarray(_SMALL_GAUSSIAN[k], np.float32)


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """Separable Gaussian blur of an (H, W[, C]) f32 image with a k x k
    kernel of sigma 0, borders reflected without the edge pixel."""
    kern = gaussian_kernel(k)
    r = k // 2
    out = img.astype(np.float32)
    for axis in (1, 0):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (r, r)
        padded = np.pad(out, pad, mode="reflect")
        n = out.shape[axis]
        acc = np.zeros_like(out)
        for i in range(k):
            acc += kern[i] * np.take(padded, np.arange(i, i + n), axis=axis)
        out = acc
    return out.astype(img.dtype)


def random_blur(img: np.ndarray, rs: np.random.RandomState, p: float = 0.5) -> np.ndarray:
    """Gaussian blur with kernel size drawn from {3, 5, 7, 9}, w.p. p."""
    if rs.rand() >= p:
        return img
    k = int(rs.choice([3, 5, 7, 9]))
    return gaussian_blur(img, k)


def color_jitter(
    img: np.ndarray,
    rs: np.random.RandomState,
    brightness: float = 0.1,
    contrast: float = 0.1,
    saturation: float = 0.05,
    hue: float = 0.05,
) -> np.ndarray:
    """Torchvision-style jitter on a float [0, 1] HWC image."""
    out = img.astype(np.float32)
    out = out * rs.uniform(1 - brightness, 1 + brightness)
    mean = out.mean()
    out = (out - mean) * rs.uniform(1 - contrast, 1 + contrast) + mean
    gray = out.mean(axis=-1, keepdims=True)
    out = gray + (out - gray) * rs.uniform(1 - saturation, 1 + saturation)
    # A cheap hue shift: rotate the channels toward each other.
    h = rs.uniform(-hue, hue)
    out = out + h * (np.roll(out, 1, axis=-1) - out)
    return np.clip(out, 0.0, 1.0)


def make_transforms(is_train: bool, seed: int = 0) -> Callable[..., np.ndarray]:
    """The callable `(img, rs=None)`. With `rs=None` it draws from a stream
    seeded at construction; an explicit per-sample `rs` makes the
    augmentation a pure function of it."""
    rs_default = np.random.RandomState(seed)
    if not is_train:
        return lambda img, rs=None: img

    def apply(img, rs=None):
        rs = rs_default if rs is None else rs
        img = random_blur(img, rs)
        img = color_jitter(img, rs)
        return img

    return apply
