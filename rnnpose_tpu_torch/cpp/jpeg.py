"""ctypes bindings of the port's JPEG decoder (`csrc/jpeg_decode.cpp`) and
encoder (`csrc/jpeg_encode.cpp`).

The decoder computes what libjpeg-turbo computes by default (the ISLOW
IDCT, fancy upsampling, the fixed-point YCbCr -> RGB tables), so its pixels
equal `cv2.imread`'s. The encoder writes what `cv2.imwrite(".jpg")` writes
by default (baseline, quality 95, 4:2:0, the ISLOW FDCT, the standard
Huffman tables, a JFIF header). Each is built with g++ on first use into
the git-ignored `rnnpose_tpu_torch/_build/` (`native.build_library`: a
temporary file renamed into place). There is no fallback: if g++ is missing
or fails, or a library does not load, `decode`/`encode` raise RuntimeError
saying so.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import native

__all__ = ["SOURCE", "ENCODE_SOURCE", "build", "build_encoder", "decode", "encode"]

SOURCE = native._PKG / "csrc" / "jpeg_decode.cpp"
ENCODE_SOURCE = native._PKG / "csrc" / "jpeg_encode.cpp"
_ERRLEN = 256
_lock = threading.Lock()
_lib = None
_enc = None


def build():
    """Compile the decoder if it is not built yet; return its path."""
    return native.build_library(SOURCE, "jpeg_decode")


def build_encoder():
    """Compile the encoder if it is not built yet; return its path."""
    return native.build_library(ENCODE_SOURCE, "jpeg_encode")


def _cdll(path, what):
    try:
        return ctypes.CDLL(str(path))
    except OSError as err:  # not a missing image: callers must not skip it
        raise RuntimeError(f"the JPEG {what} {path.name} did not load: {err}") from err


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = _cdll(build(), "decoder")
            u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
            lib.rnnpose_jpeg_info.restype = ctypes.c_int
            lib.rnnpose_jpeg_info.argtypes = [u8p, ctypes.c_int64, ip, ip, ip,
                                              ctypes.c_char_p, ctypes.c_int]
            lib.rnnpose_jpeg_decode.restype = ctypes.c_int
            lib.rnnpose_jpeg_decode.argtypes = [u8p, ctypes.c_int64, u8p,
                                                ctypes.c_char_p, ctypes.c_int]
            _lib = lib
        return _lib


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) gray or (H, W, 3) RGB uint8 pixels of a JPEG file's bytes.
    Raises ValueError naming `name` on an unsupported, corrupt or truncated
    stream."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(_ERRLEN)
    w, h, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.rnnpose_jpeg_info(ptr, len(buf), ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(ch), err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, np.uint8)
    if lib.rnnpose_jpeg_decode(ptr, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                               err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    return out


def _load_encoder():
    global _enc
    with _lock:
        if _enc is None:
            lib = _cdll(build_encoder(), "encoder")
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.rnnpose_jpeg_encode.restype = ctypes.c_int
            lib.rnnpose_jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, u8p, ctypes.c_int64,
                                                ctypes.POINTER(ctypes.c_int64),
                                                ctypes.c_char_p, ctypes.c_int]
            _enc = lib
        return _enc


def encode(img: np.ndarray, quality: int = 95) -> bytes:
    """The JPEG file's bytes of an (H, W) gray or (H, W, 3) RGB uint8 image:
    `cv2.imencode(".jpg", img[..., ::-1])`'s at the same quality."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode takes (H, W) or (H, W, 3) uint8, got {img.dtype} {img.shape}")
    lib = _load_encoder()
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    # Worst case per 8x8 block well under 8 bytes per sample, with stuffing.
    out = np.empty(8 * h * w * ch + 4096, np.uint8)
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERRLEN)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if lib.rnnpose_jpeg_encode(img.ctypes.data_as(u8p), w, h, ch, int(quality),
                               out.ctypes.data_as(u8p), len(out), ctypes.byref(n), err,
                               _ERRLEN):
        raise ValueError(f"JPEG encode: {err.value.decode(errors='replace')}")
    return out[:n.value].tobytes()
