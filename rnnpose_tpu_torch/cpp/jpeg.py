"""ctypes binding of the port's JPEG decoder (`csrc/jpeg_decode.cpp`).

The decoder computes what libjpeg-turbo computes by default (the ISLOW
IDCT, fancy upsampling, the fixed-point YCbCr -> RGB tables), so its pixels
equal `cv2.imread`'s. It is built with g++ on first use into the
git-ignored `rnnpose_tpu_torch/_build/` (`native.build_library`: a temporary
file renamed into place). There is no fallback: if g++ is missing or fails,
or the library does not load, `decode` raises RuntimeError saying so.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import native

__all__ = ["SOURCE", "build", "decode"]

SOURCE = native._PKG / "csrc" / "jpeg_decode.cpp"
_ERRLEN = 256
_lock = threading.Lock()
_lib = None


def build():
    """Compile the decoder if it is not built yet; return its path."""
    return native.build_library(SOURCE, "jpeg_decode")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as err:  # not a missing image: callers must not skip it
                raise RuntimeError(f"the JPEG decoder {path.name} did not load: {err}") from err
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
