"""PNG in numpy and zlib, frozen here: a copy of the PNG half of
`rnnpose_tpu_torch/data/imageio.py` (read: 8-bit gray, RGB and RGBA and
16-bit gray, non-interlaced, any of the five row filters; write: the bytes
`cv2.imwrite` writes, the Sub filter on every row, zlib level 1 with the
run-length strategy). The benchmark writes its LINEMOD-format frames with
it (`benchmark/gen_linemod.py`) and the reference's sample path reads them
back (`reference/data/linemod.py`). No JPEG: the benchmark writes none."""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_png", "read_rgb", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in a {kind!r} chunk")
        yield kind, body
        pos += 12 + n


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Filters None, Sub and Up, row by row."""
    h, stride = raw.shape
    out = np.empty_like(raw)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        row, t = raw[y], ftype[y]
        if t == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif t == 2:
            row = row + prev
        out[y] = prev = row
    return out


def _unfilter_diagonals(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """All five filters, one anti-diagonal of pixels at a time (every byte of
    a diagonal depends only on the two before it)."""
    h, stride = raw.shape
    w = stride // bpp
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)
    src = raw.reshape(h, w, bpp).astype(np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        t = ftype[ys][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, _paeth(a, b, c), 0))))
        rec[ys + 1, xs + 1] = (src[ys, xs] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8).reshape(h, stride)


def read_png(path: str) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 / uint16 array of a PNG file, as stored."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or interlace != 0 or depth not in (8, 16) or (
            depth == 16 and ctype != 0):
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    try:
        flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as err:
        raise ValueError(f"{path}: corrupt image data ({err})") from err
    if flat.size != h * (stride + 1):
        raise ValueError(f"{path}: image data holds {flat.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = flat.reshape(h, stride + 1)
    ftype, raw = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(ftype.max())}")
    if (ftype >= 3).any():
        pix = _unfilter_diagonals(raw, ftype, bpp)
    else:
        pix = _unfilter_rows(raw, ftype, bpp)
    if depth == 16:
        pix = pix.view(">u2").astype(np.uint16)
    return pix.reshape(h, w) if ch == 1 else pix.reshape(h, w, ch)


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an 8-bit PNG: gray repeated, alpha dropped."""
    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a colour image must be 8-bit, got {img.dtype}")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _zlib_header(window_bits: int) -> bytes:
    """The 2-byte zlib header of a level-1 run-length stream (FLEVEL 0)."""
    cmf = ((window_bits - 8) << 4) | 8
    return bytes([cmf, 31 - (cmf * 256) % 31])


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8/uint16 gray, or (H, W, 3|4) uint8 RGB(A)."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        ctype, depth = 0, img.dtype.itemsize * 8
    elif img.ndim == 3 and img.shape[-1] in (3, 4) and img.dtype == np.uint8:
        ctype, depth = (2 if img.shape[-1] == 3 else 6), 8
    else:
        raise ValueError(f"{path}: cannot write a {img.dtype} array of shape {img.shape}")
    h, w = img.shape[:2]
    pix = img.astype(">u2") if depth == 16 else img
    rows = np.ascontiguousarray(pix).view(np.uint8).reshape(h, -1)
    bpp = rows.shape[1] // w
    ftype = 1 if w > 1 else 0  # libpng drops Sub for one-pixel rows
    if ftype:
        rows = rows.copy()
        rows[:, bpp:] -= np.ascontiguousarray(pix).view(np.uint8).reshape(h, -1)[:, :-bpp]
    data = np.concatenate([np.full((h, 1), ftype, np.uint8), rows], axis=1).tobytes()
    # The run-length strategy matches at distance 1 only: the stream does
    # not depend on the window, which the header names.
    window_bits = min(15, max(8, (len(data) - 1).bit_length()))
    packer = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
    stream = packer.compress(data) + packer.flush()
    stream = _zlib_header(window_bits) + stream[2:]
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)))
        for i in range(0, len(stream), 8192):
            f.write(_chunk(b"IDAT", stream[i:i + 8192]))
        f.write(_chunk(b"IEND", b""))
