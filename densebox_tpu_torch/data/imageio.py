"""Image files and encoded image bodies to RGB uint8 arrays.

The JAX package reads images with ``cv2.imread`` / ``cv2.imdecode``
(``IMREAD_COLOR``, then BGR -> RGB). Where ``cv2`` imports, these functions
call it in the same way. Where it does not (the port's card machine has no
OpenCV), PNG is decoded here with numpy and the standard library's ``zlib``,
to the same pixels ``cv2.IMREAD_COLOR`` gives: 1-, 2-, 4- and 8-bit gray and
palette, 8-bit gray+alpha, RGB and RGBA, non-interlaced, all five row
filters; alpha is dropped (not composited) and gray is repeated into three
channels. Any other file (JPEG, a 16-bit or interlaced PNG, ...) raises
``ImportError`` naming cv2 and the file. So does ``resize_area``, the
``INTER_AREA`` downscale, which has no counterpart here.

A file or body that is no image at all, or a corrupt PNG, gives None, as
``cv2`` does.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# formats cv2 reads and this module does not: (leading bytes, name)
_OTHER_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                  (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"))
# PNG colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _needs_cv2(name: str, what: str) -> ImportError:
    return ImportError(
        f"{name}: reading {what} needs OpenCV (cv2), which is not installed; "
        "without it only PNG files (1 to 8 bits per sample, not interlaced) "
        "are read")


def imread(path: str) -> Optional[np.ndarray]:
    """The image file at ``path`` as RGB uint8 (H, W, 3), or None if it
    cannot be read or is no image (as ``cv2.imread``)."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return _decode(data, path)


def imdecode(buf) -> Optional[np.ndarray]:
    """An encoded image (bytes or a uint8 array) as RGB uint8 (H, W, 3), or
    None if it is no image (as ``cv2.imdecode``)."""
    data = bytes(buf)
    if not data:
        return None
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return _decode(data, "the request body")


def resize_area(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size_wh, interpolation=cv2.INTER_AREA)``; raises
    ImportError without cv2."""
    cv2 = _cv2()
    if cv2 is None:
        h, w = img.shape[:2]
        raise ImportError(
            f"downscaling a {h}x{w} image to {size_wh[1]}x{size_wh[0]} "
            "(INTER_AREA) needs OpenCV (cv2), which is not installed; give "
            "images no larger than the canvas")
    return cv2.resize(img, size_wh, interpolation=cv2.INTER_AREA)


def _decode(data: bytes, name: str) -> Optional[np.ndarray]:
    if data.startswith(_PNG_SIGNATURE):
        return _decode_png(data, name)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        raise _needs_cv2(name, "a WebP image")
    for magic, kind in _OTHER_FORMATS:
        if data.startswith(magic):
            raise _needs_cv2(name, f"a {kind} image")
    return None


class _Corrupt(Exception):
    """A PNG that cv2 would refuse too (the callers get None)."""


def _chunks(data: bytes):
    pos = len(_PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise _Corrupt("truncated chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        # a corrupt critical chunk (upper-case first letter) is an error; an
        # ancillary one is skipped, as libpng does
        if zlib.crc32(kind + body) != crc:
            if kind[:1].isupper():
                raise _Corrupt(f"CRC of {kind!r}")
            pos += 12 + length
            continue
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise _Corrupt("no IEND")


def _decode_png(data: bytes, name: str) -> Optional[np.ndarray]:
    try:
        return _png_pixels(data, name)
    except (_Corrupt, zlib.error, ValueError, IndexError, struct.error):
        return None


def _png_pixels(data: bytes, name: str) -> np.ndarray:
    header = palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise _Corrupt("no IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or width == 0 or height == 0:
        raise _Corrupt(f"colour type {ctype}, {width}x{height}")
    if depth == 16:
        raise _needs_cv2(name, "a 16-bit PNG")
    if interlace:
        raise _needs_cv2(name, "an interlaced PNG")
    if depth not in (1, 2, 4, 8) or (depth != 8 and ctype not in (0, 3)):
        raise _Corrupt(f"bit depth {depth} with colour type {ctype}")
    channels = _CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise _Corrupt("too little image data")
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)]
    rows = unfilter(rows.reshape(height, stride + 1),
                    max(1, channels * depth // 8))
    if depth < 8:                          # gray or palette indices, MSB first
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (bits * weights).sum(-1, dtype=np.uint8)[:, :width]
        if ctype == 0:                     # libpng's expand_gray_1_2_4_to_8
            rows = rows * np.uint8(255 // ((1 << depth) - 1))
    pix = rows.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise _Corrupt("palette image without PLTE")
        return palette[pix[..., 0]]
    if ctype in (0, 4):                    # gray (+ alpha): repeat, drop alpha
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters: ``rows`` (H, 1 + stride) uint8, the
    filter type first in each row; ``bpp`` bytes per complete pixel (at
    least 1). Returns the (H, stride) uint8 scanlines. None, Sub and Up
    rows are numpy operations; Average and Paeth rows depend on their own
    decoded left neighbour and are walked byte by byte."""
    ftype = rows[:, 0]
    out = rows[:, 1:].copy()
    if not ftype.any():
        return out
    if int(ftype.max()) > 4:
        raise _Corrupt(f"filter type {int(ftype.max())}")
    stride = out.shape[1]
    prev = np.zeros(stride, np.uint8)
    for y in range(out.shape[0]):
        f, line = int(ftype[y]), out[y]
        if f == 1:
            line[:] = line.reshape(-1, bpp).cumsum(0, dtype=np.uint8).ravel()
        elif f == 2:
            line += prev
        elif f == 3:
            cur, up = line.tolist(), prev.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
            line[:] = cur
        elif f == 4:
            cur, up = line.tolist(), prev.tolist()
            for i in range(stride):
                b = up[i]
                if i >= bpp:
                    a, c = cur[i - bpp], up[i - bpp]
                else:
                    a = c = 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            line[:] = cur
        prev = line
    return out
