"""The port's image reading (``data/imageio.py``) without cv2, against
``cv2.imread`` / ``cv2.imdecode`` with ``IMREAD_COLOR`` and BGR -> RGB.

cv2 is hidden from the port with ``mock.patch.dict(sys.modules, {"cv2":
None})``, so the port decodes PNG itself; the reference pixels come from
cv2 in the same process. Bar: equal bit for bit, on PNGs that cv2 writes
(it picks its own row filters), PNGs that PIL writes (palette and gray+alpha
forms, which cv2 does not write) and PNGs written here byte by byte with
each of the five row filters and the sub-byte depths.
"""

import struct
import sys
import zlib
from unittest import mock

import cv2
import numpy as np
import pytest
from PIL import Image

from densebox_tpu_torch.data import imageio
import torch_threads  # noqa: F401  (sets torch's threads)

NO_CV2 = {"cv2": None}


def _cv2_rgb(path):
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _port(path):
    """(imread, imdecode of the file's bytes) with cv2 hidden."""
    with mock.patch.dict(sys.modules, NO_CV2):
        return (imageio.imread(str(path)),
                imageio.imdecode(open(path, "rb").read()))


def _assert_decodes_as_cv2(path):
    want = _cv2_rgb(path)
    assert want is not None
    for got in _port(path):
        assert got is not None and got.dtype == np.uint8
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _content(rng, shape):
    """Noise with smooth and flat regions, so that an adaptive writer picks
    different filters row to row."""
    img = rng.randint(0, 256, shape).astype(np.uint8)
    h = shape[0]
    ramp = (np.arange(shape[1]) * 7 % 256).astype(np.uint8)
    img[:h // 3] = ramp[None, :, None] if img.ndim == 3 else ramp[None, :]
    img[h // 3:h // 2] = 200
    return img


@pytest.mark.parametrize("shape", [(37, 53, 3), (1, 41, 3), (43, 1, 3),
                                   (64, 64, 3), (37, 53), (1, 9), (29, 31, 4),
                                   (2, 3, 4)])
def test_cv2_written_png(tmp_path, shape):
    path = tmp_path / "a.png"
    assert cv2.imwrite(str(path), _content(np.random.RandomState(sum(shape)),
                                           shape))
    _assert_decodes_as_cv2(path)


@pytest.mark.parametrize("mode,colors", [("P", 256), ("P", 16), ("P", 4),
                                         ("P", 2), ("LA", 0), ("L", 0),
                                         ("1", 0), ("RGBA", 0), ("RGB", 0)])
def test_pil_written_png(tmp_path, mode, colors):
    rng = np.random.RandomState(len(mode) + colors)
    shape = (23, 31)
    if mode == "P":
        im = Image.fromarray(rng.randint(0, colors, shape).astype(np.uint8),
                             "P")
        im.putpalette(rng.randint(0, 256, 3 * colors).tolist())
    elif mode == "1":
        im = Image.fromarray(rng.randint(0, 2, shape).astype(bool))
    else:
        n = {"LA": 2, "L": 1, "RGBA": 4, "RGB": 3}[mode]
        arr = _content(rng, shape + ((n,) if n > 1 else ()))
        im = Image.fromarray(arr, mode)
    path = tmp_path / "b.png"
    im.save(path)
    _assert_decodes_as_cv2(path)


def _paeth(a, b, c):
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png(lines, width, depth, ctype, filters, palette=None, interlace=0):
    """A PNG whose scanlines (each a bytes object) are encoded with
    ``filters[y]``, written byte by byte."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, channels * depth // 8)
    raw, prev = b"", bytes(len(lines[0]))
    for line, f in zip(lines, filters):
        out = bytearray()
        for i, x in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            c = prev[i - bpp] if i >= bpp else 0
            b = prev[i]
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[f]
            out.append((x - pred) & 0xFF)
        raw += bytes([f]) + bytes(out)
        prev = line
    ihdr = struct.pack(">IIBBBBB", width, len(lines), depth, ctype, 0, 0,
                       interlace)
    body = _chunk(b"IHDR", ihdr)
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    # split the data over two IDAT chunks, as writers may
    z = zlib.compress(raw)
    return (b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IDAT", z[:len(z) // 2])
            + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,depth", [(2, 8), (6, 8), (0, 8), (4, 8),
                                         (3, 8), (0, 1), (0, 2), (0, 4),
                                         (3, 1), (3, 2), (3, 4)])
def test_handwritten_png_every_filter(tmp_path, ctype, depth):
    """Rows under all five filters, cycled (and a run of Paeth rows), in
    every colour type and bit depth the decoder takes."""
    rng = np.random.RandomState(ctype * 10 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    width, height = 13, 17
    levels = 1 << depth
    samples = rng.randint(0, levels, (height, width * channels))
    samples[:4] = np.arange(width * channels) % levels      # smooth rows
    if depth < 8:
        bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
        lines = [np.packbits(r.ravel()).tobytes() for r in bits]
    else:
        lines = [r.astype(np.uint8).tobytes() for r in samples]
    filters = [y % 5 for y in range(height - 4)] + [4] * 4
    palette = (rng.randint(0, 256, (levels, 3)).astype(np.uint8)
               if ctype == 3 else None)
    path = tmp_path / "c.png"
    path.write_bytes(_png(lines, width, depth, ctype, filters, palette))
    _assert_decodes_as_cv2(path)


def test_unfilter_rejects_unknown_filter():
    rows = np.array([[5, 1, 2, 3]], np.uint8)
    with pytest.raises(Exception, match="filter type 5"):
        imageio.unfilter(rows, 3)


def test_formats_only_cv2_reads_raise_import_error(tmp_path):
    img = _content(np.random.RandomState(0), (20, 30, 3))
    jpg, png16 = tmp_path / "x.jpg", tmp_path / "deep.png"
    assert cv2.imwrite(str(jpg), img)
    assert cv2.imwrite(str(png16), img.astype(np.uint16) * 257)
    interlaced = tmp_path / "adam7.png"
    interlaced.write_bytes(_png([bytes(9)] * 2, 3, 8, 2, [0, 0], interlace=1))
    for path, what in ((jpg, "JPEG"), (png16, "16-bit"),
                       (interlaced, "interlaced")):
        assert _cv2_rgb(path) is not None or path is interlaced
        with mock.patch.dict(sys.modules, NO_CV2):
            with pytest.raises(ImportError, match=f"{path.name}.*{what}.*cv2"):
                imageio.imread(str(path))
            with pytest.raises(ImportError, match=f"request body.*{what}"):
                imageio.imdecode(path.read_bytes())


def test_no_image_gives_none_as_cv2(tmp_path):
    png = tmp_path / "ok.png"
    assert cv2.imwrite(str(png), _content(np.random.RandomState(1),
                                          (16, 16, 3)))
    data = bytearray(png.read_bytes())
    idat = data.index(b"IDAT")
    broken_crc = bytes(data[:idat + 6]) + bytes([data[idat + 6] ^ 0xFF]) \
        + bytes(data[idat + 7:])
    cases = {"garbage": b"not an image at all", "empty": b"",
             "truncated": bytes(data[:len(data) // 2]),
             "broken_crc": broken_crc}
    for name, body in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(body)
        assert _cv2_rgb(path) is None, name
        assert _port(path) == (None, None), name
    with mock.patch.dict(sys.modules, NO_CV2):
        assert imageio.imread(str(tmp_path / "missing.png")) is None


def test_with_cv2_calls_cv2(tmp_path):
    path = tmp_path / "d.png"
    img = _content(np.random.RandomState(2), (21, 17, 3))
    assert cv2.imwrite(str(path), img)
    np.testing.assert_array_equal(imageio.imread(str(path)), img[..., ::-1])
    np.testing.assert_array_equal(imageio.imdecode(path.read_bytes()),
                                  img[..., ::-1])
    assert imageio.imdecode(b"") is None


def test_resize_area_needs_cv2():
    img = np.random.RandomState(3).rand(40, 60, 3).astype(np.float32)
    np.testing.assert_array_equal(
        imageio.resize_area(img, (30, 20)),
        cv2.resize(img, (30, 20), interpolation=cv2.INTER_AREA))
    with mock.patch.dict(sys.modules, NO_CV2):
        with pytest.raises(ImportError, match="40x60 image to 20x30.*cv2"):
            imageio.resize_area(img, (30, 20))
