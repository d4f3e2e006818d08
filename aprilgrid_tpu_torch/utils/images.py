"""The repo's golden images and a user's image files.

``read_png`` decodes the bundled PNGs with numpy and zlib alone (the
bench and the smoke need no image library); ``load_image`` reads any
image file with PIL as the examples do, keeping its bit depth and
channels; ``DATA`` is the repo's ``tests/data`` and ``GOLDEN`` the
reference's tag counts for the images the port's bench and smoke run
(reference: tests/test_detector.rs:25-33).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parents[2] / "tests" / "data"
GOLDEN = {
    "EuRoC": 36,
    "TUM_VI": 36,
    "right": 36,
    "r45": 36,
    "top": 36,
    "iphone": 66,
    "two_boards": 72,
}


def read_png(path) -> np.ndarray:
    """Decode a non-interlaced 8/16-bit gray, gray+alpha, RGB or RGBA PNG
    with numpy alone. The row filters are undone along anti-diagonals
    (row + pixel column): every byte depends only on its left, upper and
    upper-left neighbours, which lie on earlier diagonals."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if interlace or depth not in (8, 16) or ctype not in (0, 2, 4, 6):
        raise ValueError(f"{path}: unsupported PNG (type {ctype}, depth {depth})")
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, w * bpp + 1)
    ftype = raw[:, 0].astype(np.int32)
    filt = raw[:, 1:].astype(np.int32)
    out = np.zeros((h + 1, (w + 1) * bpp), np.int32)  # row 0 / col 0 stay 0
    k = np.arange(bpp)
    for s in range(h + w - 1):
        r = np.arange(max(0, s - w + 1), min(h - 1, s) + 1)
        px = s - r
        rr = np.repeat(r, bpp) + 1
        xx = (px[:, None] * bpp + k[None, :]).reshape(-1) + bpp
        a = out[rr, xx - bpp]
        b = out[rr - 1, xx]
        c = out[rr - 1, xx - bpp]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ft = np.repeat(ftype[r], bpp)
        pred = np.select(
            [ft == 1, ft == 2, ft == 3, ft == 4],
            [a, b, (a + b) // 2, paeth],
            0,
        )
        out[rr, xx] = (filt[rr - 1, xx - bpp] + pred) & 255
    img = out[1:, bpp:].astype(np.uint8)
    if depth == 16:
        img = (img[:, 0::2].astype(np.uint16) << 8) | img[:, 1::2]
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def load_image(path) -> np.ndarray:
    """Read an image file with PIL, keeping its bit depth and channels:
    16- and 32-bit gray (``I;16``, ``I;16B``, ``I``) as uint16, ``L`` as
    uint8 (H, W), ``LA`` and ``RGBA`` as uint8 (H, W, 2) and (H, W, 4)
    (the detector drops the alpha), any other mode (palette, bilevel,
    CMYK, ...) converted to RGB uint8 (H, W, 3). A copy of the JAX
    package's ``oracle/numpy_ref.py::load_image``, which its examples use."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("I;16", "I;16B", "I"):
            arr = np.array(im, dtype=np.uint16 if im.mode != "I" else np.int32)
            return arr.astype(np.uint16) if arr.dtype == np.int32 else arr
        if im.mode in ("L", "LA", "RGBA"):
            return np.array(im, dtype=np.uint8)
        return np.array(im.convert("RGB"), dtype=np.uint8)
