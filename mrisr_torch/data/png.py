"""PNG writing and reading without PIL, and gray image loading for the folder evaluator.

* :func:`write_png_gray`: a ``[H, W]`` uint8 array as an 8-bit grayscale
  PNG (filter 0 on every row, zlib level 6);
* :func:`read_png_gray`: an 8-bit PNG (gray, gray + alpha, RGB, RGBA or
  palette; any of the five row filters; not interlaced) as ``[H, W]`` uint8,
  converted to gray as PIL's ``convert("L")`` does: the integer luma
  ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``, alpha dropped, a palette
  looked up first;
* :func:`read_gray`: a PNG by the reader above; a JPEG through PIL, imported
  only then (an error naming the file if it is missing).
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type -> samples per pixel


def write_png_gray(path: str | Path, pixels: np.ndarray) -> None:
    """Write a ``[H, W]`` uint8 array as an 8-bit grayscale PNG."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w = pixels.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels], axis=1).tobytes()  # filter type 0 on every row
    png = (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def _paeth_row(raw: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(len(raw))
    rb, ub = raw.tobytes(), up.tobytes()
    for i in range(len(rb)):
        left = out[i - bpp] if i >= bpp else 0
        upper = ub[i]
        ul = ub[i - bpp] if i >= bpp else 0
        p = left + upper - ul
        pa, pb, pc = abs(p - left), abs(p - upper), abs(p - ul)
        pred = left if pa <= pb and pa <= pc else (upper if pb <= pc else ul)
        out[i] = (rb[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(raw: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(len(raw))
    rb, ub = raw.tobytes(), up.tobytes()
    for i in range(len(rb)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (rb[i] + ((left + ub[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    rows = np.frombuffer(data, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, raw = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = raw
        elif kind == 1:
            cur = np.cumsum(raw.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = raw + prev
        elif kind == 3:
            cur = _average_row(raw, prev, bpp)
        elif kind == 4:
            cur = _paeth_row(raw, prev, bpp)
        else:
            raise ValueError(f"PNG row {r} has unknown filter type {kind}")
        out[r] = cur
        prev = out[r]
    return out


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's integer RGB -> L conversion of ``[..., 3]`` uint8."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def read_png_gray(path: str | Path) -> np.ndarray:
    """An 8-bit PNG as a ``[H, W]`` uint8 gray image (PIL's ``convert("L")``)."""
    buf = Path(path).read_bytes()
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos : pos + 8])
        body = buf[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no image data")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced PNGs are read (bit depth {depth}, color type "
                         f"{color}, interlace {interlace})")
    bpp = _CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp).reshape(h, w, bpp)
    if color in (0, 4):
        return np.ascontiguousarray(px[..., 0])
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        lut[: len(palette)] = palette
        return _luma(lut[px[..., 0]])
    return _luma(px[..., :3])


def read_gray(path: str | Path) -> np.ndarray:
    """A PNG or JPEG as a ``[H, W]`` uint8 gray image; a JPEG needs PIL."""
    if Path(path).suffix.lower() in (".jpg", ".jpeg"):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"reading the JPEG {path} needs PIL, which is not installed") from e
        with Image.open(path) as im:
            return np.asarray(im.convert("L"))
    return read_png_gray(path)
