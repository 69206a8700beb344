"""A PNG codec in numpy and zlib, for the frames and keyframe dumps the
mapper writes (the JAX package writes them with OpenCV, which the machine
with the card lacks, as it lacks PIL).

Writes 8-bit RGB, 8-bit grey and 16-bit grey images, one filter-0 scanline
per row. Reads non-interlaced 8- and 16-bit grey, grey+alpha, RGB and RGBA
images with any of the five scanline filters, as libpng (OpenCV's writer)
chooses them. Pixel values round-trip exactly; the files are not
byte-identical to OpenCV's (other filters and compression).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as RGB, (H, W) uint8 or uint16 as grey."""
    with open(path, "wb") as fh:
        fh.write(encode_png(img))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file of (H, W, 3) uint8 RGB or (H, W) uint8/uint16 grey."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        colour, depth = 2, 8
    elif img.dtype in (np.uint8, np.uint16) and img.ndim == 2:
        colour, depth = 0, 8 * img.dtype.itemsize
    else:
        raise ValueError(f"write_png takes (H, W, 3) uint8 or (H, W) uint8/uint16, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    rows = rows.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0 per row
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return line
    if kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64).astype(np.uint8).ravel()
    if kind == 2:  # Up
        return (line.astype(np.uint16) + prev).astype(np.uint8)
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG filter {kind}")
    cur = line.tolist()
    up = prev.tolist()
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        if kind == 3:  # Average
            cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
        else:  # Paeth
            upleft = up[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + _paeth(left, up[i], upleft)) & 0xFF
    return np.array(cur, np.uint8)


def read_png(path: str) -> np.ndarray:
    """(H, W) grey or (H, W, C) colour pixels, uint8 or uint16, in the
    file's channel order (RGB, RGBA)."""
    with open(path, "rb") as fh:
        return decode_png(fh.read(), path)


def decode_png(blob: bytes, path: str = "the data") -> np.ndarray:
    """read_png of a PNG file's bytes."""
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        kind, data = blob[pos + 4 : pos + 8], blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (colour type {colour}, depth {depth}, "
                         f"interlace {interlace})")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    out = np.empty((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, bpp)
    pixels = out.view(">u2").astype(np.uint16) if depth == 16 else out
    return pixels.reshape(h, w) if channels == 1 else pixels.reshape(h, w, channels)
