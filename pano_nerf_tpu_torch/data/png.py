"""A PNG reader written with zlib and numpy (no imaging library).

Reads non-interlaced 8- and 16-bit gray, gray + alpha, RGB and RGBA
files with any of the five row filters (0 none, 1 sub, 2 up, 3 average,
4 Paeth). Interlaced (Adam7), palette, and gray files under 8 bits
raise ValueError naming what they are. The port's writer is
`utils/vis.py` `write_png`.
"""

from __future__ import annotations

import struct
import zlib
import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> (samples per pixel, name)
_COLOR_TYPES = {0: (1, "gray"), 2: (3, "RGB"), 3: (1, "palette"),
                4: (2, "gray+alpha"), 6: (4, "RGBA")}


def _chunks(buf: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(buf):
        length, kind = struct.unpack_from(">I4s", buf, pos)
        data = buf[pos + 8:pos + 8 + length]
        crc, = struct.unpack_from(">I", buf, pos + 8 + length)
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int
              ) -> np.ndarray:
    """Undo the per-row filters of the inflated image data [height,
    1 + stride] -> [height, stride] uint8."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:    # sub: a running sum per byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:    # up
            cur = (line + prev) & 255
        elif kind in (3, 4):
            cur = line.tolist()
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 255
            cur = np.asarray(cur, np.int64)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(filename: str) -> np.ndarray:
    """The image's samples as [H, W, C] (C = 1 gray, 2 gray + alpha, 3
    RGB, 4 RGBA), uint8 for 8-bit files and uint16 for 16-bit ones."""
    with open(filename, "rb") as fp:
        buf = fp.read()
    if not buf.startswith(_SIGNATURE):
        raise ValueError(f"{filename}: not a PNG file")
    header, idat = None, []
    for kind, data in _chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{filename}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    channels, name = _COLOR_TYPES.get(color, (0, f"color type {color}"))
    if color == 3:
        raise ValueError(f"{filename}: palette PNG files are not supported")
    if interlace:
        raise ValueError(f"{filename}: interlaced (Adam7) PNG files are not "
                         "supported")
    if not channels or depth not in (8, 16):
        raise ValueError(f"{filename}: {depth}-bit {name} PNG files are not "
                         "supported (8 or 16 bits only)")
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * bpp + 1):
        raise ValueError(f"{filename}: image data of {raw.size} bytes, "
                         f"expected {height * (width * bpp + 1)}")
    data = _unfilter(raw, height, width * bpp, bpp)
    if depth == 16:
        data = data.view(">u2").astype(np.uint16)
    return data.reshape(height, width, channels)
