"""Self-contained OpenEXR scanline codec (pure Python + numpy + zlib).

Copy of pano_nerf_tpu/data/io_exr.py without its optional native decoder:

* read: NO_COMPRESSION, ZIPS (1 scanline/chunk) and ZIP (16 scanlines/chunk)
  with HALF / FLOAT / UINT channels.
* write: HALF or FLOAT channels, ZIP or NO_COMPRESSION.

The ZIP codec applies OpenEXR's byte-stream transform (split-interleave +
delta predictor) around zlib; both directions are vectorized with numpy.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_ZIP_LINES = {_NO_COMPRESSION: 1, _ZIPS: 1, _ZIP: 16}


def _read_cstring(buf: bytes, pos: int) -> Tuple[bytes, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end], end + 1


def _parse_channels(data: bytes) -> List[Tuple[str, int]]:
    """chlist attribute -> [(name, pixel_type), ...] in file order."""
    channels = []
    pos = 0
    while pos < len(data) and data[pos] != 0:
        name, pos = _read_cstring(data, pos)
        pixel_type, = struct.unpack_from("<i", data, pos)
        # skip pLinear(1) + reserved(3) + xSampling(4) + ySampling(4)
        pos += 16
        channels.append((name.decode("ascii"), pixel_type))
    return channels


def _unpredict(raw: bytes) -> np.ndarray:
    """Invert OpenEXR's zip transform: delta-decode, then de-interleave."""
    t = np.frombuffer(raw, dtype=np.uint8).astype(np.int64)
    if t.size:
        deltas = t.copy()
        deltas[1:] -= 128
        t = np.cumsum(deltas) & 0xFF
    t = t.astype(np.uint8)
    n = t.size
    out = np.empty(n, dtype=np.uint8)
    half = (n + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out


def _predict(data: np.ndarray) -> bytes:
    """Forward zip transform: interleave-split, then delta-encode."""
    d = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    n = d.size
    tmp = np.empty(n, dtype=np.uint8)
    half = (n + 1) // 2
    tmp[:half] = d[0::2]
    tmp[half:] = d[1::2]
    t = tmp.astype(np.int64)
    if n > 1:
        t[1:] = (t[1:] - t[:-1] + (128 + 256)) & 0xFF
    return t.astype(np.uint8).tobytes()


def read_exr(filename: Union[str, "object"], channels: Sequence[str] = ("R", "G", "B")
             ) -> np.ndarray:
    """Read an EXR image to a float32 [H, W, len(channels)] array.

    Accepts a path or an open binary file object.
    """
    if hasattr(filename, "read"):
        buf = filename.read()
    else:
        with open(filename, "rb") as f:
            buf = f.read()

    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    pos = 8

    attrs: Dict[str, bytes] = {}
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_cstring(buf, pos)
        _type, pos = _read_cstring(buf, pos)
        size, = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name.decode("ascii")] = buf[pos:pos + size]
        pos += size

    file_channels = _parse_channels(attrs["channels"])
    compression = attrs["compression"][0]
    if compression not in (_NO_COMPRESSION, _ZIPS, _ZIP):
        raise NotImplementedError(f"EXR compression {compression} not supported")
    xmin, ymin, xmax, ymax = struct.unpack("<iiii", attrs["dataWindow"])
    width = xmax - xmin + 1
    height = ymax - ymin + 1

    lines_per_chunk = _ZIP_LINES[compression]
    num_chunks = (height + lines_per_chunk - 1) // lines_per_chunk
    pos += 8 * num_chunks  # skip scanline offset table; chunks follow in order

    bytes_per_px = {name: _PIXEL_DTYPES[pt].itemsize for name, pt in file_channels}
    dtypes = {name: _PIXEL_DTYPES[pt] for name, pt in file_channels}
    line_bytes = sum(width * b for b in bytes_per_px.values())

    planes = {name: np.empty((height, width), dtype=np.float32)
              for name, _ in file_channels}
    for _ in range(num_chunks):
        y, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        chunk = buf[pos:pos + size]
        pos += size
        y0 = y - ymin
        n_lines = min(lines_per_chunk, height - y0)
        expect = line_bytes * n_lines
        if compression != _NO_COMPRESSION and size != expect:
            chunk = _unpredict(zlib.decompress(chunk)).tobytes()
        off = 0
        for line in range(n_lines):
            for name, _pt in file_channels:
                nb = width * bytes_per_px[name]
                row = np.frombuffer(chunk, dtype=dtypes[name], count=width,
                                    offset=off)
                planes[name][y0 + line] = row.astype(np.float32)
                off += nb

    missing = [c for c in channels if c not in planes]
    if missing:
        # Grayscale files (single Y/A channel): broadcast it.
        if len(planes) == 1:
            only = next(iter(planes.values()))
            return np.stack([only] * len(channels), axis=-1)
        raise KeyError(f"channels {missing} not in EXR (has {list(planes)})")
    return np.stack([planes[c] for c in channels], axis=-1)


def write_exr(filename: str, data: np.ndarray,
              channels: Sequence[str] = ("R", "G", "B"),
              pixel_type: str = "half", compression: str = "zip") -> None:
    """Write [H, W, C] (or [H, W]) float data as a scanline EXR.

    Single-channel [H, W, 1] data is replicated to R=G=B, matching the
    reference writer.
    """
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[..., None]
    if data.shape[-1] == 1 and len(channels) == 3:
        data = np.repeat(data, 3, axis=-1)
    assert data.shape[-1] == len(channels), (data.shape, channels)
    height, width = data.shape[:2]

    pt = _PT_HALF if pixel_type == "half" else _PT_FLOAT
    dtype = _PIXEL_DTYPES[pt]
    comp = _ZIP if compression == "zip" else _NO_COMPRESSION
    lines_per_chunk = _ZIP_LINES[comp]

    # Channels must be stored (and listed) alphabetically.
    order = sorted(range(len(channels)), key=lambda i: channels[i])

    def attr(name: str, type_: str, payload: bytes) -> bytes:
        return (name.encode() + b"\x00" + type_.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    chlist = b"".join(
        channels[i].encode() + b"\x00" + struct.pack("<iBBBBii", pt, 0, 0, 0, 0, 1, 1)
        for i in order) + b"\x00"
    box = struct.pack("<iiii", 0, 0, width - 1, height - 1)
    header = b"".join([
        struct.pack("<ii", _MAGIC, 2),
        attr("channels", "chlist", chlist),
        attr("compression", "compression", bytes([comp])),
        attr("dataWindow", "box2i", box),
        attr("displayWindow", "box2i", box),
        attr("lineOrder", "lineOrder", b"\x00"),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\x00",
    ])

    cast = data.astype(dtype)
    chunks = []
    num_chunks = (height + lines_per_chunk - 1) // lines_per_chunk
    for c in range(num_chunks):
        y0 = c * lines_per_chunk
        n_lines = min(lines_per_chunk, height - y0)
        raw = b"".join(
            cast[y, :, i].tobytes()
            for y in range(y0, y0 + n_lines) for i in order)
        if comp == _ZIP:
            packed = zlib.compress(_predict(np.frombuffer(raw, np.uint8)))
            if len(packed) >= len(raw):
                packed = raw
        else:
            packed = raw
        chunks.append((y0, packed))

    offset = len(header) + 8 * num_chunks
    table = []
    body = []
    for y0, packed in chunks:
        table.append(struct.pack("<Q", offset))
        piece = struct.pack("<ii", y0, len(packed)) + packed
        body.append(piece)
        offset += len(piece)

    with open(filename, "wb") as f:
        f.write(header)
        f.write(b"".join(table))
        f.write(b"".join(body))
