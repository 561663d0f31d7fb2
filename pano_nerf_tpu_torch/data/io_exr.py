"""Self-contained OpenEXR scanline codec (pure Python + numpy + zlib).

Copy of pano_nerf_tpu/data/io_exr.py, with its native decoder: `read_exr`
first tries the C++ decoder `csrc/exr_decode.cc` (built with g++ at first
use, `kernels/build.py` `load_host_library`), as JAX's reader tries
pano_nerf_tpu/native; when the build fails or the decoder declines a file
it reads with the pure-Python codec below. Which one read the last file
is `read_exr.decoder` ("native" or "python"), and why the native one is
unavailable, where it is, `native_error()`.

* read: NO_COMPRESSION, ZIPS (1 scanline/chunk) and ZIP (16 scanlines/chunk)
  with HALF / FLOAT / UINT channels.
* write: HALF or FLOAT channels, ZIP or NO_COMPRESSION.

The ZIP codec applies OpenEXR's byte-stream transform (split-interleave +
delta predictor) around zlib; both directions are vectorized with numpy.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

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


_NATIVE = dict(lib=None, tried=False, error="")
_NATIVE_LOCK = threading.Lock()


def _native_library() -> Optional[ctypes.CDLL]:
    """The bound C++ decoder, built at first use; None when it cannot be
    built or loaded (`native_error` says why)."""
    with _NATIVE_LOCK:
        if _NATIVE["tried"]:
            return _NATIVE["lib"]
        _NATIVE["tried"] = True
        from pano_nerf_tpu_torch.kernels import build
        try:
            lib = build.load_host_library("exr_decode.cc")
        except (RuntimeError, OSError) as exc:
            _NATIVE["error"] = str(exc)
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.exr_probe.restype = ctypes.c_int
        lib.exr_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p, i32p,
                                  i32p, ctypes.c_char_p, ctypes.c_int32,
                                  i32p, i32p]
        lib.exr_decode.restype = ctypes.c_int
        lib.exr_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_float)]
        _NATIVE["lib"] = lib
        return lib


def native_error() -> str:
    """Why the native decoder is unavailable ('' when it is, or before
    the first read)."""
    return _NATIVE["error"]


def _native_planes(buf: bytes) -> Optional[Dict[str, np.ndarray]]:
    """Decode with the C++ decoder: {channel: [H, W] float32}, or None
    when it is unavailable or declines the file (an unsupported
    compression, say)."""
    lib = _native_library()
    if lib is None:
        return None
    width, height, nchan, comp = (ctypes.c_int32() for _ in range(4))
    names = ctypes.create_string_buffer(64 * 32)
    types = (ctypes.c_int32 * 64)()
    rc = lib.exr_probe(buf, len(buf), ctypes.byref(width),
                       ctypes.byref(height), ctypes.byref(nchan), names, 64,
                       types, ctypes.byref(comp))
    if rc != 0 or nchan.value > 64:
        return None
    out = np.empty((nchan.value, height.value, width.value), np.float32)
    if lib.exr_decode(buf, len(buf), out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float))) != 0:
        return None
    return {names.raw[32 * c:32 * (c + 1)].split(b"\x00")[0].decode("ascii"):
            out[c] for c in range(nchan.value)}


def read_exr(filename: Union[str, "object"], channels: Sequence[str] = ("R", "G", "B"),
             native: bool = True) -> np.ndarray:
    """Read an EXR image to a float32 [H, W, len(channels)] array.

    Accepts a path or an open binary file object. `native` False reads
    with the pure-Python codec only.
    """
    if hasattr(filename, "read"):
        buf = filename.read()
    else:
        with open(filename, "rb") as f:
            buf = f.read()

    planes = _native_planes(buf) if native else None
    if planes is not None:
        if all(c in planes for c in channels):
            read_exr.decoder = "native"
            return np.stack([planes[c] for c in channels], axis=-1)
        if len(planes) == 1:
            read_exr.decoder = "native"
            return np.stack([next(iter(planes.values()))] * len(channels),
                            axis=-1)
        # other channel sets: the pure-Python reader says what is missing
    read_exr.decoder = "python"
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


read_exr.decoder = None


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
