"""Validation image products: depth colorization, PNG and EXR writers.

Counterpart of `hotmap` and `save_results` in pano_nerf_tpu/utils/vis.py.
PNGs are written with zlib + numpy (8-bit RGB), EXRs with data/io_exr.py.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

from pano_nerf_tpu_torch.data.io_exr import write_exr


def hotmap(depth: np.ndarray) -> np.ndarray:
    """'jet'-style colorization of a normalized depth map [H, W(, 1)]
    -> [H, W, 3] float32 in [0, 1]."""
    x = np.asarray(depth)
    if x.ndim == 3:
        x = x[..., 0]
    x = np.clip(x, 0.0, 1.0)
    rgb = [np.clip(1.5 - np.abs(4 * x - c), 0, 1) for c in (3, 2, 1)]
    return np.stack(rgb, axis=-1).astype(np.float32)


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def write_png(path: Union[str, Path], rgb8: np.ndarray) -> None:
    """Write [H, W, 3] uint8 as an 8-bit RGB PNG (filter 0 on each row)."""
    h, w, c = rgb8.shape
    if c != 3 or rgb8.dtype != np.uint8:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got "
                         f"{rgb8.shape} {rgb8.dtype}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb8.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


def save_results(image: np.ndarray, save_path: Union[str, Path]) -> None:
    """Save a [H, W, C] float image: .exr as half-float HDR, else 8-bit PNG
    (one channel is replicated to RGB)."""
    save_path = Path(save_path)
    os.makedirs(save_path.parent, exist_ok=True)
    image = np.asarray(image)
    if save_path.suffix == ".exr":
        write_exr(str(save_path), image.astype(np.float32), pixel_type="half")
        return
    if image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)
    write_png(save_path, to_uint8(image))
