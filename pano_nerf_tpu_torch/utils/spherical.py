"""Spherical direction sampling, the real-SH basis and coordinate
transforms.

Counterpart of pano_nerf_tpu/utils/spherical.py, copied so that the port
imports nothing of the JAX package: the direction sets and the
position / spherical / pixel helpers are numpy; `sh_basis` is torch (the
illuminant field evaluates it on the device). The convention matches
the equirect ray generator: y up, theta = -(col+.5)/w * 2pi,
phi = (row+.5)/h * pi.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def sample_dir_by_pano(hw: Tuple[int, int]):
    """Unit directions for every pixel of an equirect grid.

    Returns (dirs [h, w, 3], theta [h, w], phi [h, w]).
    """
    h, w = hw
    theta, phi = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32), indexing="xy")
    theta = -(theta + 0.5) / w * 2 * np.pi
    phi = (phi + 0.5) / h * np.pi
    y = np.cos(phi)
    x = np.sin(phi) * np.sin(theta)
    z = np.sin(phi) * np.cos(theta)
    return np.stack([x, y, z], axis=-1), theta, phi


def sample_dir_by_uniform(num: int) -> np.ndarray:
    """Fibonacci-sphere (golden-spiral) unit directions, [num, 3] float32."""
    i = np.arange(num, dtype=np.float64)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - (i / (num - 1)) * 2
    radius = np.sqrt(np.maximum(0.0, 1 - y * y))
    theta = golden * i
    return np.stack([np.cos(theta) * radius, y,
                     np.sin(theta) * radius], -1).astype(np.float32)


def sh_basis(dirs: Tensor, deg: int) -> Tensor:
    """Real spherical-harmonic basis [..., (deg+1)^2] at unit directions
    dirs [..., 3], deg 0..3, the standard orthonormal normalization."""
    if not 0 <= deg <= 3:
        raise ValueError(f"sh_basis supports deg 0..3, got {deg}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, 0.2820948)]
    if deg >= 1:
        out += [0.4886025 * y, 0.4886025 * z, 0.4886025 * x]
    if deg >= 2:
        out += [1.0925484 * x * y, 1.0925484 * y * z,
                0.3153916 * (3.0 * z * z - 1.0), 1.0925484 * x * z,
                0.5462742 * (x * x - y * y)]
    if deg >= 3:
        z2 = z * z
        out += [0.5900436 * y * (3.0 * x * x - y * y),
                2.8906114 * x * y * z,
                0.4570458 * y * (5.0 * z2 - 1.0),
                0.3731763 * z * (5.0 * z2 - 3.0),
                0.4570458 * x * (5.0 * z2 - 1.0),
                1.4453057 * z * (x * x - y * y),
                0.5900436 * x * (x * x - 3.0 * y * y)]
    return torch.stack(out, dim=-1)


def pos_to_spherical(pos: np.ndarray):
    """3-D position -> (theta, phi, distance) in the pano convention."""
    d = np.linalg.norm(pos, axis=-1, keepdims=True)
    n = pos / (d + 1e-8)
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    t = np.sqrt(x ** 2 + z ** 2)
    phi = np.pi / 2 - np.arctan2(y, t)
    theta = np.arctan2(-x, -z) - np.pi
    return theta, phi, d


def spherical_to_pos(theta, phi, d=1.0) -> np.ndarray:
    """(theta, phi, d) -> 3-D position."""
    y = np.cos(phi)
    x = np.sin(phi) * np.sin(theta)
    z = np.sin(phi) * np.cos(theta)
    return np.stack([x, y, z], axis=-1) * np.asarray(d)[..., None] \
        if np.ndim(d) else np.stack([x, y, z], axis=-1) * d


def spherical_to_pixel(theta, phi, hw: Tuple[int, int] = (128, 256)):
    """(theta, phi) -> fractional pixel coordinates (col, row)."""
    h, w = hw
    x = -theta / (2 * np.pi)
    y = phi / np.pi
    return np.stack([w * x, h * y], axis=-1)


def interp_uniform_to_pixel(x: np.ndarray, nums: Sequence[int],
                            scale: int = 1) -> np.ndarray:
    """Resample ring-wise uniform directions onto a fixed-width pixel grid.

    x: [n, 3] stacked ring samples; nums: samples per ring; scale: width
    divisor. Returns [len(nums), max(nums)//scale, 3].
    """
    xs = []
    w = int(max(nums) / scale)
    for num in nums:
        num = int(num)
        index = num * (np.arange(w) + 0.5) / w
        line = np.stack([np.interp(index, np.arange(num), x[:num, j])
                         for j in range(3)], axis=-1)
        xs.append(line)
        x = x[num:]
    return np.concatenate(xs, axis=0).reshape(-1, w, 3)


def inverse_uniform_to_pixel(x: np.ndarray, index_map: np.ndarray
                             ) -> np.ndarray:
    """Gather per-pixel values from a flat sample set via an index map."""
    h, w = index_map.shape
    return x[index_map.reshape(-1), :].reshape(h, w, 3)
