"""Image products and render-path poses (numpy only).

Counterpart of pano_nerf_tpu/utils/vis.py: `hotmap` and
`visualize_depth` (depth colorization), `save_results`, the render-path
pose generators `gen_render_path`, `create_spiral_poses` and
`create_spheric_poses`, and the frame stackers `vstack_img`, `hstack_img`
and `stack_frame`. PNGs are written with zlib + numpy (8-bit RGB), EXRs
with data/io_exr.py.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

from pano_nerf_tpu_torch.data.io_exr import write_exr


def _jet(x: np.ndarray) -> np.ndarray:
    """'jet'-style colormap, [H, W] in [0, 1] -> [H, W, 3] float32."""
    x = np.clip(x, 0.0, 1.0)
    rgb = [np.clip(1.5 - np.abs(4 * x - c), 0, 1) for c in (3, 2, 1)]
    return np.stack(rgb, axis=-1).astype(np.float32)


def hotmap(depth: np.ndarray) -> np.ndarray:
    """'jet'-style colorization of a normalized depth map [H, W(, 1)]
    -> [H, W, 3] float32 in [0, 1]."""
    x = np.asarray(depth)
    if x.ndim == 3:
        x = x[..., 0]
    return _jet(x)


def visualize_depth(depth: np.ndarray) -> np.ndarray:
    """Min-max-normalized and colorized depth, [H, W(, 1)] -> [H, W, 3]."""
    x = np.asarray(depth, dtype=np.float32)
    x = np.nan_to_num(np.squeeze(x) if x.ndim > 2 else x)
    mi, ma = float(x.min()), float(x.max())
    return _jet((x - mi) / max(ma - mi, 1e-8))


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def write_png(path: Union[str, Path], rgb8: np.ndarray) -> None:
    """Write [H, W, 3] (or [H, W, 4]) uint8 as an 8-bit RGB (RGBA) PNG
    (filter 0 on each row; `data/png.py` reads it back)."""
    h, w, c = rgb8.shape
    if c not in (3, 4) or rgb8.dtype != np.uint8:
        raise ValueError(f"write_png takes [H, W, 3 or 4] uint8, got "
                         f"{rgb8.shape} {rgb8.dtype}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb8.reshape(h, w * c)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
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


# ---- render-path poses and frame stackers ----

def _euler_xyz_to_matrix(angles_deg: np.ndarray) -> np.ndarray:
    """Intrinsic xyz Euler angles (degrees) -> rotation matrix."""
    ax, ay, az = np.radians(angles_deg)
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _matrix_to_euler_xyz(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> intrinsic xyz Euler angles (degrees)."""
    sy = np.sqrt(m[0, 0] ** 2 + m[1, 0] ** 2)
    if sy > 1e-6:
        x = np.arctan2(m[2, 1], m[2, 2])
        z = np.arctan2(m[1, 0], m[0, 0])
    else:
        x = np.arctan2(-m[1, 2], m[1, 1])
        z = 0.0
    return np.degrees([x, np.arctan2(-m[2, 0], sy), z])


def gen_render_path(c2ws: np.ndarray, n_views: int = 30) -> np.ndarray:
    """A closed camera path through the poses c2ws [N, 4, 4]: Euler
    angles and positions lerped between consecutive poses (the last back
    to the first), max(1, n_views // 3) per segment; [M, 4, 4]."""
    weight = np.linspace(1.0, 0.0, max(1, n_views // 3),
                         endpoint=False).reshape(-1, 1)
    rotvec, positions, rot_interp, pos_interp = [], [], [], []
    for i in range(len(c2ws)):
        euler = _matrix_to_euler_xyz(c2ws[i, :3, :3]).reshape(1, 3)
        if i:
            euler[np.abs(euler - rotvec[0]) > 180] += 360.0
        rotvec.append(euler)
        positions.append(c2ws[i, :3, 3:].reshape(1, 3))
        if i:
            rot_interp.append(weight * rotvec[i - 1]
                              + (1 - weight) * rotvec[i])
            pos_interp.append(weight * positions[i - 1]
                              + (1 - weight) * positions[i])
    rot_interp.append(weight * rotvec[-1] + (1 - weight) * rotvec[0])
    pos_interp.append(weight * positions[-1] + (1 - weight) * positions[0])
    out = []
    for angles, position in zip(np.concatenate(rot_interp),
                                np.concatenate(pos_interp)):
        c2w = np.eye(4)
        c2w[:3, :3] = _euler_xyz_to_matrix(angles)
        c2w[:3, 3] = position
        out.append(c2w)
    return np.stack(out)


def _normalize3(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def create_spiral_poses(radii, focus_depth: float, n_poses: int = 120
                        ) -> np.ndarray:
    """LLFF-style spiral path looking at (0, 0, -focus_depth),
    [n_poses, 3, 4]."""
    poses = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = _normalize3(center - np.array([0, 0, -focus_depth]))
        x = _normalize3(np.cross(np.array([0, 1, 0]), z))
        poses.append(np.stack([x, np.cross(z, x), z, center], 1))
    return np.stack(poses, 0)


def create_spheric_poses(radius: float, n_poses: int = 120) -> np.ndarray:
    """A circle of poses at `radius` looking 36 degrees down,
    [n_poses, 3, 4]."""

    def spheric_pose(theta, phi):
        trans_t = np.eye(4)
        trans_t[2, 3] = radius
        rot_phi = np.array([[1, 0, 0, 0],
                            [0, np.cos(phi), -np.sin(phi), 0],
                            [0, np.sin(phi), np.cos(phi), 0],
                            [0, 0, 0, 1]])
        rot_theta = np.array([[np.cos(theta), 0, -np.sin(theta), 0],
                              [0, 1, 0, 0],
                              [np.sin(theta), 0, np.cos(theta), 0],
                              [0, 0, 0, 1]])
        c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                        [0, 0, 0, 1]]) @ (rot_theta @ rot_phi @ trans_t)
        return c2w[:3]

    return np.stack([spheric_pose(th, -np.pi / 5)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]])


def _to_rgb(img: np.ndarray) -> np.ndarray:
    return np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img


def vstack_img(imgs) -> np.ndarray:
    """[H, W, C] images stacked vertically (one channel -> RGB)."""
    return np.concatenate([_to_rgb(np.asarray(i)) for i in imgs], axis=0)


def hstack_img(imgs) -> np.ndarray:
    """[H, W, C] images side by side with 5-pixel white separators."""
    out = []
    for i, img in enumerate(imgs):
        out.append(_to_rgb(np.asarray(img)))
        if i < len(imgs) - 1:
            out.append(np.ones((img.shape[0], 5, 3), np.float32))
    return np.concatenate(out, axis=1)


def stack_frame(imgs, hw=(2, 2)) -> np.ndarray:
    """Images tiled into an h x w grid, missing cells zero."""
    h, w = hw
    imgs = [_to_rgb(np.asarray(i)) for i in imgs]
    imgs += [np.zeros_like(imgs[0])] * (h * w - len(imgs))
    return np.concatenate([np.concatenate(imgs[r * w:(r + 1) * w], axis=1)
                           for r in range(h)], axis=0)
