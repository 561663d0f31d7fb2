"""Panoramic EXR dataset: loading and equirectangular ray generation (numpy).

Counterpart of pano_nerf_tpu/data/pano_dataset.py: the loaders, pose
conventions, equirect ray geometry and env-direction set are the same
numpy code. The val split holds whole panoramas; the train split holds
the flattened ray set of its views (`_flatten_all`), which the trainer
uploads to the device once and samples batches from there.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pano_nerf_tpu_torch.core.rays import RAYS_KEYS, Rays
from pano_nerf_tpu_torch.data.io_exr import read_exr


def _rot_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def bld_to_wd(rm: Optional[np.ndarray] = None) -> np.ndarray:
    """Blender-to-world rotation fix."""
    b2w = _rot_x(np.pi / 2)
    if rm is None:
        return b2w
    return b2w.T @ rm @ _rot_x(-np.pi / 2).T @ _rot_x(np.pi / 2)


def nor_to_nor(x: np.ndarray) -> np.ndarray:
    """Normal-map frame fix for pano scenes."""
    return x @ _rot_y(np.pi)


def equirect_camera_dirs(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel unit directions + angular noise range of an equirect grid.

    Pixel (row phi, col theta): theta = -(col+.5)/w * 2pi,
    phi = (row+.5)/h * pi, dir = (sin phi sin theta, cos phi,
    sin phi cos theta); y is up.
    """
    theta, phi = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32), indexing="xy")
    theta = -(theta + 0.5) / w * 2 * np.pi
    phi = (phi + 0.5) / h * np.pi
    dirs = np.stack([np.sin(phi) * np.sin(theta), np.cos(phi),
                     np.sin(phi) * np.cos(theta)], axis=-1)
    noise_range = (np.sin(phi) * np.pi / w).reshape(h, w, 1)
    return dirs, noise_range


def equirect_radii(directions: np.ndarray) -> np.ndarray:
    """Cone radii from the equator row's neighbour spacing, [H, W, 1]."""
    h = directions.shape[0]
    mid = directions[h // 2]
    dx = np.sqrt(np.sum((mid[:-1] - mid[1:]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1]], 0)
    radii = np.tile(dx[None, :], (h, 1))[..., None] * 2 / np.sqrt(12)
    return radii.astype(np.float32)


def pano_rays_for_pose(origin: np.ndarray, h: int, w: int, near: float,
                       far: float) -> Rays:
    """The equirect ray bundle [h, w, ...] of a camera at `origin` [3]
    with world axes: a novel view of `render_path`."""
    dirs, noise = equirect_camera_dirs(h, w)
    ones = np.ones_like(dirs[..., :1])
    return Rays(
        origins=np.broadcast_to(np.asarray(origin, np.float32),
                                dirs.shape).copy(),
        directions=dirs.astype(np.float32), viewdirs=dirs.astype(np.float32),
        radii=equirect_radii(dirs), lossmult=ones, near=ones * near,
        far=ones * far, noise_var=noise.astype(np.float32))


def generate_lit_rays(num: int = 10, near: float = 0.0, far: float = 10.0,
                      radius: float = 0.01) -> Rays:
    """Fibonacci-sphere env directions with 4pi/num solid angles (numpy)."""
    i = np.arange(num, dtype=np.float64)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - (i / (num - 1)) * 2
    r = np.sqrt(np.maximum(0.0, 1 - y * y))
    theta = golden * i
    dirs = np.stack([np.cos(theta) * r, y, np.sin(theta) * r],
                    -1).astype(np.float32)
    ones = np.ones((num, 1), np.float32)
    viewdirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return Rays(
        origins=np.zeros((num, 3), np.float32), directions=dirs,
        viewdirs=viewdirs.astype(np.float32),
        radii=np.full((num, 1), radius, np.float32),
        lossmult=ones * (4 * np.pi / num), near=ones * near, far=ones * far,
        noise_var=np.zeros((num, 1), np.float32))


def _resize_area(image: np.ndarray, factor: int) -> np.ndarray:
    """INTER_AREA-equivalent downsample by an integer factor (box filter)."""
    h, w = image.shape[:2]
    nh, nw = h // factor, w // factor
    image = image[: nh * factor, : nw * factor]
    return image.reshape(nh, factor, nw, factor, -1).mean(axis=(1, 3))


class PanoDataset:
    """EXR panorama quads (image/albedo/normal/depth) + equirect rays.

    `num` lists the training view ids: the train split holds them, the val
    split every other view. A val `dataset[i]` is one whole panorama:
    (Rays of [H, W, C] arrays, image, depth, normal, albedo). The train
    split is flattened: `rays` is a Rays of [num_rays, C] arrays and
    `images` / `depths` / `normals` / `albedos` are [num_rays, C].
    """

    MATERIALS = ("image", "albedo", "normal", "depth")

    def __init__(self, data_dir: str, split: str = "val",
                 white_bkgd: bool = False, factor: int = 4,
                 num: Optional[Sequence[int]] = None,
                 range: Tuple[float, float] = (0, 10),
                 normalize_depth: bool = False, reform_cam: bool = False,
                 meta_file: str = "transforms_all"):
        if factor <= 0:
            raise ValueError(f"factor must be positive, got {factor}")
        self.data_dir = data_dir
        self.split = split
        self.white_bkgd = white_bkgd
        self.factor = factor
        self.num = num
        self.near, self.far = range
        self.normalize_depth = normalize_depth
        self.reform_cam = reform_cam
        self.meta_file = meta_file
        self._load_renderings()
        self._generate_rays()
        if split == "train":
            self._flatten_all()

    def _load_renderings(self) -> None:
        with open(os.path.join(self.data_dir, f"{self.meta_file}.json")) as fp:
            meta = json.load(fp)
        data_num = len(meta["image"])
        if self.num is None:
            self.data_list = list(range(data_num))
        elif self.split == "train":
            self.data_list = list(self.num)
        else:
            self.data_list = [x for x in range(data_num) if x not in self.num]

        store = {m: [] for m in self.MATERIALS}
        cams = []
        for material in self.MATERIALS:
            for i in self.data_list:
                frame = meta[material][i]
                image = _resize_area(read_exr(os.path.join(
                    self.data_dir, frame["file_path"] + ".exr")), self.factor)
                if self.white_bkgd:
                    # The reader loads RGB only, so the last channel (blue)
                    # acts as alpha: the reference's behaviour.
                    image = (image[..., :3] * image[..., -1:]
                             + (1.0 - image[..., -1:]))
                if material == "image":
                    mx = np.array(frame["transform_matrix"], dtype=np.float32)
                    if "rot" in self.data_dir or "std" in self.data_dir:
                        mx[:3, :3] = bld_to_wd(mx[:3, :3])
                    else:
                        mx[:3, :3] = np.eye(3)
                    mx[:3, -1] = mx[:3, -1].copy() @ bld_to_wd()
                    cams.append(mx)
                    image = np.clip(np.nan_to_num(image, nan=0)[..., :3],
                                    0, 1000)
                elif material == "depth":
                    image = image[..., :1]
                    if self.normalize_depth:
                        image = (np.clip(image, self.near, self.far)
                                 - self.near) / (self.far - self.near)
                elif material == "normal":
                    image = image * 2 - 1
                    if "pano" in self.data_dir:
                        image = nor_to_nor(image[..., :3])
                else:
                    image = image[..., :3]
                store[material].append(image.astype(np.float32))

        self.images = store["image"]
        self.albedos = store["albedo"]
        self.normals = store["normal"]
        self.depths = store["depth"]
        self.h, self.w = self.images[0].shape[:2]
        self.camtoworlds = cams

    def _generate_rays(self) -> None:
        if self.reform_cam:
            c2w = np.array(self.camtoworlds)
            c2w[:, :3, -1] -= np.mean(c2w[:, :3, -1], axis=0, keepdims=True)
            self.camtoworlds = list(c2w)
        camera_dirs, noise_range = equirect_camera_dirs(self.h, self.w)
        self.rays = []
        for c2w in self.camtoworlds:
            d = (camera_dirs @ c2w[:3, :3].T).astype(np.float32)
            o = np.broadcast_to(c2w[:3, -1], d.shape).astype(np.float32)
            ones = np.ones_like(o[..., :1])
            self.rays.append(Rays(
                origins=o.copy(), directions=d,
                viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
                radii=equirect_radii(d), lossmult=ones,
                near=ones * self.near, far=ones * self.far,
                noise_var=noise_range.astype(np.float32).copy()))
        self.radii = self.rays[0].radii[0, 0, 0]

    def _flatten_all(self) -> None:
        def flat(xs: List[np.ndarray]) -> np.ndarray:
            return np.concatenate([x.reshape(-1, x.shape[-1]) for x in xs], 0)

        self.images = flat(self.images)
        self.depths = flat(self.depths)
        self.normals = flat(self.normals)
        self.albedos = flat(self.albedos)
        self.rays = Rays(*(flat([getattr(r, k) for r in self.rays])
                           for k in RAYS_KEYS))
        self.num_rays = self.images.shape[0]

    def generate_lit_rays(self, num: int = 10, near: float = 0.0,
                          far: float = 10.0) -> Rays:
        return generate_lit_rays(num, near, far, radius=float(self.radii))

    def __len__(self) -> int:
        if self.split == "train":
            return self.num_rays
        return len(self.images)

    def __getitem__(self, index: int):
        """val: one whole panorama; train: one ray of the flat set."""
        rays = (Rays(*(getattr(self.rays, k)[index] for k in RAYS_KEYS))
                if self.split == "train" else self.rays[index])
        return (rays, self.images[index], self.depths[index],
                self.normals[index], self.albedos[index])
