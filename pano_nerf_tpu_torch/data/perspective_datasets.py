"""Perspective-camera dataset family: Multicam, Blender, RealData360.

Counterpart of pano_nerf_tpu/data/perspective_datasets.py: multiscale
Blender ("Multicam") metadata.json scenes, classic NeRF-Blender
transforms_*.json scenes, and LLFF/360 captures with COLMAP intrinsics and
pose recentering / spherification. Host-side numpy with the same
flatten/iterate surface as the JAX loaders; images are read by the port's
own PNG reader (`data/png.py`, 8- or 16-bit, scaled to [0, 1]), and the
rays are the port's `core/rays.py` `Rays` of numpy arrays
(`rays_to_tensors` puts them on a device). No model path reads these
scenes; the panorama loader is `data/pano_dataset.py`.
"""

from __future__ import annotations

import json
import os
import struct
from os import path

import numpy as np

from pano_nerf_tpu_torch.core.rays import RAYS_KEYS, Rays
from pano_nerf_tpu_torch.data.png import read_png


def _load_png(fname: str) -> np.ndarray:
    """[H, W, C] float32 in [0, 1] (8-bit samples over 255, 16-bit over
    65535)."""
    img = read_png(fname)
    return img.astype(np.float32) / float(np.iinfo(img.dtype).max)


def _area_resize(image: np.ndarray, factor: int) -> np.ndarray:
    h, w = image.shape[:2]
    nh, nw = h // factor, w // factor
    image = image[: nh * factor, : nw * factor]
    return image.reshape(nh, factor, nw, factor, -1).mean(axis=(1, 3))


def _dx_radii(directions: np.ndarray) -> np.ndarray:
    """Cone radii from vertical neighbor spacing (mip-NeRF convention).

    As the reference's datasets/base_datasets.py:157-166.
    """
    dx = np.sqrt(np.sum((directions[:-1] - directions[1:]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1]], 0)
    return dx[..., None] * 2 / np.sqrt(12)


class PerspectiveDataset:
    """Shared flatten/batch/access plumbing (mirrors BaseDataset)."""

    def __init__(self, data_dir: str, split: str = "train",
                 white_bkgd: bool = True, factor: int = 0):
        self.data_dir = data_dir
        self.split = split
        self.white_bkgd = white_bkgd
        self.factor = factor
        self.near, self.far = 2.0, 6.0

        self._load_renderings()
        self._generate_rays()
        if split == "train":
            self._flatten_all()

    # subclass hooks -----------------------------------------------------
    def _load_renderings(self):
        raise NotImplementedError

    def _generate_rays(self):
        raise NotImplementedError

    # shared -------------------------------------------------------------
    def _flatten_all(self) -> None:
        def flat(xs):
            return np.concatenate([x.reshape(-1, x.shape[-1]) for x in xs], 0)

        self.images = flat(self.images)
        self.rays = Rays(*(flat(getattr(self.rays, k)) for k in RAYS_KEYS))
        self.num_rays = self.images.shape[0]

    def __len__(self):
        if self.split == "train":
            return self.num_rays
        return self.n_examples

    def __getitem__(self, index: int):
        rays = Rays(*(getattr(self.rays, k)[index] for k in RAYS_KEYS))
        return rays, self.images[index]

    def iter_batches(self, batch_size: int, seed: int = 0):
        assert self.split == "train"
        rng = np.random.default_rng(seed)
        n = self.num_rays
        while True:
            perm = rng.permutation(n)
            for s in np.arange(0, n - batch_size + 1, batch_size):
                idx = perm[s:s + batch_size]
                rays = Rays(*(getattr(self.rays, k)[idx] for k in RAYS_KEYS))
                yield rays, self.images[idx]

    def _finalize_rays(self, origins, directions, lossmult, near, far):
        viewdirs = [v / np.linalg.norm(v, axis=-1, keepdims=True)
                    for v in directions]
        radii = [_dx_radii(v) for v in directions]
        noise = [np.zeros_like(o[..., :1]) for o in origins]
        self.rays = Rays(origins=origins, directions=directions,
                         viewdirs=viewdirs, radii=radii, lossmult=lossmult,
                         near=near, far=far, noise_var=noise)


class Multicam(PerspectiveDataset):
    """Multiscale Blender scenes via metadata.json.

    As the reference loader, datasets/base_datasets.py:88-170.
    """

    def _load_renderings(self):
        with open(os.path.join(self.data_dir, "metadata.json")) as fp:
            self.meta = json.load(fp)[self.split]
        self.meta = {k: np.array(self.meta[k]) for k in self.meta}
        images = []
        for relative_path in self.meta["file_path"]:
            image = _load_png(os.path.join(self.data_dir, relative_path))
            if self.white_bkgd:
                image = image[..., :3] * image[..., -1:] + (1.0 - image[..., -1:])
            images.append(image[..., :3])
        self.images = images
        self.n_examples = len(images)

    def _generate_rays(self):
        pix2cam = self.meta["pix2cam"].astype(np.float32)
        cam2world = self.meta["cam2world"].astype(np.float32)
        width = self.meta["width"].astype(np.float32)
        height = self.meta["height"].astype(np.float32)

        def grid(w, h):
            return np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                               np.arange(h, dtype=np.float32) + 0.5,
                               indexing="xy")

        xy = [grid(w, h) for w, h in zip(width, height)]
        pixel_dirs = [np.stack([x, y, np.ones_like(x)], -1) for x, y in xy]
        camera_dirs = [v @ p2c[:3, :3].T for v, p2c in zip(pixel_dirs, pix2cam)]
        directions = [(v @ c2w[:3, :3].T).astype(np.float32)
                      for v, c2w in zip(camera_dirs, cam2world)]
        origins = [np.broadcast_to(c2w[:3, -1], v.shape).astype(np.float32).copy()
                   for v, c2w in zip(directions, cam2world)]

        def scalar(key):
            return [np.broadcast_to(self.meta[key][i],
                                    origins[i][..., :1].shape
                                    ).astype(np.float32).copy()
                    for i in range(self.n_examples)]

        self._finalize_rays(origins, directions, scalar("lossmult"),
                            scalar("near"), scalar("far"))


class Blender(PerspectiveDataset):
    """Classic NeRF-Blender scenes via transforms_{split}.json.

    As the reference loader, datasets/base_datasets.py:173-265
    (`Blender_archive`).
    """

    def _load_renderings(self):
        with open(path.join(self.data_dir,
                            f"transforms_{self.split}.json")) as fp:
            meta = json.load(fp)
        images, cams = [], []
        for frame in meta["frames"]:
            image = _load_png(os.path.join(self.data_dir,
                                           frame["file_path"] + ".png"))
            if self.factor == 2:
                image = _area_resize(image, 2)
            elif self.factor > 0:
                raise ValueError(
                    f"Blender dataset only supports factor 0 or 2, got {self.factor}")
            cams.append(np.array(frame["transform_matrix"], dtype=np.float32))
            if self.white_bkgd:
                image = image[..., :3] * image[..., -1:] + (1.0 - image[..., -1:])
            images.append(image[..., :3])
        self.images = images
        self.h, self.w = images[0].shape[:2]
        self.camtoworlds = cams
        self.focal = 0.5 * self.w / np.tan(0.5 * float(meta["camera_angle_x"]))
        self.n_examples = len(images)

    def _generate_rays(self):
        x, y = np.meshgrid(np.arange(self.w, dtype=np.float32),
                           np.arange(self.h, dtype=np.float32), indexing="xy")
        camera_dirs = np.stack(
            [(x - self.w * 0.5 + 0.5) / self.focal,
             -(y - self.h * 0.5 + 0.5) / self.focal, -np.ones_like(x)], -1)
        directions = [(camera_dirs @ c2w[:3, :3].T).astype(np.float32)
                      for c2w in self.camtoworlds]
        origins = [np.broadcast_to(c2w[:3, -1], v.shape).astype(np.float32).copy()
                   for v, c2w in zip(directions, self.camtoworlds)]

        def scalar(v):
            return [np.full_like(origins[i][..., :1], v)
                    for i in range(self.n_examples)]

        self._finalize_rays(origins, directions, scalar(1.0),
                            scalar(self.near), scalar(self.far))


# ---------------------------------------------------------------------------
# COLMAP + LLFF/360 pose machinery
# ---------------------------------------------------------------------------

def read_colmap_intrinsics(sparse_dir: str) -> np.ndarray:
    """Read the first camera's K from COLMAP's binary cameras.bin.

    As the reference's minimal reader (datasets/base_datasets.py:399-423):
    assumes a 4-parameter (PINHOLE-style fx fy cx cy) camera.
    """
    with open(path.join(sparse_dir, "cameras.bin"), "rb") as fid:
        struct.unpack("<Q", fid.read(8))  # num_cameras
        struct.unpack("<iiQQ", fid.read(24))  # id, model, width, height
        params = struct.unpack("<dddd", fid.read(32))
    return np.array([[params[0], 0, params[2]],
                     [0, params[1], params[3]],
                     [0, 0, 1]])


def normalize_vec(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Look-at camera matrix, as the reference's base_datasets.py:437-444."""
    vec2 = normalize_vec(z)
    vec0 = normalize_vec(np.cross(up, vec2))
    vec1 = normalize_vec(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """Average pose, as the reference's base_datasets.py:425-432."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize_vec(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Recenter poses on their average, as the reference's
    base_datasets.py:386-397."""
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses4 = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses4 = np.linalg.inv(c2w) @ poses4
    poses_[:, :3, :4] = poses4[:, :3, :4]
    return poses_


def spherify_poses(poses: np.ndarray) -> np.ndarray:
    """Re-orient an inward-facing capture around its minimum-distance point.

    As the reference loader, base_datasets.py:447-476.
    """
    p34_to_44 = lambda p: np.concatenate([
        p, np.tile(np.reshape(np.eye(4)[-1], [1, 1, 4]), [p.shape[0], 1, 1])
    ], 1)
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -a_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0))
        @ b_i.mean(0))

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize_vec(up)
    vec1 = normalize_vec(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize_vec(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)
    poses_reset = (np.linalg.inv(p34_to_44(c2w[None]))
                   @ p34_to_44(poses[:, :3, :4]))
    return np.concatenate([
        poses_reset[:, :3, :4],
        np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape),
    ], -1)


class RealData360(PerspectiveDataset):
    """Real 360-degree captures (LLFF poses_bounds.npy + COLMAP intrinsics).

    As the reference loader, datasets/base_datasets.py:268-476.
    """

    def _load_renderings(self):
        suffix = f"_{self.factor}" if self.factor > 0 else ""
        imgdir = path.join(self.data_dir, "images" + suffix)
        if not path.exists(imgdir):
            raise ValueError(f"Image folder {imgdir} does not exist.")
        imgfiles = [path.join(imgdir, f) for f in sorted(os.listdir(imgdir))
                    if f.lower().endswith(("jpg", "png"))]
        images = np.stack([_load_png(f) for f in imgfiles], axis=-1)

        with open(path.join(self.data_dir, "poses_bounds.npy"), "rb") as fp:
            poses_arr = np.load(fp)
        poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
        bds = poses_arr[:, -2:].transpose([1, 0])
        if poses.shape[-1] != images.shape[-1]:
            raise RuntimeError(
                f"Mismatch between imgs {images.shape[-1]} and poses "
                f"{poses.shape[-1]}")

        poses[:2, 4, :] = np.array(images.shape[:2]).reshape([2, 1])
        poses[2, 4, :] = poses[2, 4, :] / self.factor
        # LLFF [down right back] -> [right up back].
        poses = np.concatenate(
            [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
        poses = np.moveaxis(poses, -1, 0).astype(np.float32)
        images = np.moveaxis(images, -1, 0)
        bds = np.moveaxis(bds, -1, 0).astype(np.float32)

        poses = recenter_poses(poses)
        poses = spherify_poses(poses)

        i_test = np.arange(images.shape[0])[::8]
        indices = (np.array([i for i in np.arange(images.shape[0])
                             if i not in i_test])
                   if self.split == "train" else i_test)
        self.images = images[indices]
        poses = poses[indices]
        self.bds = bds[indices]

        self.K = read_colmap_intrinsics(
            path.join(self.data_dir, "sparse", "0"))
        self.K[:2, :] /= self.factor
        self.K_inv = np.linalg.inv(self.K)
        self.K_inv[1:, :] *= -1

        self.camtoworlds = poses[:, :3, :4]
        self.focal = poses[0, -1, -1]
        self.h, self.w = self.images.shape[1:3]
        self.n_examples = self.images.shape[0]

    def _generate_rays(self):
        xy = np.meshgrid(np.arange(self.w, dtype=np.float32) + 0.5,
                         np.arange(self.h, dtype=np.float32) + 0.5,
                         indexing="xy")
        pixel_dirs = np.stack([xy[0], xy[1], np.ones_like(xy[0])], -1)
        camera_dirs = pixel_dirs @ self.K_inv.T
        directions = ((camera_dirs[None, ..., None, :]
                       * self.camtoworlds[:, None, None, :3, :3]).sum(-1))
        origins = np.broadcast_to(
            self.camtoworlds[:, None, None, :3, -1], directions.shape)
        viewdirs = directions / np.linalg.norm(directions, axis=-1,
                                               keepdims=True)
        dx = np.sqrt(np.sum(
            (directions[:, :-1] - directions[:, 1:]) ** 2, -1))
        dx = np.concatenate([dx, dx[:, -2:-1]], 1)
        radii = dx[..., None] * 2 / np.sqrt(12)
        ones = np.ones_like(origins[..., :1])
        near_fars = np.broadcast_to(self.bds[:, None, None, :],
                                    (*directions.shape[:-1], 2))
        self.rays = Rays(
            origins=origins.astype(np.float32),
            directions=directions.astype(np.float32),
            viewdirs=viewdirs.astype(np.float32),
            radii=radii.astype(np.float32),
            lossmult=ones.astype(np.float32),
            near=near_fars[..., 0:1].astype(np.float32),
            far=near_fars[..., 1:2].astype(np.float32),
            noise_var=np.zeros_like(ones, dtype=np.float32))
        # Array-per-image lists expected by _flatten_all.
        self.images = list(self.images)
        self.rays = Rays(*(list(getattr(self.rays, k)) for k in RAYS_KEYS))
