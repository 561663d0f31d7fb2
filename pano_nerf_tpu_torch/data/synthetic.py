"""Procedural panoramic scene generator (numpy): an analytic Lambertian room.

Counterpart of pano_nerf_tpu/data/synthetic.py for the default box room
(`SceneSpec()`: one ceiling emitter, smooth "wave" albedo, no occluders):
the same arithmetic, so the same arguments write the same EXR files.
Radiance is a pure function of the 3-D hit point, so the views agree and a
radiance field can fit them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np

from pano_nerf_tpu_torch.data.io_exr import write_exr
from pano_nerf_tpu_torch.data.pano_dataset import bld_to_wd, equirect_camera_dirs

# Face order: [-x, +x, -y, +y, -z, +z] (y is up; face 3 is the ceiling).
_FACE_NORMALS = np.array([
    [-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1],
], dtype=np.float64)
_FACE_BASE_ALBEDO = np.array([
    [0.70, 0.25, 0.20], [0.20, 0.60, 0.65], [0.45, 0.40, 0.35],
    [0.75, 0.75, 0.70], [0.25, 0.30, 0.65], [0.60, 0.55, 0.20],
])


@dataclasses.dataclass(frozen=True)
class Emitter:
    """A square emissive patch: `center` on the face's two tangent axes
    (ascending axis order), half-extent `half`, HDR `radiance`."""
    face: int = 3
    center: Tuple[float, float] = (0.0, 0.0)
    half: float = 1.3
    radiance: Tuple[float, float, float] = (9.0, 8.4, 7.2)


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Box-room half-extents and emissive patches."""
    box: Tuple[float, float, float] = (2.0, 1.5, 2.5)
    emitters: Tuple[Emitter, ...] = (Emitter(),)


def _face_point(spec: SceneSpec, e: Emitter) -> np.ndarray:
    axis = e.face // 2
    oth = [a for a in range(3) if a != axis]
    c = np.zeros(3)
    c[axis] = (1.0 if e.face % 2 else -1.0) * spec.box[axis]
    c[oth[0]], c[oth[1]] = e.center
    return c


def _intersect_box(origins: np.ndarray, dirs: np.ndarray, box: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ray/box-interior intersection: t [N], hit points [N, 3], face [N]."""
    n = origins.shape[0]
    t_best = np.full(n, np.inf)
    face = np.zeros(n, dtype=np.int64)
    for axis in range(3):
        for sign, f in ((-1.0, 2 * axis), (1.0, 2 * axis + 1)):
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (sign * box[axis] - origins[:, axis]) / dirs[:, axis]
            valid = (t > 1e-6) & np.isfinite(t) & (t < t_best)
            if not valid.any():
                continue
            p = origins[valid] + t[valid, None] * dirs[valid]
            oth = [a for a in range(3) if a != axis]
            inside = ((np.abs(p[:, oth[0]]) <= box[oth[0]] + 1e-9)
                      & (np.abs(p[:, oth[1]]) <= box[oth[1]] + 1e-9))
            idx = np.where(valid)[0][inside]
            t_best[idx] = t[idx]
            face[idx] = f
    with np.errstate(invalid="ignore"):
        pts = origins + t_best[:, None] * dirs
    return t_best, pts, face


def _albedo_at(pts: np.ndarray, face: np.ndarray) -> np.ndarray:
    """Per-face base albedo under a smooth wave, clipped to [0.05, 0.8]."""
    wave = 0.5 + 0.5 * np.sin(2.1 * pts[:, 0]) * np.cos(1.7 * pts[:, 2]) \
        * np.sin(1.3 * pts[:, 1] + 0.7)
    alb = _FACE_BASE_ALBEDO[face] * (0.6 + 0.4 * wave[:, None])
    return np.clip(alb, 0.05, 0.8)


def _emitter_mask(e: Emitter, pts: np.ndarray, face: np.ndarray
                  ) -> np.ndarray:
    oth = [a for a in range(3) if a != e.face // 2]
    return ((face == e.face)
            & (np.abs(pts[:, oth[0]] - e.center[0]) < e.half)
            & (np.abs(pts[:, oth[1]] - e.center[1]) < e.half))


def _irradiance_at(spec: SceneSpec, pts: np.ndarray, normals: np.ndarray
                   ) -> np.ndarray:
    """Point-source irradiance of each patch plus a constant ambient."""
    total = np.zeros((pts.shape[0], 3))
    for e in spec.emitters:
        c = _face_point(spec, e)
        n_e = -_FACE_NORMALS[e.face]
        rad = np.asarray(e.radiance, dtype=np.float64)
        area = (2 * e.half) ** 2
        v = c - pts
        d2 = np.sum(v * v, axis=-1) + 1e-6
        lv = v / np.sqrt(d2)[:, None]
        cos_r = np.clip(np.sum(normals * lv, axis=-1), 0.0, None)
        cos_l = np.clip(np.sum(-lv * n_e, axis=-1), 0.0, None)
        mean_L = rad.mean()
        direct = mean_L * area * cos_r * cos_l / d2
        ambient = 0.35 * mean_L * area / 20.0
        total = total + (direct + ambient)[:, None] * (rad / mean_L)
    return total


def render_pano(origin: np.ndarray, height: int, width: int,
                spec: SceneSpec = SceneSpec()):
    """Render one panorama quad set from a camera at `origin` (y-up).

    Returns float32 image [H,W,3] (HDR), albedo [H,W,3], normal [H,W,3]
    (in [0, 1] encoding) and depth [H,W,1].
    """
    dirs, _ = equirect_camera_dirs(height, width)
    dirs = dirs.reshape(-1, 3).astype(np.float64)
    origins = np.broadcast_to(origin, dirs.shape)
    t, pts, face = _intersect_box(origins, dirs,
                                  np.asarray(spec.box, dtype=np.float64))
    normals = -_FACE_NORMALS[face]
    albedo = _albedo_at(pts, face)
    radiance = albedo / np.pi * _irradiance_at(spec, pts, normals)
    for e in spec.emitters:
        radiance[_emitter_mask(e, pts, face)] = e.radiance
    out = {
        "image": radiance.reshape(height, width, 3),
        "albedo": albedo.reshape(height, width, 3),
        "normal": ((normals + 1) / 2).reshape(height, width, 3),
        "depth": t.reshape(height, width, 1),
    }
    return {k: v.astype(np.float32) for k, v in out.items()}


def generate_scene(out_dir: str, n_views: int = 6, height: int = 64,
                   width: int = 128, seed: int = 0,
                   spec: SceneSpec = SceneSpec()) -> dict:
    """Write a scene in the reference's on-disk layout: EXR quads under
    {image,albedo,normal,depth}/NNN.exr plus transforms_all.json. Camera
    origins are drawn from `seed`; files are stored at height x width."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    meta = {m: [] for m in ("image", "albedo", "normal", "depth")}
    b2w_inv = np.linalg.inv(bld_to_wd())
    for i in range(n_views):
        origin = rng.uniform(-0.5, 0.5, 3) * np.array([1.0, 0.6, 1.0])
        quads = render_pano(origin, height, width, spec)
        # The loader reconstructs origin as translate @ bld_to_wd().
        mx = np.eye(4)
        mx[:3, -1] = origin @ b2w_inv
        for material, img in quads.items():
            os.makedirs(os.path.join(out_dir, material), exist_ok=True)
            rel = f"{material}/{i:03d}"
            write_exr(os.path.join(out_dir, rel + ".exr"), img,
                      pixel_type="float")
            meta[material].append({"file_path": rel,
                                   "transform_matrix": mx.tolist()})
    with open(os.path.join(out_dir, "transforms_all.json"), "w") as fp:
        json.dump(meta, fp)
    return meta
