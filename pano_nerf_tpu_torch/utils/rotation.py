"""Rotations: Rodrigues rotations onto target vectors, and Haar-uniform
random rotations from injected normals.

Counterpart of pano_nerf_tpu/utils/rotation.py. `rot_to_target`,
`batched_rot_to_target` and `RotToTarget` are numpy, copied so that the
port imports nothing of the JAX package. `random_rotations` is torch and
takes its randomness as an argument: the standard normals `q` [..., 4]
that JAX draws from its key (`jax.random.normal(key, batch + (4,))`),
drawn by the caller (a `torch.Generator` in training, JAX's key replayed
in the tests).
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _skew(v: np.ndarray) -> np.ndarray:
    """[..., 3] -> [..., 3, 3] skew-symmetric cross-product matrices."""
    zeros = np.zeros_like(v[..., 0])
    return np.stack([
        np.stack([zeros, -v[..., 2], v[..., 1]], -1),
        np.stack([v[..., 2], zeros, -v[..., 0]], -1),
        np.stack([-v[..., 1], v[..., 0], zeros], -1),
    ], axis=-2)


def rot_to_target(target_vec: np.ndarray,
                  origin_vec=np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """Rotation matrix taking `origin_vec` to a single unit `target_vec`
    (the antipode: 180 degrees about x)."""
    target_vec = np.asarray(target_vec, dtype=np.float64)
    origin_vec = np.asarray(origin_vec, dtype=np.float64)
    if np.array_equal(origin_vec, -target_vec):
        return np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]])
    cos = np.dot(origin_vec, target_vec) / (
        np.linalg.norm(origin_vec) * np.linalg.norm(target_vec))
    theta = np.arccos(np.clip(cos, -1.0, 1.0))
    n = np.cross(origin_vec, target_vec)
    n = n / np.linalg.norm(n)
    K = _skew(n)
    return np.eye(3) + np.sin(theta) * K + K @ K * (1 - np.cos(theta))


def batched_rot_to_target(target_vecs: np.ndarray,
                          origin_vec=np.array([0.0, 1.0, 0.0])
                          ) -> np.ndarray:
    """Rotation matrices taking `origin_vec` to each of [B, 3] unit
    targets; antipodal targets get 180 degrees about x."""
    t = np.asarray(target_vecs, dtype=np.float64)
    o = np.asarray(origin_vec, dtype=np.float64)
    cos = np.clip(t @ o, -1.0, 1.0)                # [B]
    theta = np.arccos(cos)[:, None, None]
    n = np.cross(np.broadcast_to(o, t.shape), t)   # [B, 3]
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    K = _skew(n)
    R = (np.eye(3)[None] + np.sin(theta) * K
         + K @ K * (1 - np.cos(theta)))
    flip = np.isclose(cos, -1.0)
    R[flip] = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]])
    return R


class RotToTarget:
    """Stateless batched-rotation facade (`rot2t`)."""

    def rot2t(self, tvec: np.ndarray) -> np.ndarray:
        return batched_rot_to_target(np.asarray(tvec).reshape(-1, 3))


def random_rotations(q: Tensor) -> Tensor:
    """Haar-uniform SO(3) matrices [..., 3, 3] from standard normals q
    [..., 4]: q normalized is uniform on S^3, which double-covers SO(3)
    uniformly (the quaternion method)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], -1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], -1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], -1)
    return torch.stack([r0, r1, r2], dim=-2)


def rotate(R: Tensor, dirs: Tensor) -> Tensor:
    """Each of the rotations R [B, 3, 3] applied to every direction of
    dirs [D, 3] or [B, D, 3]: [B, D, 3] (JAX's einsum "bij,dj->bdi"),
    as elementwise products summed over j, so that no matmul mode of
    the card rounds it."""
    d = dirs[None] if dirs.ndim == 2 else dirs
    return torch.sum(R[:, None, :, :] * d[..., None, :], dim=-1)
