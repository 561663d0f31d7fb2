"""Lambertian surface shading, solid angles and tone mapping.

Counterpart of the eval subset of pano_nerf_tpu/ops/shading.py. Layout is
[B, D, ...] (batch, light direction), channels last.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor

_ACES_A, _ACES_B, _ACES_C, _ACES_D, _ACES_E = 2.51, 0.03, 2.43, 0.59, 0.14
_LUMA = (0.2126, 0.7152, 0.0722)


def lambertian_brdf(albedo: Tensor, normal: Tensor, l: Tensor,
                    cos_th: float = 0.0) -> Tuple[Tensor, Tensor]:
    """albedo, normal [B, 3]; l [B, D, 3] -> (albedo / pi, N.L [B, D, 1])."""
    n_dot_l = torch.sum(normal[..., None, :] * l, dim=-1, keepdim=True)
    return albedo / math.pi, torch.relu(n_dot_l - cos_th) + cos_th


def surface_rendering(env: Tensor, albedo: Tensor, normal: Tensor,
                      l: Tensor, solid_angle: Tensor
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Lambertian irradiance integral over the env directions.

    diffuse = albedo/pi * sum_d env_d * max(N.L_d, 0) * dOmega_d.
    env [B, D, 3]; albedo, normal [B, 3]; l [B, D, 3]; solid_angle
    [D, 1] or [1, D, 1]. Returns (rgb, diffuse, specular = 0, shading),
    each [B, 3].
    """
    if solid_angle.ndim == 2:
        solid_angle = solid_angle[None]
    diffuse_brdf, n_dot_l = lambertian_brdf(albedo, normal, l)
    shading = torch.sum(env * n_dot_l * solid_angle, dim=-2)
    diffuse = diffuse_brdf * shading
    specular = torch.zeros_like(diffuse)
    return diffuse + specular, diffuse, specular, shading


def solid_angle_refinement(h: int = 8, w: int = 16, hemisp: bool = False
                           ) -> np.ndarray:
    """Per-cell solid angles of an equirect grid, [1, h*w, 1] float32."""
    phi_range = np.pi / 2 if hemisp else np.pi
    d_phi = phi_range / h
    d_theta = 2 * np.pi / w
    yy = (np.arange(h, dtype=np.float64) + 0.5) / h
    sin_phi = np.sin(yy * phi_range)
    solid_angle = np.tile(sin_phi[:, None], (1, w)) * d_theta * d_phi
    return solid_angle.reshape(1, -1, 1).astype(np.float32)


def hdr_to_ldr(color: Union[np.ndarray, Tensor], gamma: float = 2.2,
               quantize: bool = False, clamp: bool = True):
    """ACES filmic tone map + gamma encode (numpy or torch input).

    `quantize` floors to 8-bit levels, as the reference does for ground
    truth.
    """
    color = (color * (_ACES_A * color + _ACES_B)) / (
        color * (_ACES_C * color + _ACES_D) + _ACES_E)
    if isinstance(color, Tensor):
        if clamp:
            color = color.clamp(0.0, 1.0)
        if quantize:
            color = torch.floor(color * 255.0) / 255.0
        else:
            color = color.clamp(min=1e-10)
        return color ** (1.0 / gamma)
    if clamp:
        color = np.clip(color, 0.0, 1.0)
    if quantize:
        color = np.floor(color * 255.0).astype(np.uint8).astype(
            np.float32) / 255.0
    return color ** (1.0 / gamma)


def compute_illumination(x: Tensor) -> Tensor:
    """Rec.709 luma of channels-last RGB, [..., 1]."""
    # Channel by channel: a tensor of the weights would be a host-to-device
    # copy, which a CUDA graph cannot capture.
    return (x[..., 0:1] * _LUMA[0] + x[..., 1:2] * _LUMA[1]
            + x[..., 2:3] * _LUMA[2])
