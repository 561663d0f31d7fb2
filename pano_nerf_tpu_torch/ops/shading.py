"""Surface shading: BRDFs, irradiance integrals, solid angles, tone mapping.

Counterpart of pano_nerf_tpu/ops/shading.py. Layout is [B, D, ...]
(batch, light direction), channels last. The model paths shade with the
Lambertian `surface_rendering`; the GGX microfacet and Blinn-Phong BRDFs,
the weighted-environment, hemispherical and point-light variants are the
JAX package's (and the reference's) other shading functions, which no
model path calls.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from pano_nerf_tpu_torch.ops.mip import safe_normalize

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


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1, keepdim=True)


def _finite(x: Tensor) -> Tensor:
    """NaN and +inf to 0, as JAX's nan_to_num(nan=0, posinf=0)."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0)


def microfacet_brdf(albedo: Tensor, normal: Tensor, roughness: Tensor,
                    l: Tensor, v: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """UE4-style GGX microfacet BRDF (image-based-lighting k).

    albedo [B, 3]; normal [B, 3]; roughness [B, 1]; l [B, D, 3]; v [B, 3].
    Returns diffuse_brdf [B, D, 3], specular_brdf [B, D, 1], N.L [B, D,
    1].
    """
    D = l.shape[-2]
    diffuse_brdf = (albedo / math.pi)[..., None, :].expand(
        *albedo.shape[:-1], D, 3)
    n, vv, r = normal[..., None, :], v[..., None, :], roughness[..., None, :]
    h = safe_normalize(l + vv)   # finite backward at l == -v
    n_dot_h = torch.relu(_dot(n, h))
    v_dot_h = torch.relu(_dot(vv, h))
    n_dot_l = torch.relu(_dot(n, l))
    n_dot_v = torch.relu(_dot(n, vv))
    f0 = 0.04
    alpha = r ** 2
    k = r ** 2 / 2.0
    d_term = alpha ** 2 / (math.pi * ((n_dot_h ** 2) * (alpha ** 2 - 1.0)
                                      + 1.0) ** 2)
    f_term = f0 + (1.0 - f0) * 2.0 ** (-(5.55473 * v_dot_h + 6.98316)
                                       * v_dot_h)
    g_term = ((n_dot_l / ((1.0 - k) * n_dot_l + k))
              * (n_dot_v / ((1.0 - k) * n_dot_v + k)))
    denom = 4.0 * n_dot_l * n_dot_v
    specular = torch.where(
        denom > 0, d_term * f_term * g_term / torch.clamp(denom, min=1e-12),
        torch.zeros_like(denom))
    return diffuse_brdf, _finite(specular), n_dot_l


def blinn_phong_brdf(albedo: Tensor, normal: Tensor, roughness: Tensor,
                     l: Tensor, v: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Blinn-Phong BRDF: diffuse_brdf [B, D, 3], specular (N.H)^roughness
    [B, D, 1] and the unclamped N.L [B, D, 1]."""
    D = l.shape[-2]
    diffuse_brdf = (albedo / math.pi)[..., None, :].expand(
        *albedo.shape[:-1], D, 3)
    n, vv = normal[..., None, :], v[..., None, :]
    h = safe_normalize(l + vv)
    n_dot_h = torch.relu(_dot(n, h))
    specular = _finite(n_dot_h ** roughness[..., None, :])
    return diffuse_brdf, specular, _dot(n, l)


def surface_rendering_wlit(env: Tensor, env_weight: Tensor, albedo: Tensor,
                           normal: Tensor, l: Tensor, solid_angle: Tensor
                           ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Lambertian shading under K weighted environment maps.

    env [B, K, D, 3]; env_weight [B, K]; albedo, normal [B, 3]; l [B, D,
    3]; solid_angle [D, 1]. Returns (rgb, diffuse, specular = 0,
    shading), each [B, 3]. (JAX's takes a `roughness` that must be None
    and a `v` it does not read.)
    """
    diffuse_brdf, n_dot_l = lambertian_brdf(albedo, normal, l)
    sa = solid_angle.reshape(1, 1, -1, 1)
    shading = torch.sum(env * n_dot_l[:, None] * sa, dim=2)
    shading = torch.sum(shading * env_weight[..., None], dim=1)
    diffuse = diffuse_brdf * shading
    return diffuse, diffuse, torch.zeros_like(diffuse), shading


def surface_rendering_hemi(env: Tensor, env_weight: Tensor, albedo: Tensor,
                           n_dot_l: Tensor, solid_angle: Tensor
                           ) -> Tuple[Tensor, Tensor, None, Tensor]:
    """Hemispherical lighting with a fixed N.L per direction.

    env [B, K, D, 3]; env_weight [B, K]; albedo [B, 3]; n_dot_l,
    solid_angle [D, 1]. Returns (rgb, diffuse, None, shading)."""
    sa = solid_angle.reshape(1, 1, -1, 1)
    shading = torch.sum(env * n_dot_l.reshape(1, 1, -1, 1) * sa, dim=2)
    shading = torch.sum(shading * env_weight[..., None], dim=1)
    diffuse = albedo / math.pi * shading
    return diffuse, diffuse, None, shading


def wrap_sg_lit(sg_lit: Tensor, position: Tensor) -> Tensor:
    """Spherical-gaussian point lights [N, 8] (color 3 | dir 3 | dist |
    steradian) re-anchored at the surface points [B, 3]: [B, N, 8] with
    each light's direction, distance and steradian seen from the point."""
    lit_col, lit_dir = sg_lit[:, :3], sg_lit[:, 3:6]
    lit_dist, lit_ster = sg_lit[:, 6:7], sg_lit[:, 7:8]
    new_vec = (lit_dir * lit_dist)[None] - position[:, None]
    new_dist = torch.linalg.norm(new_vec, dim=-1, keepdim=True)
    new_dir = new_vec / torch.clamp(new_dist, min=1e-12)
    new_ster = lit_ster[None] * lit_dist[None] ** 2 / (new_dist ** 2 + 1e-8)
    col = lit_col[None].expand(position.shape[0], *lit_col.shape)
    return torch.cat([col, new_dir, new_dist, new_ster], dim=-1)


def surface_rendering_point_lit(point_lit: Tensor, albedo: Tensor,
                                normal: Tensor, position: Tensor
                                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Lambertian shading from point lights (`wrap_sg_lit`); returns
    (rgb, diffuse, specular = 0, shading), each [B, 3]."""
    lit = wrap_sg_lit(point_lit, position)
    diffuse_brdf, n_dot_l = lambertian_brdf(albedo, normal, lit[..., 3:6])
    shading = torch.sum(lit[..., :3] * n_dot_l * lit[..., 7:8], dim=1)
    diffuse = diffuse_brdf * shading
    return diffuse, diffuse, torch.zeros_like(diffuse), shading
