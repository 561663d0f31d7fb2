"""mip-NeRF core math: frustums, sampling, encodings, compositing.

Counterpart of the eval and training subsets of pano_nerf_tpu/ops/mip.py:
conical frustum Gaussians, stratified ray and env-ray sampling, blurpool
inverse-CDF resampling, integrated and classic positional encodings,
alpha compositing, the distortion loss, `safe_normalize`, the
importance-sampled and stratified env directions, and the mip-NeRF 360
ops (`sample_along_rays_360`, `contract`, `integrated_pos_enc_360`) and
`volumetric_lighting_composing`, which no model path calls. Everything is
float32. Randomness is injected: the randomized samplers take their
standard uniforms (or Gumbel noise) as arguments, drawn by the caller
(a `torch.Generator` in training, JAX's key schedule replayed in the
tests), and are deterministic without them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
_F32_EPS = float(torch.finfo(torch.float32).eps)


def _linspace(stop: float, num: int, like: Tensor) -> Tensor:
    """[0, stop] in `num` steps as i * (stop / (num - 1)): the float32
    values of `jnp.linspace(0, 1, num)`."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=like.device)
    i = torch.arange(num, dtype=torch.float32, device=like.device)
    u = i * torch.tensor(stop / (num - 1), dtype=torch.float32)
    u[-1:].fill_(stop)
    return u


def lift_gaussian(directions: Tensor, t_mean: Tensor, t_var: Tensor,
                  r_var: Tensor, diagonal: bool = True
                  ) -> Tuple[Tensor, Tensor]:
    """1-D Gaussians along rays -> 3-D Gaussians: means [..., N, 3] and
    diagonal covariances [..., N, 3] (`diagonal`) or full ones [..., N,
    3, 3] (mip-NeRF 360)."""
    mean = directions[..., None, :] * t_mean[..., :, None]
    d_sq = directions ** 2
    d_norm_sq = torch.sum(d_sq, dim=-1, keepdim=True) + 1e-10
    if diagonal:
        null_outer_diag = 1.0 - d_sq / d_norm_sq
        t_cov_diag = t_var[..., :, None] * d_sq[..., None, :]
        xy_cov_diag = r_var[..., :, None] * null_outer_diag[..., None, :]
        return mean, t_cov_diag + xy_cov_diag
    d_outer = directions[..., :, None] * directions[..., None, :]
    eye = torch.eye(directions.shape[-1], dtype=directions.dtype,
                    device=directions.device)
    null_outer = eye - directions[..., :, None] * (
        directions / d_norm_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def conical_frustum_to_gaussian(directions: Tensor, t0: Tensor, t1: Tensor,
                                base_radius: Tensor, diagonal: bool = True
                                ) -> Tuple[Tensor, Tensor]:
    """Stable Gaussian approximation of conical frustums [t0, t1]."""
    mu = (t0 + t1) / 2.0
    hw = (t1 - t0) / 2.0
    denom = 3.0 * mu ** 2 + hw ** 2
    t_mean = mu + (2.0 * mu * hw ** 2) / denom
    t_var = (hw ** 2) / 3.0 - (4.0 / 15.0) * (
        (hw ** 4 * (12.0 * mu ** 2 - hw ** 2)) / denom ** 2)
    r_var = base_radius ** 2 * ((mu ** 2) / 4.0 + (5.0 / 12.0) * hw ** 2
                                - (4.0 / 15.0) * (hw ** 4) / denom)
    return lift_gaussian(directions, t_mean, t_var, r_var, diagonal)


def cast_rays(t_samples: Tensor, origins: Tensor, directions: Tensor,
              radii: Tensor, diagonal: bool = True
              ) -> Tuple[Tensor, Tensor]:
    """Fencepost distances [..., N+1] -> means [..., N, 3] and covs
    [..., N, 3] (or [..., N, 3, 3] without `diagonal`)."""
    means, covs = conical_frustum_to_gaussian(
        directions, t_samples[..., :-1], t_samples[..., 1:], radii,
        diagonal)
    return means + origins[..., None, :], covs


def stratify(t_edges: Tensor, t_rand: Tensor) -> Tensor:
    """Jitter sorted fenceposts within their local cells (`_stratify`):
    t_rand holds standard uniforms of t_edges' shape."""
    mids = 0.5 * (t_edges[..., 1:] + t_edges[..., :-1])
    upper = torch.cat([mids, t_edges[..., -1:]], dim=-1)
    lower = torch.cat([t_edges[..., :1], mids], dim=-1)
    return lower + (upper - lower) * t_rand


def sample_along_rays(origins: Tensor, directions: Tensor, radii: Tensor,
                      num_samples: int, near: Tensor, far: Tensor,
                      disparity: bool = False,
                      t_rand: Optional[Tensor] = None
                      ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Frustums along [near, far]: evenly spaced, or stratified by the
    uniforms `t_rand` [B, N+1] (randomized=True).

    origins, directions: [B, 3]; radii, near, far: [B, 1]. Returns
    t_samples [B, N+1], (means [B, N, 3], covs [B, N, 3]).
    """
    u = _linspace(1.0, num_samples + 1, origins)
    if disparity:
        t_edges = 1.0 / (1.0 / near * (1.0 - u) + 1.0 / far * u)
    else:
        t_edges = near + (far - near) * u
    t_samples = t_edges.expand(origins.shape[:-1] + (num_samples + 1,))
    if t_rand is not None:
        t_samples = stratify(t_samples, t_rand)
    return t_samples, cast_rays(t_samples, origins, directions, radii)


def sample_env_rays(point_origins: Tensor, directions: Tensor,
                    num_samples: int, near: Tensor, far: Tensor,
                    radii: Tensor, t_rand: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tuple[Tensor, Tensor], Tensor]:
    """Secondary (irradiance) rays from surface points toward env dirs,
    stratified per (ray, direction) by `t_rand` [B, D, S+1] when given.

    point_origins: [B, 3]; directions: [D, 3]; near, far, radii: [D, 1].
    Returns t_samples [B, D, S+1], (means, covs [B, D, S, 3]), dirs
    [B, D, 3].
    """
    B, D = point_origins.shape[0], directions.shape[0]
    u = _linspace(1.0, num_samples + 1, point_origins)
    t_samples = (near + (far - near) * u).expand(B, D, num_samples + 1)
    if t_rand is not None:
        t_samples = stratify(t_samples, t_rand)
    origins = point_origins[:, None, :].expand(B, D, 3)
    dirs = directions[None].expand(B, D, 3)
    radii_b = radii[None].expand(B, D, 1)
    return t_samples, cast_rays(t_samples, origins, dirs, radii_b), dirs


def sample_env_rays_hemisphere(point_origins: Tensor, directions: Tensor,
                               num_samples: int, near: Tensor, far: Tensor,
                               radii: Tensor,
                               t_rand: Optional[Tensor] = None
                               ) -> Tuple[Tensor, Tuple[Tensor, Tensor],
                                          Tensor]:
    """`sample_env_rays` with per-point directions: point_origins [B, 3],
    directions [B, D, 3]; near, far, radii [D, 1]; stratified by `t_rand`
    [B, D, S+1] when given. Returns t_samples [B, D, S+1], (means, covs
    [B, D, S, 3]), directions."""
    B, D = directions.shape[:2]
    u = _linspace(1.0, num_samples + 1, point_origins)
    t_samples = (near + (far - near) * u).expand(B, D, num_samples + 1)
    if t_rand is not None:
        t_samples = stratify(t_samples, t_rand)
    origins = point_origins[:, None, :].expand(B, D, 3)
    radii_b = radii[None].expand(B, D, 1)
    return (t_samples, cast_rays(t_samples, origins, directions, radii_b),
            directions)


def sorted_piecewise_constant_pdf(bins: Tensor, weights: Tensor,
                                  num_samples: int,
                                  u_rand: Optional[Tensor] = None) -> Tensor:
    """Inverse-CDF samples of a piecewise-constant PDF.

    bins: [B, N+1] sorted fenceposts; weights: [B, N]. Deterministic
    samples sit at u = linspace(0, 1 - eps, num_samples); with the
    uniforms `u_rand` [B, num_samples] they sit at (i + u_rand) / n, the
    jitter scaled to [0, 1/n - eps) and u capped at 1 - eps, as in the
    randomized branch of the JAX function. Each u's CDF interval is found
    with `searchsorted` (the CDF is non-decreasing and starts at 0).
    """
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding
    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], dim=-1)   # [B, N+1]
    if u_rand is None:
        u = _linspace(1.0 - _F32_EPS, num_samples, cdf)
        u = u.expand(cdf.shape[:-1] + (num_samples,)).contiguous()
    else:
        step = 1.0 / num_samples
        u = torch.arange(num_samples, dtype=torch.float32,
                         device=cdf.device) * step
        u = torch.clamp(u + u_rand * (step - _F32_EPS), max=1.0 - _F32_EPS)
    # Largest edge with cdf <= u below, the next edge above.
    hi = torch.searchsorted(cdf.contiguous(), u, right=True)
    hi = hi.clamp(max=cdf.shape[-1] - 1)
    lo = hi - 1
    bins_lo, bins_hi = bins.gather(-1, lo), bins.gather(-1, hi)
    cdf_lo, cdf_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bins_lo + t * (bins_hi - bins_lo)


def resample_along_rays(origins: Tensor, directions: Tensor, radii: Tensor,
                        t_samples: Tensor, weights: Tensor,
                        resample_padding: float,
                        num_samples: Optional[int] = None,
                        u_rand: Optional[Tensor] = None,
                        stop_grad: bool = True
                        ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Resample frustums in proportion to the blurpooled coarse weights.

    `num_samples` sets the resampled sample count (default: as many as
    the coarse level); `u_rand` [B, num_samples + 1] randomizes the
    inverse-CDF positions. With `stop_grad` (`nerf.stop_resample_grad`)
    the new fenceposts carry no gradient and the frustums get gradients
    through the rays only; without it the gradient flows through the
    piecewise-constant inverse CDF into `weights` and `t_samples`, as
    in JAX's `resample_along_rays(stop_grad=False)`.
    """
    if stop_grad:
        weights = weights.detach()
        t_samples = t_samples.detach()
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]],
                            dim=-1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    weights_blur = weights_blur + resample_padding
    new_t = sorted_piecewise_constant_pdf(
        t_samples, weights_blur,
        (num_samples + 1) if num_samples else t_samples.shape[-1], u_rand)
    return new_t, cast_rays(new_t, origins, directions, radii)


def integrated_pos_enc(means: Tensor, covs_diag: Tensor, min_deg: int,
                       max_deg: int) -> Tensor:
    """Integrated positional encoding [..., 2 * 3 * (max_deg - min_deg)].

    Feature order: degree-major then dimension, sin block then cos block
    (cos(y) = sin(y + pi/2)). The phases 2^deg * mean are exact float32
    products.
    """
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=torch.float32,
                                 device=means.device)
    shape = means.shape[:-1] + (-1,)
    y = (means[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (covs_diag[..., None, :] * (scales ** 2)[:, None]).reshape(shape)
    x = torch.cat([y, y + 0.5 * math.pi], dim=-1)
    x_var = torch.cat([y_var, y_var], dim=-1)
    return torch.exp(-0.5 * x_var) * torch.sin(x)


def pos_enc(x: Tensor, min_deg: int, max_deg: int,
            append_identity: bool = True) -> Tensor:
    """Classic NeRF encoding [x | sin(2^k x) | cos(2^k x)], degree-major."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=torch.float32,
                                 device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if append_identity:
        return torch.cat([x, four_feat], dim=-1)
    return four_feat


def volumetric_rendering(rgb: Tensor, density: Tensor, t_samples: Tensor,
                         dirs: Tensor, white_bkgd: bool
                         ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Alpha-composite samples along rays.

    rgb [..., N, 3]; density [..., N, 1]; t_samples [..., N+1]; dirs
    [..., 3] un-normalized (its norm scales the deltas). Returns comp_rgb
    [..., 3], distance [...], acc [...], weights [..., N].
    """
    t_mids = 0.5 * (t_samples[..., :-1] + t_samples[..., 1:])
    t_interval = t_samples[..., 1:] - t_samples[..., :-1]
    delta = t_interval * torch.linalg.norm(dirs, dim=-1, keepdim=True)
    density_delta = density[..., 0] * delta
    alpha = 1.0 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([
        torch.zeros_like(density_delta[..., :1]),
        torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
    weights = alpha * trans
    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    distance = torch.sum(weights * t_mids, dim=-1) / torch.clamp(acc, min=1e-10)
    distance = torch.minimum(torch.maximum(distance, t_samples[..., 0]),
                             t_samples[..., -1])
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return comp_rgb, distance, acc, weights


def distortion_loss(t_samples: Tensor, weights: Tensor) -> Tensor:
    """Mip-NeRF 360 distortion loss on per-ray normalized distances,
    sum_ij w_i w_j |m_i - m_j| + 1/3 sum_i w_i^2 (s_{i+1} - s_i), averaged
    over rays. t_samples: [B, N+1]; weights: [B, N]."""
    near = t_samples[..., :1]
    far = t_samples[..., -1:]
    s = (t_samples - near) / torch.clamp(far - near, min=1e-10)
    mids = 0.5 * (s[..., 1:] + s[..., :-1])
    intervals = s[..., 1:] - s[..., :-1]
    dm = torch.abs(mids[..., :, None] - mids[..., None, :])
    inter = torch.sum(weights[..., :, None] * weights[..., None, :] * dm,
                      dim=(-2, -1))
    intra = torch.sum(weights ** 2 * intervals, dim=-1) / 3.0
    return torch.mean(inter + intra)


def safe_normalize(x: Tensor, eps: float = 1e-12) -> Tensor:
    """Unit vectors along the last axis; vectors shorter than eps -> 0.

    The squared norm is clamped before the sqrt, so the backward stays
    finite at x = 0 (x / max(norm, eps) would NaN there through sqrt'(0)).
    """
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    norm = torch.sqrt(torch.clamp(sq, min=eps * eps))
    return torch.where(sq >= eps * eps, x / norm, torch.zeros_like(x))


def _cap_directions(mu: Tensor, cos_half: float, u_cos: Tensor,
                    u_phi: Tensor) -> Tensor:
    """Directions uniform on the spherical caps of half-angle cosine
    `cos_half` around unit centers mu [B, D, 3], at the uniforms u_cos
    (cos theta in [cos_half, 1]) and u_phi (phi in [0, 2pi)), [B, D, 1]
    each. The frame around mu is branch-free: its reference axis is x
    where |mu_z| > 0.9, else z (built by arithmetic, so no constant
    tensor is copied to the device)."""
    ct = cos_half + (1.0 - cos_half) * u_cos
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = u_phi * 2.0 * math.pi
    near_z = (torch.abs(mu[..., 2:3]) > 0.9).to(mu.dtype)
    ref = torch.cat([near_z, torch.zeros_like(near_z), 1.0 - near_z], -1)
    a = safe_normalize(torch.linalg.cross(mu, ref, dim=-1))
    b = torch.linalg.cross(mu, a, dim=-1)
    dirs = ct * mu + st * (torch.cos(phi) * a + torch.sin(phi) * b)
    return safe_normalize(dirs)


def _caps_containing(dirs: Tensor, cell_dirs: Tensor,
                     cos_half: float) -> Tensor:
    """[B, D, C] 1.0 where direction d lies in the cap around cell c
    (with a 1e-6 slack, so a sample on its own cap's edge counts)."""
    dots = torch.sum(dirs[..., :, None, :] * cell_dirs[..., None, :, :],
                     dim=-1)
    return (dots >= cos_half - 1e-6).to(dirs.dtype)


def importance_env_directions(cell_dirs: Tensor, cell_weights: Tensor,
                              num_dirs: int, gumbel: Tensor, u_cos: Tensor,
                              u_phi: Tensor, uniform_mix: float = 0.5,
                              cap_scale: float = 2.0
                              ) -> Tuple[Tensor, Tensor]:
    """Env directions importance-sampled from per-cell weights, with the
    exact density of the process (JAX `mip.importance_env_directions`).

    Per ray: a cell c ~ p = uniform_mix / Dp + (1 - uniform_mix) w_c /
    sum(w) (uniform where every weight is 0), then a direction uniform on
    the cap of area cap_scale 4pi/Dp around its center; the pdf of a
    direction sums p over every cap that contains it. The categorical draw
    is JAX's Gumbel argmax: `gumbel` [B, num_dirs, Dp] holds the standard
    Gumbel noise (`jax.random.gumbel`), and the cell is argmax(gumbel +
    log p). u_cos, u_phi: [B, num_dirs, 1] uniforms for the cap.

    cell_dirs: [B, Dp, 3] unit cell centers; cell_weights: [B, Dp] >= 0.
    Returns dirs [B, num_dirs, 3] and inv_density [B, num_dirs, 1] =
    1 / (num_dirs pdf), the solid-angle weight of each direction.
    """
    Dp = cell_weights.shape[-1]
    wsum = torch.sum(cell_weights, dim=-1, keepdim=True)
    p = (uniform_mix / Dp + (1.0 - uniform_mix) * cell_weights
         / torch.clamp(wsum, min=1e-12))
    p = torch.where(wsum > 0, p, torch.full_like(p, 1.0 / Dp))
    cells = torch.argmax(gumbel + torch.log(p)[:, None, :], dim=-1)
    mu = torch.gather(cell_dirs, 1, cells[..., None].expand(-1, -1, 3))
    cos_half = 1.0 - cap_scale * 2.0 / Dp
    A_cap = 2.0 * math.pi * (1.0 - cos_half)
    dirs = _cap_directions(mu, cos_half, u_cos, u_phi)
    inside = _caps_containing(dirs, cell_dirs, cos_half)
    pdf = torch.sum(p[:, None, :] * inside, dim=-1) / A_cap
    inv_density = 1.0 / (num_dirs * torch.clamp(pdf, min=1e-12))
    return dirs, inv_density[..., None]


def stratified_env_directions(cell_dirs: Tensor, u_cos: Tensor,
                              u_phi: Tensor, cap_scale: float = 2.0
                              ) -> Tuple[Tensor, Tensor]:
    """One direction per cell, uniform on the cap of area cap_scale 4pi/D
    around each of the D centers cell_dirs [B, D, 3], at the uniforms
    u_cos, u_phi [B, D, 1] (JAX `mip.stratified_env_directions`). Returns
    dirs [B, D, 3] and the overlap-exact weight A_cap / n(w) [B, D, 1],
    n the number of caps containing the direction."""
    D = cell_dirs.shape[1]
    cos_half = 1.0 - cap_scale * 2.0 / D
    A_cap = 2.0 * math.pi * (1.0 - cos_half)
    dirs = _cap_directions(cell_dirs, cos_half, u_cos, u_phi)
    n = torch.sum(_caps_containing(dirs, cell_dirs, cos_half), dim=-1)
    return dirs, (A_cap / torch.clamp(n, min=1.0))[..., None]


# ---------------------------------------------------------------------------
# mip-NeRF 360 extensions and the inverse-square compositing variant (in
# the JAX package and the reference, outside their main paths)
# ---------------------------------------------------------------------------

def sample_along_rays_360(origins: Tensor, directions: Tensor, radii: Tensor,
                          num_samples: int, near: Tensor, far: Tensor,
                          t_rand: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Linear-in-disparity sampling with full covariances (mip-NeRF 360),
    stratified in inverse depth by the uniforms `t_rand` [B, N+1] when
    given. Returns t in inverse depth [B, N+1] and (means [B, N, 3],
    covs [B, N, 3, 3]) of the frustums cast at t = 1 / t_inv."""
    u = _linspace(1.0, num_samples + 1, origins)
    t_inv = (1.0 / far) * u + (1.0 - u) * (1.0 / near)
    t_inv = t_inv.expand(origins.shape[:-1] + (num_samples + 1,))
    if t_rand is not None:
        t_inv = stratify(t_inv, t_rand)
    means, covs = cast_rays(1.0 / t_inv, origins, directions, radii,
                            diagonal=False)
    return t_inv, (means, covs)


# The 21 directions of the mip-NeRF 360 IPE basis (a subdivided
# icosahedron's upper half), [3, 21].
_ICOSAHEDRON_BASIS = np.array([
    [0.8506508, 0.0, 0.5257311], [0.809017, 0.5, 0.309017],
    [0.5257311, 0.8506508, 0.0], [1.0, 0.0, 0.0],
    [0.809017, 0.5, -0.309017], [0.8506508, 0.0, -0.5257311],
    [0.309017, 0.809017, -0.5], [0.0, 0.5257311, -0.8506508],
    [0.5, 0.309017, -0.809017], [0.0, 1.0, 0.0],
    [-0.5257311, 0.8506508, 0.0], [-0.309017, 0.809017, -0.5],
    [0.0, 0.5257311, 0.8506508], [-0.309017, 0.809017, 0.5],
    [0.309017, 0.809017, 0.5], [0.5, 0.309017, 0.809017],
    [0.5, -0.309017, 0.809017], [0.0, 0.0, 1.0],
    [-0.5, 0.309017, 0.809017], [-0.809017, 0.5, 0.309017],
    [-0.809017, 0.5, -0.309017]], dtype=np.float32).T


def contract(x: Tensor) -> Tensor:
    """mip-NeRF 360 scene contraction (2 - 1/|x|) x / |x|: R^3 into the
    radius-2 ball (`parameterization` applies it where |x| > 1)."""
    norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    return (2.0 - 1.0 / norm) * x / norm


def parameterization(means: Tensor, covs: Tensor) -> Tuple[Tensor, Tensor]:
    """Contract the means outside the unit ball and carry their full
    covariances [..., 3, 3] by the contraction's Jacobian, J cov J^T:
    J = f I + f'(n) / n x x^T with f(n) = 2/n - 1/n^2. The norm is
    clamped to 1 from below, where the contraction with n = 1 is the
    identity, so no branch is needed."""
    n = torch.clamp(torch.linalg.norm(means, dim=-1, keepdim=True), min=1.0)
    new_means = (2.0 - 1.0 / n) * means / n
    f = (2.0 / n - 1.0 / n ** 2)[..., None]
    g = ((2.0 / n ** 3 - 2.0 / n ** 2) / n)[..., None]
    eye = torch.eye(3, dtype=means.dtype, device=means.device)
    jac = f * eye + g * means[..., :, None] * means[..., None, :]
    return new_means, jac @ covs @ jac.transpose(-1, -2)


def integrated_pos_enc_360(means: Tensor, covs: Tensor) -> Tensor:
    """IPE over the 21-direction icosahedral basis with full covariances
    (mip-NeRF 360): E[sin] of [y | y + pi/2] over the contracted
    Gaussians projected on the basis, [..., 42]."""
    P = torch.as_tensor(_ICOSAHEDRON_BASIS, dtype=means.dtype,
                        device=means.device)
    means, covs = parameterization(means, covs)
    y = means @ P
    y_var = torch.sum((covs @ P) * P, dim=-2)
    return torch.exp(-0.5 * torch.cat([y_var, y_var], -1)) * torch.sin(
        torch.cat([y, y + 0.5 * math.pi], -1))


def volumetric_lighting_composing(rgb: Tensor, density: Tensor,
                                  t_samples: Tensor, dirs: Tensor,
                                  white_bkgd: bool
                                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Volume rendering with inverse-square attenuation of the radiance,
    comp = sum_i w_i rgb_i / (1 + t_i^2) (the reference's env-light
    compositing experiment); returns (comp_rgb, distance, acc,
    weights) as `volumetric_rendering`."""
    t_mids = 0.5 * (t_samples[..., :-1] + t_samples[..., 1:])
    delta = (t_samples[..., 1:] - t_samples[..., :-1]) * torch.linalg.norm(
        dirs, dim=-1, keepdim=True)
    density_delta = density[..., 0] * delta
    alpha = 1.0 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([
        torch.zeros_like(density_delta[..., :1]),
        torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
    weights = alpha * trans
    attenuation = 1.0 / (1.0 + t_mids ** 2)
    comp_rgb = torch.sum((weights * attenuation)[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    distance = torch.sum(weights * t_mids, dim=-1) / torch.clamp(acc,
                                                                 min=1e-10)
    distance = torch.minimum(torch.maximum(distance, t_samples[..., 0]),
                             t_samples[..., -1])
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return comp_rgb, distance, acc, weights
