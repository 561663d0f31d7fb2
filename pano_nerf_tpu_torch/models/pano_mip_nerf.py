"""Pano-NeRF: coarse level, fine level with normals, surface path.

Two forwards, each with one path:

* `forward`, the eval render: counterpart of `PanoMipNeRF._render_fused`
  (pano_nerf_tpu/models/pano_mip_nerf.py:168-246);
* `train_forward`, the training step's forward: counterpart of the
  randomized `__call__` (pano_nerf_tpu/models/pano_mip_nerf.py:310-455,
  513-592, 773-783) with the fused kernels on (`use_fused_kernel`,
  `fused_scope="all"`), explicit normals and the fixed env directions.
  Coarse, env and view-consistency queries go through kernel 2
  (`kernels.fused_mlp_ipe`), the fine level with its density gradient
  through kernel 3 (`kernels.fused_mlp_normals`); compositing, losses and
  shading are plain torch. With `use_train_render_kernel` (the JAX
  package's :290-330 and :569-583) the coarse level and the env queries
  are instead rendered whole, compositing included, by kernel 5
  (`kernels.fused_render_train`), as `train_kernel_scope` selects. Its
  randomness comes in as `TrainDraws`.

The eval forward runs every MLP evaluation through
`kernels.fused_render.fused_render_level`, three launches per ray chunk:

1. the coarse level (evenly spaced frustums, no extras);
2. the fine level (blurpool resampling of the coarse weights) with
   normals, albedo and roughness;
3. the secondary env rays: from the collocated surface point toward each
   fixed env direction, `num_env_samples` frustums each, composited and
   integrated against a Lambertian BRDF.

The MLP's 5 density channels are density | albedo(3) | roughness: the
model class sets the count (`from_hparams`), as JAX's `PanoMipNeRF`
does, whatever `nerf.mlp.num_density_channels` says.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from pano_nerf_tpu_torch.core.rays import Rays
from pano_nerf_tpu_torch.kernels.fused_mlp_ipe import fused_mlp_ipe_apply
from pano_nerf_tpu_torch.kernels.fused_mlp_normals import (
    fused_mlp_normals_apply)
from pano_nerf_tpu_torch.kernels.fused_render import (fused_render_level,
                                                      softplus)
from pano_nerf_tpu_torch.kernels.fused_render_train import fused_render_train
from pano_nerf_tpu_torch.models.base import (LevelOutput, NerfConfig,
                                             NerfModel, expected_normals)
from pano_nerf_tpu_torch.ops import mip, shading

Tensor = torch.Tensor


class TrainDraws(NamedTuple):
    """The random numbers of one training forward (JAX draws them from
    its key schedule inside the step; the port takes them as inputs)."""
    t_coarse: Tensor  # [B, Nc+1] uniforms: coarse stratification
    u_fine: Tensor    # [B, N+1] uniforms: resampling jitter
    t_env: Tensor     # [B, D, S+1] uniforms: env stratification
    d_alt: Tensor     # [B, 3] standard normals: view-consistency direction


class PanoMipNeRF(NerfModel):
    @classmethod
    def from_hparams(cls, hparams: dict,
                     generator: Optional[torch.Generator] = None
                     ) -> "PanoMipNeRF":
        return cls(NerfConfig.from_hparams(hparams,
                                           mlp_num_density_channels=5),
                   generator)

    def forward(self, rays: Rays, env_rays: Rays, white_bkgd: bool,
                enable_surf: bool,
                packed: Optional[Tuple[Tensor, Tensor]] = None
                ) -> List[LevelOutput]:
        """Deterministic render of a ray chunk: [coarse, fine] outputs.

        rays: [B, ...] primary rays; env_rays: [D, ...] env directions with
        their solid angles in `lossmult`. `packed` is the kernel's packed
        parameters (`fused_render.pack_params(self.mlp)`), reused across
        chunks.
        """
        cfg = self.cfg

        def level(means, covs, viewdirs, t_samples, dirs, white, need):
            return fused_render_level(
                self.mlp, means, covs, viewdirs, t_samples, dirs,
                min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point,
                deg_view=cfg.deg_view, density_bias=cfg.density_bias,
                rgb_padding=cfg.rgb_padding, white_bkgd=white,
                need_normals=need, need_extras=need, packed=packed)

        ret: List[LevelOutput] = []
        t_samples, weights = None, None
        for i_level in range(cfg.num_levels):
            t_samples, (means, covs) = cfg.sample_level(
                rays, i_level, t_samples, weights)
            fine = i_level == cfg.num_levels - 1
            r = level(means.contiguous(), covs.contiguous(), rays.viewdirs,
                      t_samples.contiguous(), rays.directions, white_bkgd,
                      need=fine)
            weights = r["weights"]
            if not fine:
                ret.append(LevelOutput(rgb=r["rgb"], distance=r["distance"],
                                       acc=r["acc"]))
                continue
            out = dict(rgb=r["rgb"], distance=r["distance"], acc=r["acc"],
                       normal=r["normal"], roughness=r["roughness"])
            if enable_surf:
                surf_origins = (rays.origins
                                + rays.directions * r["distance"][:, None])
                lit_t, (lm, lc), lit_dirs = mip.sample_env_rays(
                    surf_origins, env_rays.directions, cfg.env_samples(),
                    env_rays.near, env_rays.far, env_rays.radii)
                B, D, S2 = lm.shape[:3]
                flat_dirs = lit_dirs.reshape(B * D, 3).contiguous()
                re = level(lm.reshape(B * D, S2, 3).contiguous(),
                           lc.reshape(B * D, S2, 3).contiguous(), flat_dirs,
                           lit_t.reshape(B * D, S2 + 1).contiguous(),
                           flat_dirs, False, need=False)
                surf_rgb, diffuse, _, shade = shading.surface_rendering(
                    re["rgb"].reshape(B, D, 3), r["albedo"], r["normal"],
                    lit_dirs, env_rays.lossmult)
                out.update(albedo=r["albedo"], surf_rgb=surf_rgb,
                           diffuse=diffuse, shading=shade)
            ret.append(LevelOutput(**out))
        return ret

    def make_draws(self, batch: int, num_dirs: int,
                   generator: torch.Generator) -> TrainDraws:
        """Draw one step's TrainDraws on the generator's device."""
        cfg, dev = self.cfg, generator.device
        nc, n, s = (cfg.train_coarse_samples(), cfg.num_samples,
                    cfg.num_env_samples)

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        return TrainDraws(
            t_coarse=rand(batch, nc + 1), u_fine=rand(batch, n + 1),
            t_env=rand(batch, num_dirs, s + 1),
            d_alt=torch.randn((batch, 3), generator=generator, device=dev))

    def train_forward(self, rays: Rays, env_rays: Rays, draws: TrainDraws,
                      white_bkgd: bool, enable_surf: bool,
                      use_ort_loss: bool, use_vc_loss: bool,
                      packed: Optional[Tuple[Tensor, Tensor]] = None
                      ) -> List[LevelOutput]:
        """Randomized forward of a train step: [coarse, fine] outputs with
        the distortion, orientation and view-consistency products.

        rays: [B, ...]; env_rays: [D, ...] fixed env directions with their
        solid angles in `lossmult`; `packed` is the kernels' packed
        parameters (`fused_render.pack_params(self.mlp)`), shared by the
        kernel calls of the step.
        """
        cfg = self.cfg
        kw = dict(min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point,
                  packed=packed)

        def kernel_level(scope: str) -> bool:
            return (cfg.use_train_render_kernel
                    and cfg.train_kernel_scope in ("all", scope))

        def render_level(means, covs, viewdirs, t_samples, dirs, white):
            r = fused_render_train(
                self.mlp, means.contiguous(), covs.contiguous(),
                viewdirs.contiguous(), t_samples.contiguous(),
                dirs.contiguous(), deg_view=cfg.deg_view,
                density_bias=cfg.density_bias, rgb_padding=cfg.rgb_padding,
                white_bkgd=white, save_acts=cfg.train_kernel_save_acts, **kw)
            return r["rgb"], r["distance"], r["acc"], r["weights"]

        # ---- coarse level ----
        t0, (m0, c0) = mip.sample_along_rays(
            rays.origins, rays.directions, rays.radii,
            cfg.train_coarse_samples(), rays.near, rays.far, cfg.disparity,
            t_rand=draws.t_coarse)
        v = self._venc(rays.viewdirs)
        if kernel_level("coarse"):
            comp, dist, acc, w0 = render_level(m0, c0, rays.viewdirs, t0,
                                               rays.directions, white_bkgd)
        else:
            raw_rgb, raw_density = fused_mlp_ipe_apply(self.mlp, m0, c0, v,
                                                       **kw)
            comp, dist, acc, w0 = mip.volumetric_rendering(
                self._rgb(raw_rgb), self._density(raw_density[..., :1]), t0,
                rays.directions, white_bkgd)
        ret = [LevelOutput(rgb=comp, distance=dist, acc=acc,
                           dist_loss=mip.distortion_loss(t0, w0))]

        # ---- fine level: MLP + density gradient (kernel 3) ----
        t1, (m1, c1) = mip.resample_along_rays(
            rays.origins, rays.directions, rays.radii, t0, w0,
            cfg.resample_padding, num_samples=cfg.num_samples,
            u_rand=draws.u_fine)
        raw_rgb, raw_density, d_raw = fused_mlp_normals_apply(
            self.mlp, m1, c1, v, **kw)
        raw_sigma = raw_density[..., :1]
        albedos = torch.sigmoid(raw_density[..., 1:4]) * 0.77 + 0.03
        roughness = softplus(raw_density[..., 4:5] - 1.0)
        # d density / d means = sigmoid(raw_sigma + bias) * d raw_sigma.
        d_means = torch.sigmoid(raw_sigma + cfg.density_bias) * d_raw
        comp, dist, acc, w1 = mip.volumetric_rendering(
            self._rgb(raw_rgb), self._density(raw_sigma), t1,
            rays.directions, white_bkgd)
        normal, ort_loss, w_norm = expected_normals(
            w1, -d_means, rays.directions, use_ort_loss)
        out = dict(rgb=comp, distance=dist, acc=acc,
                   dist_loss=mip.distortion_loss(t1, w1), ort_loss=ort_loss,
                   normal=normal,
                   roughness=torch.sum(w_norm[..., 0] * roughness[..., 0],
                                       dim=-1))
        if use_vc_loss:
            # The same samples under a random view direction, composited
            # with stop-gradient weights: a full re-evaluation through
            # kernel 2 (kernel 3 does not return the bottleneck).
            d_alt = mip.safe_normalize(draws.d_alt)
            raw_alt, _ = fused_mlp_ipe_apply(self.mlp, m1, c1,
                                             self._venc(d_alt), **kw)
            rgb_alt = torch.sum(w1.detach()[..., None] * self._rgb(raw_alt),
                                dim=-2)
            if white_bkgd:
                rgb_alt = rgb_alt + (1.0 - acc.detach()[..., None])
            out["rgb_alt"] = rgb_alt
        if enable_surf:
            albedo = torch.sum(w_norm * albedos, dim=-2)
            # The collocated surface point keeps its gradient through the
            # distance (the env means' cotangent comes back from kernel 2).
            surf_origins = rays.origins + rays.directions * dist[..., None]
            lit_t, (lm, lc), lit_dirs = mip.sample_env_rays(
                surf_origins, env_rays.directions, cfg.num_env_samples,
                env_rays.near, env_rays.far, env_rays.radii,
                t_rand=draws.t_env)
            if kernel_level("env"):
                B, D, S2 = lm.shape[:3]
                flat_dirs = lit_dirs.reshape(B * D, 3)
                env_rgb = render_level(
                    lm.reshape(B * D, S2, 3), lc.reshape(B * D, S2, 3),
                    flat_dirs, lit_t.reshape(B * D, S2 + 1), flat_dirs,
                    False)[0].reshape(B, D, 3)
            else:
                e_rgb, e_density = fused_mlp_ipe_apply(
                    self.mlp, lm, lc, self._venc(lit_dirs), **kw)
                env_rgb = mip.volumetric_rendering(
                    self._rgb(e_rgb), self._density(e_density[..., :1]),
                    lit_t, lit_dirs, white_bkgd=False)[0]
            surf_rgb, diffuse, _, shade = shading.surface_rendering(
                env_rgb, albedo, normal, lit_dirs, env_rays.lossmult)
            out.update(albedo=albedo, surf_rgb=surf_rgb, diffuse=diffuse,
                       shading=shade)
        ret.append(LevelOutput(**out))
        return ret
