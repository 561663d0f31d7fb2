"""Pano-NeRF: coarse level, fine level with normals, surface path.

Two forwards:

* `forward`, the eval render: counterpart of `PanoMipNeRF._render_fused`
  (pano_nerf_tpu/models/pano_mip_nerf.py:168-246), or, with the tight
  re-read on (`env_tight_rgb` > 0), for which JAX takes no whole-level
  kernel (:275-281), of its first-order standard path: the route of
  `train_forward` without draws (`_render`);
* `train_forward`, the training step's forward: counterpart of the
  randomized `__call__` (pano_nerf_tpu/models/pano_mip_nerf.py:310-455,
  513-750, 773-783) with the fused kernels on (`use_fused_kernel`,
  `fused_scope="all"`), explicit normals and the fixed env directions.
  Coarse, env and view-consistency queries go through kernel 2
  (`kernels.fused_mlp_ipe`), the fine level with its density gradient
  through kernel 3 (`kernels.fused_mlp_normals`); compositing, losses and
  shading are plain torch. With `use_train_render_kernel` (the JAX
  package's :290-330 and :569-583) the coarse level and the env queries
  are instead rendered whole, compositing included, by kernel 5
  (`kernels.fused_render_train`), as `train_kernel_scope` selects; the
  env queries stay on kernel 2 with the tight re-read, as in JAX. Its
  randomness comes in as `TrainDraws`.

The tight re-read (`_tight_read`, JAX :593-674) evaluates the MLP again
through kernel 2 at the env march's means with covariances scaled by
`env_tight_rgb`: at all S samples, weighted by the blurred march's
weights; at its argmax (`env_tight_top1`) or its top K
(`env_tight_topk`); or composited at the tight scale
(`env_tight_weights`); `env_tight_chroma` then keeps the blurred read's
luma and takes the chroma of the tight one. The env distill
(`_env_distill`, JAX :692-750) re-marches one random env direction per
ray with `env_distill_samples` Gaussians through a kernel 2 forward and
exposes the blurred read along it with that stop-gradient target.

The kernel-4 eval forward runs every MLP evaluation through
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

from typing import Dict, List, NamedTuple, Optional, Tuple

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
    # With env_distill_samples = S_ed > 0 (else None): the env direction
    # of each ray's distill march and its stratification.
    ed_idx: Optional[Tensor] = None  # [B, 1] int64 in [0, D)
    t_ed: Optional[Tensor] = None    # [B, 1, S_ed+1] uniforms


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
        chunks. With the tight re-read, kernels 2 and 3 and plain
        compositing (`_render`, no autograd); else kernel 4.
        """
        if self.cfg.env_tight_rgb > 0:
            with torch.no_grad():
                return self._render(rays, env_rays, None, white_bkgd,
                                    enable_surf, False, False, packed)
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
        """Draw one step's TrainDraws on the generator's device (the
        env-distill pair last, and only with env_distill_samples > 0)."""
        cfg, dev = self.cfg, generator.device
        nc, n, s = (cfg.train_coarse_samples(), cfg.num_samples,
                    cfg.num_env_samples)

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        draws = TrainDraws(
            t_coarse=rand(batch, nc + 1), u_fine=rand(batch, n + 1),
            t_env=rand(batch, num_dirs, s + 1),
            d_alt=torch.randn((batch, 3), generator=generator, device=dev))
        if cfg.env_distill_samples > 0:
            draws = draws._replace(
                ed_idx=torch.randint(0, num_dirs, (batch, 1),
                                     generator=generator, device=dev),
                t_ed=rand(batch, 1, cfg.env_distill_samples + 1))
        return draws

    def train_forward(self, rays: Rays, env_rays: Rays, draws: TrainDraws,
                      white_bkgd: bool, enable_surf: bool,
                      use_ort_loss: bool, use_vc_loss: bool,
                      packed: Optional[Tuple[Tensor, Tensor]] = None
                      ) -> List[LevelOutput]:
        """Randomized forward of a train step: [coarse, fine] outputs with
        the distortion, orientation and view-consistency products (and the
        env-distill pair with env_distill_samples > 0).

        rays: [B, ...]; env_rays: [D, ...] fixed env directions with their
        solid angles in `lossmult`; `packed` is the kernels' packed
        parameters (`fused_render.pack_params(self.mlp)`), shared by the
        kernel calls of the step.
        """
        return self._render(rays, env_rays, draws, white_bkgd, enable_surf,
                            use_ort_loss, use_vc_loss, packed)

    def _render(self, rays: Rays, env_rays: Rays,
                draws: Optional[TrainDraws], white_bkgd: bool,
                enable_surf: bool, use_ort_loss: bool, use_vc_loss: bool,
                packed: Optional[Tuple[Tensor, Tensor]]
                ) -> List[LevelOutput]:
        """The route of kernels 2, 3 (and 5): randomized by `draws` with
        the training sample counts, or, without draws, deterministic with
        the eval counts (`NerfConfig.sample_level`, `env_samples`)."""
        cfg = self.cfg
        train = draws is not None
        kw = dict(min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point,
                  packed=packed)

        def kernel_level(scope: str) -> bool:
            return (train and cfg.use_train_render_kernel
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
        if train:
            t0, (m0, c0) = mip.sample_along_rays(
                rays.origins, rays.directions, rays.radii,
                cfg.train_coarse_samples(), rays.near, rays.far,
                cfg.disparity, t_rand=draws.t_coarse)
        else:
            t0, (m0, c0) = cfg.sample_level(rays, 0, None, None)
        v = self._venc(rays.viewdirs)
        if kernel_level("coarse"):
            comp, dist, acc, w0 = render_level(m0, c0, rays.viewdirs, t0,
                                               rays.directions, white_bkgd)
        else:
            comp, dist, acc, w0 = self._march(m0, c0, v, t0, rays.directions,
                                              white_bkgd, packed)
        ret = [LevelOutput(rgb=comp, distance=dist, acc=acc,
                           dist_loss=(mip.distortion_loss(t0, w0) if train
                                      else None))]

        # ---- fine level: MLP + density gradient (kernel 3) ----
        if train:
            t1, (m1, c1) = mip.resample_along_rays(
                rays.origins, rays.directions, rays.radii, t0, w0,
                cfg.resample_padding, num_samples=cfg.num_samples,
                u_rand=draws.u_fine)
        else:
            t1, (m1, c1) = cfg.sample_level(rays, 1, t0, w0)
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
                   dist_loss=mip.distortion_loss(t1, w1) if train else None,
                   ort_loss=ort_loss, normal=normal,
                   roughness=torch.sum(w_norm[..., 0] * roughness[..., 0],
                                       dim=-1))
        if use_vc_loss and train:
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
                surf_origins, env_rays.directions,
                cfg.num_env_samples if train else cfg.env_samples(),
                env_rays.near, env_rays.far, env_rays.radii,
                t_rand=draws.t_env if train else None)
            if kernel_level("env") and cfg.env_tight_rgb == 0:
                B, D, S2 = lm.shape[:3]
                flat_dirs = lit_dirs.reshape(B * D, 3)
                e_rgb, e_dist, e_acc, _ = render_level(
                    lm.reshape(B * D, S2, 3), lc.reshape(B * D, S2, 3),
                    flat_dirs, lit_t.reshape(B * D, S2 + 1), flat_dirs,
                    False)
                env_rgb, env_dist, env_acc = (e_rgb.reshape(B, D, 3),
                                              e_dist.reshape(B, D),
                                              e_acc.reshape(B, D))
            else:
                v_lit = self._venc(lit_dirs)
                env_rgb, env_dist, env_acc, env_w = self._march(
                    lm, lc, v_lit, lit_t, lit_dirs, False, packed)
                if cfg.env_tight_rgb > 0:
                    env_rgb = self._tight_read(lm, lc, v_lit, lit_t,
                                               lit_dirs, env_rgb, env_w,
                                               packed)
            if train and cfg.env_distill_samples > 0:
                out.update(self._env_distill(
                    surf_origins, lit_dirs, env_rgb, env_acc, env_dist,
                    env_rays, draws, packed))
            surf_rgb, diffuse, _, shade = shading.surface_rendering(
                env_rgb, albedo, normal, lit_dirs, env_rays.lossmult)
            out.update(albedo=albedo, surf_rgb=surf_rgb, diffuse=diffuse,
                       shading=shade)
        ret.append(LevelOutput(**out))
        return ret

    def _tight_read(self, means: Tensor, covs: Tensor, v_enc: Tensor,
                    t_samples: Tensor, dirs: Tensor, blur_rgb: Tensor,
                    weights: Tensor,
                    packed: Optional[Tuple[Tensor, Tensor]]) -> Tensor:
        """The env radiance [B, D, 3] re-read through kernel 2 at the env
        march's means [B, D, S, 3] with covariances x env_tight_rgb (JAX
        pano_mip_nerf.py:593-674): weighted by the march's `weights` at
        all S samples, at its argmax (top1) or its top K (topk), or
        composited at the tight scale (weights); then, with
        env_tight_chroma, luma(blur) (tight + c) / (luma(tight) + c)."""
        cfg = self.cfg
        scale = cfg.env_tight_rgb

        def read(m, c):
            raw_rgb, raw_density = fused_mlp_ipe_apply(
                self.mlp, m, c * scale, v_enc, min_deg=cfg.min_deg_point,
                max_deg=cfg.max_deg_point, packed=packed)
            return self._rgb(raw_rgb), raw_density

        def gather(x, idx):   # x [B, D, S, 3] at idx [B, D, K]
            return torch.gather(x, -2, idx[..., None].expand(*idx.shape, 3))

        if cfg.env_tight_top1 or cfg.env_tight_topk > 0:
            if cfg.env_tight_top1:
                idx = torch.argmax(weights, dim=-1, keepdim=True)
                w_k = None
            else:
                w_k, idx = torch.topk(weights, cfg.env_tight_topk, dim=-1)
            rgb = read(gather(means, idx), gather(covs, idx))[0]
            tight = (rgb[..., 0, :] if w_k is None
                     else torch.sum(w_k[..., None] * rgb, dim=-2))
        elif cfg.env_tight_weights:
            rgb, raw_density = read(means, covs)
            tight = mip.volumetric_rendering(
                rgb, self._density(raw_density[..., :1]), t_samples, dirs,
                white_bkgd=False)[0]
        else:
            tight = torch.sum(weights[..., None] * read(means, covs)[0],
                              dim=-2)
        if not cfg.env_tight_chroma:
            return tight
        c = cfg.env_tight_chroma_eps
        return (shading.compute_illumination(blur_rgb) * (tight + c)
                / (shading.compute_illumination(tight) + c))

    def _env_distill(self, surf_origins: Tensor, lit_dirs: Tensor,
                     env_rgb: Tensor, env_acc: Tensor, env_dist: Tensor,
                     env_rays: Rays, draws: TrainDraws,
                     packed: Optional[Tuple[Tensor, Tensor]]
                     ) -> Dict[str, Tensor]:
        """The env-distill pair (JAX pano_mip_nerf.py:692-750): the env
        read (radiance [B, 3], opacity and distance [B]) along direction
        `draws.ed_idx` of each ray, and its target, a stop-gradient march
        of env_distill_samples Gaussians from the surface point along it
        over the first env ray's [near, far] at its radius (a kernel 2
        forward, no backward)."""
        idx = draws.ed_idx

        def take(x):   # x [B, D(, C)] at each ray's direction -> [B(, C)]
            i = idx if x.ndim == 2 else idx[..., None].expand(
                -1, -1, x.shape[-1])
            return torch.gather(x, 1, i)[:, 0]

        with torch.no_grad():
            d_sel = torch.gather(lit_dirs, 1,
                                 idx[..., None].expand(-1, -1, 3))
            t, (m, c), d = mip.sample_env_rays_hemisphere(
                surf_origins, d_sel, self.cfg.env_distill_samples,
                env_rays.near[:1, :1], env_rays.far[:1, :1],
                env_rays.radii[:1, :1], t_rand=draws.t_ed)
            rgb, dist, acc, _ = self._march(m, c, self._venc(d), t, d, False,
                                            packed)
        return dict(env_read=take(env_rgb), env_fine=rgb[:, 0],
                    env_read_acc=take(env_acc), env_fine_acc=acc[:, 0],
                    env_read_dist=take(env_dist), env_fine_dist=dist[:, 0])
