"""Pano-NeRF: coarse level, fine level with normals, surface path.

Two forwards:

* `forward`, the eval render: counterpart of `PanoMipNeRF._render_fused`
  (pano_nerf_tpu/models/pano_mip_nerf.py:168-246), or, with the tight
  re-read on (`env_tight_rgb` > 0), for which JAX takes no whole-level
  kernel (:275-281), of its first-order standard path: the route of
  `train_forward` without draws (`_render`);
* `train_forward`, the training step's forward: counterpart of the
  randomized `__call__` (pano_nerf_tpu/models/pano_mip_nerf.py:310-455,
  513-783) with the fused kernels on (`use_fused_kernel`,
  `fused_scope="all"`) and explicit normals.
  Coarse, env and view-consistency queries go through kernel 2
  (`kernels.fused_mlp_ipe`), the fine level with its density gradient
  through kernel 3 (`kernels.fused_mlp_normals`); compositing, losses and
  shading are plain torch. With `use_train_render_kernel` (the JAX
  package's :290-330 and :569-583) the coarse level and the env queries
  are instead rendered whole, compositing included, by kernel 5
  (`kernels.fused_render_train`), as `train_kernel_scope` selects; the
  env queries stay on kernel 2 with the tight re-read, as in JAX. Its
  randomness comes in as `TrainDraws`.

Both run JAX's level loop (`nerf.num_levels`, :193 and :314): level 0
over [near, far], every later level resampled from the one before (with
the resampling's gradient into that level's weights unless
`stop_resample_grad`: kernel 3's moment gradient and kernel 5's weights
cotangent carry it), the last of two or more the fine level with
normals and the surface path; at one level there is none, and the one
level's products stand for both. Randomness comes in as `TrainDraws`:
in training unless `train.randomized: false` (then evenly placed
samples, no density noise, the fixed env set and none of the randomized
products: distortion loss, view consistency, the distills); in eval
under `val.randomized` (the same draws for every chunk; kernel 4 takes
them without density noise on the fixed env set, else `_render`, JAX's
gate :276-289). `disable_integration` zeroes the covariances before
every MLP query, kernels 4 and 5 included (`NerfModel._covs`).

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

The study switches (JAX :521-567, :675-690, :753-772, :355-430):
in training the env directions are the fixed set, rotated per ray
(`rotated`), rotated and jittered in their cells (`stratified`), or
importance-sampled after a probe march of Fibonacci cells through a
kernel-2 forward without gradient (`importance`, `_importance_dirs`),
with per-ray solid angles in the shading; `env_resample` places a
second env march by the first one's weights (`_resample_env`; the first
then runs forward only, and kernel 5 and the tight re-read skip the
env); `density_noise` noises the raw density of both levels (kernel 5
off); `point_normals` runs the fine level on kernel 2 and takes the
normal from one kernel-3 query per ray (`_point_normal`); the
illuminant field (`models/illum.py`) re-tints the env read before the
irradiance integral and exposes `env_pre_illum` / `illum_chroma`. Eval
keeps the fixed set and per-sample normals; there `env_resample` adds
a fourth kernel-4 launch per chunk and the field re-tints kernel 4's env
read.

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
does, whatever `nerf.mlp.num_density_channels` says; the emissive head
appends 3 emission channels and the chroma head 3 chroma channels after
them (JAX :37-75). Emission is added to the radiance of every query and
composited into the `emission` product and the surface render; the
chroma simplex shapes the radiance of every query (`NerfModel._radiance`).

The plain route (f32, another trunk or view-branch depth or skip, no
view directions, either head: `models/base.py` `plain_route_reasons`,
JAX's XLA route): every MLP query of both forwards goes through the
general NerfMLP with torch autograd and the normals through the explicit
chain of `models/normals.py` (`NerfModel._query`, `_query_normals`); the
eval render is `_render` without draws, and kernels 4 and 5 are not
used. On both routes the normals come from the explicit chain only (JAX's
`normals_impl="vjp"` is not ported), so JAX's rule that the emissive head
needs explicit normals holds by construction.

With `loss.scale_distill` or `loss.scale_distill_dist` the training step
re-marches the primary ray at `num_env_samples` Gaussians (JAX :491-512;
its uniforms `TrainDraws.t_sd`, drawn only then) and composites it to
`rgb_scale` / `dist_scale`: one more `_march`, kernel 2 forward and
backward on the kernel route.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from pano_nerf_tpu_torch.core.rays import Rays
from pano_nerf_tpu_torch.kernels.fused_render import (fused_render_level,
                                                      softplus)
from pano_nerf_tpu_torch.kernels.fused_render_train import fused_render_train
from pano_nerf_tpu_torch.models.base import (LevelOutput, NerfConfig,
                                             NerfModel, expected_normals,
                                             level_noise, level_uniforms)
from pano_nerf_tpu_torch.models.illum import apply_illum
from pano_nerf_tpu_torch.ops import mip, shading
from pano_nerf_tpu_torch.utils import rotation
from pano_nerf_tpu_torch.utils.spherical import sample_dir_by_uniform

Tensor = torch.Tensor


class TrainDraws(NamedTuple):
    """The random numbers of one randomized forward: a training step, or
    under `val.randomized` an eval chunk (at the eval sample counts). JAX
    draws them from its key schedule inside the step; the port takes them
    as inputs. Level 1 is the resampled level after the coarse one (the
    fine level at two levels); the levels after it (`nerf.num_levels` >
    2) have `u_more` and `noise_more`, drawn after everything else (the
    fields are not in the order of the draws)."""
    t_coarse: Tensor  # [B, Nc+1] uniforms: coarse stratification
    u_fine: Tensor    # [B, N+1] uniforms: resampling jitter of level 1
    t_env: Tensor     # [B, D, S+1] uniforms: env stratification
    d_alt: Tensor     # [B, 3] standard normals: view-consistency direction
    # With env_distill_samples = S_ed > 0 (else None): the env direction
    # of each ray's distill march and its stratification.
    ed_idx: Optional[Tensor] = None  # [B, 1] int64 in [0, D)
    t_ed: Optional[Tensor] = None    # [B, 1, S_ed+1] uniforms
    # Each of the rest is drawn only when its switch is on (else None).
    # The env estimator (`env_mode`): the per-ray rotation as standard
    # normals (rotated and stratified: of the env set; importance: of the
    # probe cells), the cap uniforms (stratified, importance), the
    # importance pick's Gumbel noise over the Dp probe cells and the
    # probe march's stratification.
    q_rot: Optional[Tensor] = None    # [B, 4]
    u_cos: Optional[Tensor] = None    # [B, D, 1]
    u_phi: Optional[Tensor] = None    # [B, D, 1]
    gumbel: Optional[Tensor] = None   # [B, D, Dp]
    t_probe: Optional[Tensor] = None  # [B, Dp, Sp+1]
    # env_resample: the second env march's inverse-CDF uniforms.
    u_resample: Optional[Tensor] = None   # [B * D, S_f+1]
    # density_noise: standard normals on the raw density of levels 0, 1.
    noise_coarse: Optional[Tensor] = None  # [B, Nc, 1]
    noise_fine: Optional[Tensor] = None    # [B, N, 1]
    # nerf.num_levels L > 2: levels 2..L-1's resampling jitter and (with
    # density_noise) the normals on their raw density.
    u_more: Optional[Tensor] = None       # [L-2, B, N+1]
    noise_more: Optional[Tensor] = None   # [L-2, B, N, 1]
    # loss.scale_distill(_dist): the re-march's stratification.
    t_sd: Optional[Tensor] = None    # [B, S+1] uniforms, S num_env_samples


class PanoMipNeRF(NerfModel):
    @classmethod
    def from_hparams(cls, hparams: dict,
                     generator: Optional[torch.Generator] = None
                     ) -> "PanoMipNeRF":
        heads = sum(bool(hparams.get(f"nerf.{h}_head", False))
                    for h in ("emissive", "chroma"))
        return cls(NerfConfig.from_hparams(
            hparams, mlp_num_density_channels=5 + 3 * heads), generator)

    def __init__(self, cfg: NerfConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, generator)
        if (self.kernels and cfg.use_train_render_kernel
                and not cfg.append_identity):
            raise NotImplementedError(
                "nerf.use_train_render_kernel with nerf.append_identity "
                "false is not supported by the PyTorch/CUDA render path; "
                "JAX cannot train it either: its kernel 5 encodes the view "
                "directions with identity (pano_nerf_tpu/kernels/"
                "fused_render_train.py:483) for a view layer that takes "
                "them without, and raises")
        if cfg.env_mode() == "importance":
            # The probe's Fibonacci cells, on the model's device (a copy
            # from the host inside a captured step would fail).
            self.register_buffer("probe_dirs", torch.tensor(
                sample_dir_by_uniform(cfg.env_probe_dirs)),
                persistent=False)

    def forward(self, rays: Rays, env_rays: Rays, white_bkgd: bool,
                enable_surf: bool,
                packed: Optional[Tuple[Tensor, Tensor]] = None,
                draws: Optional[TrainDraws] = None) -> List[LevelOutput]:
        """The eval render of a ray chunk: one output per level, the last
        of two or more the fine one.

        rays: [B, ...] primary rays; env_rays: [D, ...] env directions with
        their solid angles in `lossmult`. `packed` is the kernel's packed
        parameters (`fused_render.pack_params(self.mlp)`), reused across
        chunks. `draws` (`make_draws(eval_counts=True)`) randomize the
        render (`val.randomized`); without them it is deterministic. With
        the tight re-read, kernels 2 and 3 and plain compositing
        (`_render`, no autograd); on the plain route `_render` through the
        plain NerfMLP; without identity in the viewdir encoding (kernel 4
        builds it with identity), or randomized with density noise or
        another env estimator than the fixed set, `_render` too (JAX's
        gate, :276-289); else kernel 4.
        """
        cfg = self.cfg
        if (cfg.env_tight_rgb > 0 or not self.kernels
                or not cfg.append_identity
                or (draws is not None and (cfg.density_noise > 0
                                           or cfg.env_mode() != "fixed"))):
            with torch.no_grad():
                return self._render(rays, env_rays, draws, False, white_bkgd,
                                    enable_surf, False, False, packed)

        def level(means, covs, viewdirs, t_samples, dirs, white, need):
            return fused_render_level(
                self.mlp, means, self._covs(covs), viewdirs, t_samples, dirs,
                min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point,
                deg_view=cfg.deg_view, density_bias=cfg.density_bias,
                rgb_padding=cfg.rgb_padding, white_bkgd=white,
                need_normals=need, need_extras=need, packed=packed)

        ret: List[LevelOutput] = []
        t_samples, weights = None, None
        for i_level in range(cfg.num_levels):
            t_samples, (means, covs) = cfg.sample_level(
                rays, i_level, t_samples, weights,
                u=level_uniforms(draws, i_level))
            fine = cfg.fine_level(i_level)
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
                    env_rays.near, env_rays.far, env_rays.radii,
                    t_rand=None if draws is None else draws.t_env)
                B, D, S2 = lm.shape[:3]
                flat_dirs = lit_dirs.reshape(B * D, 3).contiguous()

                def env_level(t, mc):
                    (m, c), S = mc, t.shape[-1] - 1
                    return level(m.reshape(B * D, S, 3).contiguous(),
                                  c.reshape(B * D, S, 3).contiguous(),
                                  flat_dirs,
                                  t.reshape(B * D, S + 1).contiguous(),
                                  flat_dirs, False, need=False)

                re = env_level(lit_t, (lm, lc))
                if cfg.env_resample:
                    # A fourth launch: the march placed by the third's
                    # weights carries the radiance.
                    re = env_level(*self._resample_env(
                        surf_origins, lit_dirs, env_rays.radii, lit_t,
                        re["weights"].reshape(B, D, S2),
                        None if draws is None else draws.u_resample))
                env_rgb = re["rgb"].reshape(B, D, 3)
                if cfg.illum_field:
                    env_rgb = apply_illum(env_rgb,
                                          self.illum(surf_origins, lit_dirs))
                surf_rgb, diffuse, _, shade = shading.surface_rendering(
                    env_rgb, r["albedo"], r["normal"], lit_dirs,
                    env_rays.lossmult)
                out.update(albedo=r["albedo"], surf_rgb=surf_rgb,
                           diffuse=diffuse, shading=shade)
            ret.append(LevelOutput(**out))
        return ret

    def make_draws(self, batch: int, num_dirs: int,
                   generator: torch.Generator,
                   scale_distill: bool = False,
                   eval_counts: bool = False) -> TrainDraws:
        """Draw one randomized forward's TrainDraws on the generator's
        device: the four of every step, then the env-distill pair (in
        training), the env estimator's, the resampled march's, the density
        noise and (`scale_distill`) the scale-distill re-march's, each only
        when its switch is on, then the levels after level 1's. At
        `eval_counts` (a randomized eval chunk) the shapes are the eval
        sample counts'."""
        cfg, dev = self.cfg, generator.device
        nc, n = cfg.coarse_samples(eval_counts), cfg.fine_samples(eval_counts)
        s = cfg.env_samples() if eval_counts else cfg.num_env_samples

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        draws = TrainDraws(
            t_coarse=rand(batch, nc + 1), u_fine=rand(batch, n + 1),
            t_env=rand(batch, num_dirs, s + 1), d_alt=randn(batch, 3))
        if cfg.env_distill_samples > 0 and not eval_counts:
            draws = draws._replace(
                ed_idx=torch.randint(0, num_dirs, (batch, 1),
                                     generator=generator, device=dev),
                t_ed=rand(batch, 1, cfg.env_distill_samples + 1))
        mode = cfg.env_mode()
        if mode != "fixed":
            draws = draws._replace(q_rot=randn(batch, 4))
        if mode in ("stratified", "importance"):
            draws = draws._replace(u_cos=rand(batch, num_dirs, 1),
                                   u_phi=rand(batch, num_dirs, 1))
        if mode == "importance":
            dp = cfg.env_probe_dirs
            # Standard Gumbel noise, -log(-log(u)) with u in [tiny, 1),
            # as jax.random.gumbel draws it.
            u = torch.clamp(rand(batch, num_dirs, dp),
                            min=torch.finfo(torch.float32).tiny)
            draws = draws._replace(
                gumbel=-torch.log(-torch.log(u)),
                t_probe=rand(batch, dp, cfg.env_probe_samples + 1))
        if cfg.env_resample:
            draws = draws._replace(u_resample=rand(
                batch * num_dirs, cfg.num_env_fine_samples + 1))
        if cfg.density_noise > 0:
            draws = draws._replace(noise_coarse=randn(batch, nc, 1),
                                   noise_fine=randn(batch, n, 1))
        if scale_distill:
            draws = draws._replace(t_sd=rand(batch, cfg.num_env_samples + 1))
        more = cfg.num_levels - 2
        if more > 0:
            draws = draws._replace(u_more=rand(more, batch, n + 1))
            if cfg.density_noise > 0:
                draws = draws._replace(noise_more=randn(more, batch, n, 1))
        return draws

    def train_forward(self, rays: Rays, env_rays: Rays,
                      draws: Optional[TrainDraws], white_bkgd: bool,
                      enable_surf: bool, use_ort_loss: bool,
                      use_vc_loss: bool,
                      packed: Optional[Tuple[Tensor, Tensor]] = None
                      ) -> List[LevelOutput]:
        """The forward of a train step: one output per level, the last of
        two or more the fine one with the orientation and view-consistency
        products (and the env-distill pair with env_distill_samples > 0,
        the scale-distill re-march where the draws hold its uniforms
        `t_sd`), and every level's distortion loss. Randomized by `draws`;
        with None (`train.randomized: false`) evenly placed, without noise,
        on the fixed env set and without the randomized products (the
        distortion loss, view consistency, the distills: JAX's
        `randomized` gates).

        rays: [B, ...]; env_rays: [D, ...] fixed env directions with their
        solid angles in `lossmult`; `packed` is the kernels' packed
        parameters (`fused_render.pack_params(self.mlp)`), shared by the
        kernel calls of the step.
        """
        return self._render(rays, env_rays, draws, True, white_bkgd,
                            enable_surf, use_ort_loss, use_vc_loss, packed)

    def _render(self, rays: Rays, env_rays: Rays,
                draws: Optional[TrainDraws], train: bool, white_bkgd: bool,
                enable_surf: bool, use_ort_loss: bool, use_vc_loss: bool,
                packed: Optional[Tuple[Tensor, Tensor]]
                ) -> List[LevelOutput]:
        """The route of kernels 2, 3 (and 5), or of the plain NerfMLP,
        over JAX's level loop (:310-455): with the training sample counts
        (`train`) or the eval ones; randomized by `draws`, or
        deterministic without them."""
        cfg = self.cfg
        rnd = draws is not None

        def kernel_level(scope: str) -> bool:
            # Kernel 5 has no density noise (JAX's gate, :294-296) and
            # takes the kernel route only.
            return (train and cfg.use_train_render_kernel and self.kernels
                    and (not rnd or cfg.density_noise == 0)
                    and cfg.train_kernel_scope in ("all", scope))

        v = self._venc(rays.viewdirs)
        ret: List[LevelOutput] = []
        t, w = None, None
        for i_level in range(cfg.num_levels):
            t, (m, c) = cfg.sample_level(rays, i_level, t, w,
                                         eval_counts=not train,
                                         u=level_uniforms(draws, i_level))
            noise = level_noise(draws, i_level)
            if cfg.fine_level(i_level):
                ret.append(self._fine_level(
                    rays, env_rays, draws, train, t, m, c, v, noise,
                    kernel_level("env"), white_bkgd, enable_surf,
                    use_ort_loss, use_vc_loss, packed))
                continue
            if kernel_level("coarse"):
                comp, dist, acc, w = self._render_train_level(
                    m, c, rays.viewdirs, t, rays.directions, white_bkgd,
                    packed)
            else:
                comp, dist, acc, w = self._march(
                    m, c, v, t, rays.directions, white_bkgd, packed,
                    noise=noise)
            ret.append(LevelOutput(
                rgb=comp, distance=dist, acc=acc,
                dist_loss=mip.distortion_loss(t, w) if train and rnd
                else None))
        return ret

    def _render_train_level(self, means: Tensor, covs: Tensor,
                            viewdirs: Tensor, t_samples: Tensor,
                            dirs: Tensor, white: bool,
                            packed: Optional[Tuple[Tensor, Tensor]]
                            ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """A whole training level through kernel 5: (rgb, distance, acc,
        weights)."""
        cfg = self.cfg
        r = fused_render_train(
            self.mlp, means.contiguous(), self._covs(covs).contiguous(),
            viewdirs.contiguous(), t_samples.contiguous(), dirs.contiguous(),
            min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point,
            deg_view=cfg.deg_view, density_bias=cfg.density_bias,
            rgb_padding=cfg.rgb_padding, white_bkgd=white,
            save_acts=cfg.train_kernel_save_acts, packed=packed)
        return r["rgb"], r["distance"], r["acc"], r["weights"]

    def _fine_level(self, rays: Rays, env_rays: Rays,
                    draws: Optional[TrainDraws], train: bool, t1: Tensor,
                    m1: Tensor, c1: Tensor, v: Tensor,
                    noise: Optional[Tensor], env_kernel: bool,
                    white_bkgd: bool, enable_surf: bool, use_ort_loss: bool,
                    use_vc_loss: bool,
                    packed: Optional[Tuple[Tensor, Tensor]]) -> LevelOutput:
        """The fine level at fenceposts t1 (frustums m1, c1): MLP + density
        gradient (kernel 3), or, with point normals in training, the MLP
        alone (kernel 2) and one kernel-3 query per ray (on the plain
        route the plain NerfMLP and its explicit chain); its raw density
        noised by `noise`; then the view-consistency and scale-distill
        re-queries and the surface path (the env march through kernel 5
        where `env_kernel` allows)."""
        cfg = self.cfg
        rnd = draws is not None
        point = train and cfg.point_normals
        if point:
            raw_rgb, raw_density = self._query(m1, c1, v, packed)
        else:
            raw_rgb, raw_density, d_raw = self._query_normals(m1, c1, v,
                                                              packed)
        raw_sigma = self._noisy(raw_density[..., :1], noise)
        albedos = torch.sigmoid(raw_density[..., 1:4]) * 0.77 + 0.03
        roughness = softplus(raw_density[..., 4:5] - 1.0)
        emission = self._emission(raw_density)
        comp, dist, acc, w1 = mip.volumetric_rendering(
            self._radiance(raw_rgb, raw_density), self._density(raw_sigma),
            t1, rays.directions, white_bkgd)
        if point:
            normal, ort_loss = self._point_normal(m1, c1, v, w1,
                                                  rays.directions,
                                                  use_ort_loss, packed)
            w_norm = w1[..., None] / torch.sum(w1, dim=-1)[..., None, None]
        else:
            # d density / d means = sigmoid(raw_sigma + bias) * d raw_sigma
            # (the noised raw_sigma, as in JAX).
            d_means = torch.sigmoid(raw_sigma + cfg.density_bias) * d_raw
            normal, ort_loss, w_norm = expected_normals(
                w1, -d_means, rays.directions, use_ort_loss)
        out = dict(rgb=comp, distance=dist, acc=acc,
                   dist_loss=(mip.distortion_loss(t1, w1) if train and rnd
                              else None),
                   ort_loss=ort_loss, normal=normal,
                   roughness=torch.sum(w_norm[..., 0] * roughness[..., 0],
                                       dim=-1))
        if emission is not None:
            out["emission"] = torch.sum(w1[..., None] * emission, dim=-2)
        if use_vc_loss and rnd:
            # The same samples under a random view direction, composited
            # with stop-gradient weights: a full re-evaluation (kernel 2;
            # kernel 3 does not return the bottleneck), the same values
            # and gradients as JAX's re-query of the bottleneck. The
            # heads are view-independent: the same emission and chroma.
            d_alt = mip.safe_normalize(draws.d_alt)
            raw_alt, raw_density_alt = self._query(m1, c1, self._venc(d_alt),
                                                   packed)
            rgb_alt = torch.sum(
                w1.detach()[..., None]
                * self._radiance(raw_alt, raw_density_alt), dim=-2)
            if white_bkgd:
                rgb_alt = rgb_alt + (1.0 - acc.detach()[..., None])
            out["rgb_alt"] = rgb_alt
        if rnd and draws.t_sd is not None:
            # The primary ray re-marched at the secondary rays' sampling
            # (num_env_samples Gaussians over [near, far]), composited.
            t_sd, (m_sd, c_sd) = mip.sample_along_rays(
                rays.origins, rays.directions, rays.radii,
                cfg.num_env_samples, rays.near, rays.far, cfg.disparity,
                t_rand=draws.t_sd)
            out["rgb_scale"], out["dist_scale"], _, _ = self._march(
                m_sd, c_sd, v, t_sd, rays.directions, white_bkgd, packed)
        if enable_surf:
            albedo = torch.sum(w_norm * albedos, dim=-2)
            # The collocated surface point keeps its gradient through the
            # distance (the env means' cotangent comes back from kernel 2).
            surf_origins = rays.origins + rays.directions * dist[..., None]
            lit_t, (lm, lc), lit_dirs, solid_angle = self._env_rays(
                surf_origins, normal, env_rays, draws, train, packed)
            if env_kernel and cfg.env_tight_rgb == 0 and not cfg.env_resample:
                B, D, S2 = lm.shape[:3]
                flat_dirs = lit_dirs.reshape(B * D, 3)
                e_rgb, e_dist, e_acc, _ = self._render_train_level(
                    lm.reshape(B * D, S2, 3), lc.reshape(B * D, S2, 3),
                    flat_dirs, lit_t.reshape(B * D, S2 + 1), flat_dirs,
                    False, packed)
                env_rgb, env_dist, env_acc = (e_rgb.reshape(B, D, 3),
                                              e_dist.reshape(B, D),
                                              e_acc.reshape(B, D))
            else:
                v_lit = self._venc(lit_dirs)
                # Under env_resample the blurred march only places the
                # second one (its weights carry no gradient): no backward.
                with torch.no_grad() if cfg.env_resample else nullcontext():
                    env_rgb, env_dist, env_acc, env_w = self._march(
                        lm, lc, v_lit, lit_t, lit_dirs, False, packed)
                if cfg.env_resample:
                    t2, (m2, c2) = self._resample_env(
                        surf_origins, lit_dirs, env_rays.radii, lit_t, env_w,
                        draws.u_resample if rnd else None)
                    env_rgb, env_dist, env_acc, _ = self._march(
                        m2, c2, v_lit, t2, lit_dirs, False, packed)
                elif cfg.env_tight_rgb > 0:
                    env_rgb = self._tight_read(lm, lc, v_lit, lit_t,
                                               lit_dirs, env_rgb, env_w,
                                               packed)
            if train and rnd and cfg.env_distill_samples > 0:
                out.update(self._env_distill(
                    surf_origins, lit_dirs, env_rgb, env_acc, env_dist,
                    env_rays, draws, packed))
            if cfg.illum_field:
                # After the distill's read (which supervises the radiance
                # field itself), before the irradiance integral.
                chroma = self.illum(surf_origins, lit_dirs)
                if train and rnd:
                    out.update(env_pre_illum=env_rgb, illum_chroma=chroma)
                env_rgb = apply_illum(env_rgb, chroma)
            surf_rgb, diffuse, _, shade = shading.surface_rendering(
                env_rgb, albedo, normal, lit_dirs, solid_angle)
            if emission is not None:
                # Outgoing radiance = self-emission + reflected irradiance.
                surf_rgb = surf_rgb + out["emission"]
            out.update(albedo=albedo, surf_rgb=surf_rgb, diffuse=diffuse,
                       shading=shade)
        return LevelOutput(**out)

    def _env_rays(self, surf_origins: Tensor, normal: Tensor,
                  env_rays: Rays, draws: Optional[TrainDraws], train: bool,
                  packed: Optional[Tuple[Tensor, Tensor]]):
        """The secondary rays from the surface points (JAX :521-567), at
        the training or (not `train`) the eval sample count: the fixed env
        directions, or randomized (`draws`) with `env_mode` rotated per
        ray, rotated and jittered in their cells (stratified), or
        importance-sampled (`_importance_dirs`). Returns t [B, D, S+1],
        (means, covs [B, D, S, 3]), dirs [B, D, 3] and the solid angle of
        each direction: env_rays.lossmult [D, 1] for fixed and rotated,
        else [B, D, 1]."""
        cfg = self.cfg
        S = cfg.num_env_samples if train else cfg.env_samples()
        t_rand = None if draws is None else draws.t_env
        near, far, radii = env_rays.near, env_rays.far, env_rays.radii
        mode = "fixed" if draws is None else cfg.env_mode()
        if mode == "fixed":
            return (*mip.sample_env_rays(surf_origins, env_rays.directions,
                                         S, near, far, radii,
                                         t_rand=t_rand), env_rays.lossmult)
        solid_angle = env_rays.lossmult
        if mode == "importance":
            with torch.no_grad():
                dirs, solid_angle = self._importance_dirs(
                    surf_origins.detach(), normal.detach(), env_rays,
                    draws, packed)
        else:
            dirs = rotation.rotate(rotation.random_rotations(draws.q_rot),
                                   env_rays.directions)
            if mode == "stratified":
                dirs, solid_angle = mip.stratified_env_directions(
                    dirs, draws.u_cos, draws.u_phi)
        return (*mip.sample_env_rays_hemisphere(surf_origins, dirs, S, near,
                                                far, radii, t_rand=t_rand),
                solid_angle)

    def _importance_dirs(self, origins: Tensor, normal: Tensor,
                         env_rays: Rays, draws: TrainDraws,
                         packed: Optional[Tuple[Tensor, Tensor]]
                         ) -> Tuple[Tensor, Tensor]:
        """The importance-sampled env directions (JAX `_importance_dirs`,
        :77-114), without gradient (JAX stops it at the probe's luma and
        the normal): a probe march of env_probe_samples Gaussians along
        each of the env_probe_dirs Fibonacci cells rotated per ray
        (`draws.q_rot`), from the surface point over the first env ray's
        [near, far] at its radius, through a kernel-2 forward; its luma x
        (relu(cell . normal) + 0.05) weighs the cells of
        `mip.importance_env_directions`. Returns dirs [B, D, 3] and their
        solid angles [B, D, 1]."""
        cfg = self.cfg
        Dp = cfg.env_probe_dirs
        cells = rotation.rotate(rotation.random_rotations(draws.q_rot),
                                self.probe_dirs)              # [B, Dp, 3]

        def first(x):   # the first env ray's value for every probe cell
            return x[:1].expand(Dp, 1)

        t, (m, c), d = mip.sample_env_rays_hemisphere(
            origins, cells, cfg.env_probe_samples, first(env_rays.near),
            first(env_rays.far), first(env_rays.radii), t_rand=draws.t_probe)
        rgb = self._march(m, c, self._venc(d), t, d, False, packed)[0]
        luma = shading.compute_illumination(rgb)[..., 0]       # [B, Dp]
        cosw = torch.relu(torch.sum(cells * normal[:, None, :], dim=-1)
                          ) + 0.05
        return mip.importance_env_directions(
            cells, (luma + 1e-3) * cosw, env_rays.directions.shape[0],
            draws.gumbel, draws.u_cos, draws.u_phi)

    def _resample_env(self, surf_origins: Tensor, lit_dirs: Tensor,
                      radii: Tensor, lit_t: Tensor, env_w: Tensor,
                      u_rand: Optional[Tensor]
                      ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """The env_resample march (JAX `_resample_env`, :142-166):
        num_env_fine_samples Gaussians per env ray, placed by the blurpool
        CDF of the first march's weights env_w [B, D, S] (no gradient
        through the placement), at the uniforms u_rand [B * D, S_f+1] or
        evenly. Returns t [B, D, S_f+1], (means, covs [B, D, S_f, 3])."""
        B, D = lit_dirs.shape[:2]
        S, Sf = lit_t.shape[-1] - 1, self.cfg.num_env_fine_samples
        origins = surf_origins[:, None, :].expand(B, D, 3)
        rad = radii.reshape(1, -1, 1)[:, :D].expand(B, D, 1)
        t, (m, c) = mip.resample_along_rays(
            origins.reshape(B * D, 3), lit_dirs.reshape(B * D, 3),
            rad.reshape(B * D, 1), lit_t.reshape(B * D, S + 1),
            env_w.reshape(B * D, S), self.cfg.resample_padding,
            num_samples=Sf, u_rand=u_rand)
        return (t.reshape(B, D, Sf + 1),
                (m.reshape(B, D, Sf, 3), c.reshape(B, D, Sf, 3)))

    def _point_normal(self, means: Tensor, covs: Tensor, v_enc: Tensor,
                      weights: Tensor, directions: Tensor,
                      use_ort_loss: bool,
                      packed: Optional[Tuple[Tensor, Tensor]]
                      ) -> Tuple[Tensor, Optional[Tensor]]:
        """The training normal of point_normals (JAX `_point_normal`,
        base.py:772-819): -d raw_sigma / d x at the per-ray expected
        Gaussian (the compositing-weight averages of the fine level's
        means and covariances, detached), one kernel-3 query per ray (S =
        1); gradients flow through the chain. With `use_ort_loss` the
        orientation loss mean relu(n . d)^2."""
        w = (weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                                   min=1e-8)).detach()
        mean_pt = torch.sum(w[..., None] * means, dim=-2,
                            keepdim=True).detach()
        cov_pt = torch.sum(w[..., None] * covs, dim=-2, keepdim=True).detach()
        _, _, d_raw = self._query_normals(mean_pt, cov_pt, v_enc, packed)
        normal = mip.safe_normalize(-d_raw[..., 0, :])
        ort_loss = None
        if use_ort_loss:
            dot = torch.sum(normal * directions, dim=-1)
            ort_loss = torch.mean(torch.relu(dot) ** 2)
        return normal, ort_loss

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
            raw_rgb, raw_density = self._query(m, c * scale, v_enc, packed)
            return self._radiance(raw_rgb, raw_density), raw_density

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
