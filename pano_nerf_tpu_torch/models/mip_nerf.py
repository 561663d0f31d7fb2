"""The mip-NeRF baseline: `nerf.num_levels` levels (2 shipped), one
density channel.

Counterpart of pano_nerf_tpu/models/mip_nerf.py `MipNeRF.__call__` and
its level loop, with two forwards, each with one path:

* `forward`, the eval render (`first_order=True`): every level but the
  last through kernel 2 (`kernels.fused_mlp_ipe`), the last through
  kernel 3's forward (`kernels.fused_mlp_normals`), which returns the raw
  outputs and d raw_density / d means in one launch. JAX takes that
  derivative as a `jax.vjp` through kernel 2 with the cotangent (0 for
  rgb, 1 for density); it is the same function, and d density / d means
  = sigmoid(raw + density_bias) * d raw / d means turns into the expected
  normal. The other levels' normal is a placeholder of ones, as in JAX.
* `train_forward`, the training step's forward: every level through
  kernel 2 (forward and backward), or, with the orientation loss on
  (`use_ort_loss`), the last through kernel 3 with its explicit
  density-gradient chain, as JAX's fine-scope kernel policy does.

Both take their randomness as `MipDraws` (stratification, resampling
jitter and `nerf.density_noise` on every level's raw density), or run
deterministic without them (`train.randomized: false`, `val.randomized`
off). Compositing is plain torch (`ops.mip.volumetric_rendering`). There
is no surface or irradiance path and no env ray. Where JAX's route
predicate keeps the model off its kernels (f32, another trunk or
view-branch depth or skip, no view directions: `models/base.py`
`plain_route_reasons`), kernels 2 and 3 give way to the plain NerfMLP and
its explicit chain (`NerfModel._query`, `_query_normals`), JAX's XLA
route.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from pano_nerf_tpu_torch.core.rays import Rays
from pano_nerf_tpu_torch.models.base import (LevelOutput, NerfConfig,
                                             NerfModel, expected_normals,
                                             level_noise, level_uniforms)
from pano_nerf_tpu_torch.ops import mip

Tensor = torch.Tensor


class MipDraws(NamedTuple):
    """The random numbers of one randomized forward: a training step, or
    under `val.randomized` an eval chunk (at the eval sample counts). JAX
    draws them from its key schedule inside the step; the port takes them
    as inputs. Levels after level 1 (`nerf.num_levels` > 2) have `u_more`
    and `noise_more`, drawn last."""
    t_coarse: Tensor  # [B, Nc+1] uniforms: coarse stratification
    u_fine: Tensor    # [B, N+1] uniforms: resampling jitter of level 1
    # density_noise: standard normals on the raw density of levels 0, 1.
    noise_coarse: Optional[Tensor] = None  # [B, Nc, 1]
    noise_fine: Optional[Tensor] = None    # [B, N, 1]
    # nerf.num_levels L > 2: levels 2..L-1's resampling jitter and noise.
    u_more: Optional[Tensor] = None        # [L-2, B, N+1]
    noise_more: Optional[Tensor] = None    # [L-2, B, N, 1]


class MipNeRF(NerfModel):
    @classmethod
    def from_hparams(cls, hparams: dict,
                     generator: Optional[torch.Generator] = None
                     ) -> "MipNeRF":
        """One density channel, whatever `nerf.mlp.num_density_channels`
        says (JAX's `BaseNeRF` default, which `from_hparams` keeps). The
        study switches other than `nerf.density_noise` are Pano-NeRF's,
        and JAX's mip-NeRF ignores them too."""
        return cls(NerfConfig.from_hparams(hparams,
                                           mlp_num_density_channels=1),
                   generator)

    def _with_normals(self, rays: Rays, means: Tensor, covs: Tensor,
                      v: Tensor, t_samples: Tensor, white_bkgd: bool,
                      use_ort_loss: bool, noise: Optional[Tensor],
                      packed: Optional[Tuple[Tensor, Tensor]]
                      ) -> Tuple[LevelOutput, Tensor]:
        """A level through kernel 3 (`_query_normals`), its raw density
        noised by `noise`: composited products, the expected normal from
        d density / d means and (with `use_ort_loss`) the orientation
        loss; and its weights."""
        cfg = self.cfg
        raw_rgb, raw_density, d_raw = self._query_normals(means, covs, v,
                                                          packed)
        raw_sigma = self._noisy(raw_density[..., :1], noise)
        comp, dist, acc, weights = mip.volumetric_rendering(
            self._rgb(raw_rgb), self._density(raw_sigma), t_samples,
            rays.directions, white_bkgd)
        d_means = torch.sigmoid(raw_sigma + cfg.density_bias) * d_raw
        normal, ort_loss, _ = expected_normals(weights, -d_means,
                                               rays.directions, use_ort_loss)
        return LevelOutput(rgb=comp, distance=dist, acc=acc, normal=normal,
                           ort_loss=ort_loss), weights

    def _levels(self, rays: Rays, draws: Optional[MipDraws], train: bool,
                white_bkgd: bool, normals: bool, use_ort_loss: bool,
                packed: Optional[Tuple[Tensor, Tensor]]
                ) -> List[LevelOutput]:
        """JAX's level loop (`mip_nerf.py:48-100`) at the training or the
        eval sample counts, randomized by `draws` or deterministic: every
        level through kernel 2, the last one through kernel 3 with its
        normal where `normals`."""
        cfg = self.cfg
        v = self._venc(rays.viewdirs)
        ret: List[LevelOutput] = []
        t, w = None, None
        for i_level in range(cfg.num_levels):
            t, (m, c) = cfg.sample_level(rays, i_level, t, w,
                                         eval_counts=not train,
                                         u=level_uniforms(draws, i_level))
            noise = level_noise(draws, i_level)
            if normals and i_level == cfg.num_levels - 1:
                out, w = self._with_normals(rays, m, c, v, t, white_bkgd,
                                            use_ort_loss, noise, packed)
            else:
                comp, dist, acc, w = self._march(m, c, v, t, rays.directions,
                                                 white_bkgd, packed,
                                                 noise=noise)
                # The eval's placeholder normal of ones, as in JAX.
                out = LevelOutput(rgb=comp, distance=dist, acc=acc,
                                  normal=None if train
                                  else torch.ones_like(comp))
            ret.append(out)
        return ret

    def forward(self, rays: Rays, white_bkgd: bool,
                packed: Optional[Tuple[Tensor, Tensor]] = None,
                draws: Optional[MipDraws] = None) -> List[LevelOutput]:
        """The eval render of a ray chunk: one output per level, the last
        with its normal (kernel 3's forward), the others with a normal of
        ones. Randomized by `draws` (`make_draws(eval_counts=True)`,
        `val.randomized`), else deterministic.

        rays: [B, ...]; `packed` is the kernels' packed parameters
        (`fused_render.pack_params(self.mlp)`), reused across chunks.
        """
        return self._levels(rays, draws, False, white_bkgd, True, False,
                            packed)

    def make_draws(self, batch: int, generator: torch.Generator,
                   eval_counts: bool = False) -> MipDraws:
        """Draw one randomized forward's MipDraws on the generator's
        device (the density noise only with `nerf.density_noise`, the
        levels after level 1 last; at `eval_counts` the eval counts)."""
        cfg, dev = self.cfg, generator.device
        nc, n = cfg.coarse_samples(eval_counts), cfg.fine_samples(eval_counts)

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        draws = MipDraws(t_coarse=rand(batch, nc + 1),
                         u_fine=rand(batch, n + 1))
        if cfg.density_noise > 0:
            draws = draws._replace(noise_coarse=randn(batch, nc, 1),
                                   noise_fine=randn(batch, n, 1))
        more = cfg.num_levels - 2
        if more > 0:
            draws = draws._replace(u_more=rand(more, batch, n + 1))
            if cfg.density_noise > 0:
                draws = draws._replace(noise_more=randn(more, batch, n, 1))
        return draws

    def train_forward(self, rays: Rays, draws: Optional[MipDraws],
                      white_bkgd: bool, use_ort_loss: bool,
                      packed: Optional[Tuple[Tensor, Tensor]] = None
                      ) -> List[LevelOutput]:
        """The forward of a train step: one output per level, the last
        with its normal and orientation loss when `use_ort_loss`;
        randomized by `draws`, or (None: `train.randomized: false`)
        evenly placed and without noise.

        rays: [B, ...]; `packed` is the kernels' packed parameters, shared
        by the kernel calls of the step.
        """
        return self._levels(rays, draws, True, white_bkgd, use_ort_loss,
                            use_ort_loss, packed)
