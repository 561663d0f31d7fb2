"""The mip-NeRF baseline: a coarse and a fine level, one density channel.

Counterpart of pano_nerf_tpu/models/mip_nerf.py `MipNeRF.__call__`, with
two forwards, each with one path:

* `forward`, the eval render (`first_order=True`): the coarse level
  through kernel 2 (`kernels.fused_mlp_ipe`), the fine level through
  kernel 3's forward (`kernels.fused_mlp_normals`), which returns the raw
  outputs and d raw_density / d means in one launch. JAX takes that
  derivative as a `jax.vjp` through kernel 2 with the cotangent (0 for
  rgb, 1 for density); it is the same function, and d density / d means
  = sigmoid(raw + density_bias) * d raw / d means turns into the expected
  normal. The coarse normal is a placeholder of ones, as in JAX.
* `train_forward`, the training step's forward (randomized): both levels
  through kernel 2 (forward and backward), or, with the orientation loss
  on (`use_ort_loss`), the fine level through kernel 3 with its explicit
  density-gradient chain, as JAX's fine-scope kernel policy does. Its
  randomness comes in as `MipDraws`.

Compositing is plain torch (`ops.mip.volumetric_rendering`). There is no
surface or irradiance path and no env ray. Where JAX's route predicate
keeps the model off its kernels (f32, another trunk or view-branch
depth or skip, no view directions: `models/base.py`
`plain_route_reasons`), kernels 2 and 3 give way to the plain NerfMLP and
its explicit chain (`NerfModel._query`, `_query_normals`), JAX's XLA
route.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from pano_nerf_tpu_torch.core.rays import Rays
from pano_nerf_tpu_torch.models.base import (LevelOutput, NerfConfig,
                                             NerfModel, expected_normals)
from pano_nerf_tpu_torch.ops import mip

Tensor = torch.Tensor


class MipDraws(NamedTuple):
    """The random numbers of one training forward (JAX draws them from
    its key schedule inside the step; the port takes them as inputs)."""
    t_coarse: Tensor  # [B, Nc+1] uniforms: coarse stratification
    u_fine: Tensor    # [B, N+1] uniforms: resampling jitter


class MipNeRF(NerfModel):
    @classmethod
    def from_hparams(cls, hparams: dict,
                     generator: Optional[torch.Generator] = None
                     ) -> "MipNeRF":
        """One density channel, whatever `nerf.mlp.num_density_channels`
        says (JAX's `BaseNeRF` default, which `from_hparams` keeps).
        `nerf.density_noise`, which JAX's mip-NeRF honours and this one
        does not, raises NotImplementedError naming the key; the other
        study switches are Pano-NeRF's, and JAX's mip-NeRF ignores them
        too."""
        cfg = NerfConfig.from_hparams(hparams, mlp_num_density_channels=1)
        if cfg.density_noise != 0:
            raise NotImplementedError(
                f"nerf.density_noise={cfg.density_noise!r} is not supported "
                "by the PyTorch/CUDA mip-NeRF")
        return cls(cfg, generator)

    def _fine_with_normals(self, rays: Rays, means: Tensor, covs: Tensor,
                           v: Tensor, t_samples: Tensor, white_bkgd: bool,
                           use_ort_loss: bool,
                           packed: Optional[Tuple[Tensor, Tensor]]
                           ) -> LevelOutput:
        """The fine level through kernel 3 (`_query_normals`): composited
        products, the expected normal from d density / d means and (with
        `use_ort_loss`) the orientation loss."""
        cfg = self.cfg
        raw_rgb, raw_density, d_raw = self._query_normals(means, covs, v,
                                                          packed)
        raw_sigma = raw_density[..., :1]
        comp, dist, acc, weights = mip.volumetric_rendering(
            self._rgb(raw_rgb), self._density(raw_sigma), t_samples,
            rays.directions, white_bkgd)
        d_means = torch.sigmoid(raw_sigma + cfg.density_bias) * d_raw
        normal, ort_loss, _ = expected_normals(weights, -d_means,
                                               rays.directions, use_ort_loss)
        return LevelOutput(rgb=comp, distance=dist, acc=acc, normal=normal,
                           ort_loss=ort_loss)

    def forward(self, rays: Rays, white_bkgd: bool,
                packed: Optional[Tuple[Tensor, Tensor]] = None
                ) -> List[LevelOutput]:
        """Deterministic render of a ray chunk: [coarse, fine] outputs.

        rays: [B, ...]; `packed` is the kernels' packed parameters
        (`fused_render.pack_params(self.mlp)`), reused across chunks.
        """
        cfg = self.cfg
        v = self._venc(rays.viewdirs)
        t0, (m0, c0) = cfg.sample_level(rays, 0, None, None)
        comp, dist, acc, w0 = self._march(m0, c0, v, t0, rays.directions,
                                          white_bkgd, packed)
        coarse = LevelOutput(rgb=comp, distance=dist, acc=acc,
                             normal=torch.ones_like(comp))
        t1, (m1, c1) = cfg.sample_level(rays, 1, t0, w0)
        return [coarse, self._fine_with_normals(rays, m1, c1, v, t1,
                                                white_bkgd, False, packed)]

    def make_draws(self, batch: int, generator: torch.Generator
                   ) -> MipDraws:
        """Draw one step's MipDraws on the generator's device."""
        cfg, dev = self.cfg, generator.device
        return MipDraws(
            t_coarse=torch.rand((batch, cfg.train_coarse_samples() + 1),
                                generator=generator, device=dev),
            u_fine=torch.rand((batch, cfg.num_samples + 1),
                              generator=generator, device=dev))

    def train_forward(self, rays: Rays, draws: MipDraws, white_bkgd: bool,
                      use_ort_loss: bool,
                      packed: Optional[Tuple[Tensor, Tensor]] = None
                      ) -> List[LevelOutput]:
        """Randomized forward of a train step: [coarse, fine] outputs, the
        fine level with its normal and orientation loss when
        `use_ort_loss`.

        rays: [B, ...]; `packed` is the kernels' packed parameters, shared
        by the kernel calls of the step.
        """
        cfg = self.cfg
        v = self._venc(rays.viewdirs)
        t0, (m0, c0) = mip.sample_along_rays(
            rays.origins, rays.directions, rays.radii,
            cfg.train_coarse_samples(), rays.near, rays.far, cfg.disparity,
            t_rand=draws.t_coarse)
        comp, dist, acc, w0 = self._march(m0, c0, v, t0, rays.directions,
                                          white_bkgd, packed)
        ret = [LevelOutput(rgb=comp, distance=dist, acc=acc)]
        t1, (m1, c1) = mip.resample_along_rays(
            rays.origins, rays.directions, rays.radii, t0, w0,
            cfg.resample_padding, num_samples=cfg.num_samples,
            u_rand=draws.u_fine)
        if use_ort_loss:
            ret.append(self._fine_with_normals(rays, m1, c1, v, t1,
                                               white_bkgd, True, packed))
        else:
            comp, dist, acc, _ = self._march(m1, c1, v, t1, rays.directions,
                                             white_bkgd, packed)
            ret.append(LevelOutput(rgb=comp, distance=dist, acc=acc))
        return ret
