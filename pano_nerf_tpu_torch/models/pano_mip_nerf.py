"""Pano-NeRF eval render: coarse level, fine level with normals, surface path.

Counterpart of `PanoMipNeRF._render_fused` (pano_nerf_tpu/models/
pano_mip_nerf.py:168-246). Every MLP evaluation goes through
`kernels.fused_render.fused_render_level`, three launches per ray chunk:

1. the coarse level (evenly spaced frustums, no extras);
2. the fine level (blurpool resampling of the coarse weights) with
   normals, albedo and roughness;
3. the secondary env rays: from the collocated surface point toward each
   fixed env direction, `num_env_samples` frustums each, composited and
   integrated against a Lambertian BRDF.

The MLP's 5 density channels are density | albedo(3) | roughness.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from pano_nerf_tpu_torch.core.rays import Rays
from pano_nerf_tpu_torch.kernels.fused_render import fused_render_level
from pano_nerf_tpu_torch.models.base import LevelOutput, NerfConfig
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.ops import mip, shading

Tensor = torch.Tensor


class PanoMipNeRF(nn.Module):
    def __init__(self, cfg: NerfConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.mlp = NerfMLP(
            xyz_dim=cfg.xyz_dim, view_dim=cfg.view_dim,
            net_depth=cfg.mlp_net_depth, net_width=cfg.mlp_net_width,
            net_depth_condition=cfg.mlp_net_depth_condition,
            net_width_condition=cfg.mlp_net_width_condition,
            skip_index=cfg.mlp_skip_index,
            num_rgb_channels=cfg.mlp_num_rgb_channels,
            num_density_channels=cfg.mlp_num_density_channels,
            compute_dtype=cfg.compute_dtype, generator=generator)

    @classmethod
    def from_hparams(cls, hparams: dict,
                     generator: Optional[torch.Generator] = None
                     ) -> "PanoMipNeRF":
        return cls(NerfConfig.from_hparams(hparams), generator)

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
