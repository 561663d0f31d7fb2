"""The Pano-NeRF render system: model, env rays and the chunked renderer.

Counterpart of the eval subset of pano_nerf_tpu/engine/system.py
(`PanoNeRFSystem.make_render_image`, chunked by `BaseSystem._chunked`).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import torch

from pano_nerf_tpu_torch.core.device import resolve_device
from pano_nerf_tpu_torch.core.rays import Rays, rays_map, rays_to_tensors
from pano_nerf_tpu_torch.kernels.fused_render import pack_params
from pano_nerf_tpu_torch.models.pano_mip_nerf import PanoMipNeRF

Tensor = torch.Tensor


class PanoNeRFSystem:
    """Holds the model on its device and renders images in chunks.

    `device` defaults to the CUDA card; pass "cpu" for the plain PyTorch
    path. `init_seed` seeds the `torch.Generator` of the Xavier init.
    """

    def __init__(self, hparams: Dict,
                 device: Optional[Union[str, torch.device]] = None,
                 init_seed: int = 0):
        if hparams["nerf.mlp_name"] != "panonerf":
            raise NotImplementedError(
                f"nerf.mlp_name={hparams['nerf.mlp_name']!r}: the port "
                "renders the 'panonerf' system only")
        self.hparams = hparams
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(init_seed))
        self.model = PanoMipNeRF.from_hparams(hparams, gen).to(self.device)
        self.model.eval()
        self.white_bkgd = bool(hparams["train.white_bkgd"])
        self.val_chunk_size = int(hparams["val.chunk_size"])
        self.env_rays: Optional[Rays] = None

    def set_env_rays(self, env_rays) -> None:
        """Env directions: a Rays of numpy arrays, [D, ...]."""
        self.env_rays = rays_to_tensors(env_rays, self.device)

    def make_render_image(self, enable_surf: bool = True) -> Callable:
        """Returns render_fn(params, rays) -> dict of [N, C] tensors.

        `params` is the MLP's state_dict (loaded into the model first) or
        None to keep the current weights; `rays` are flat [N, ...] tensors
        on the system's device. Rays are rendered `val.chunk_size` at a
        time; the last chunk is padded with the last ray, and the padding
        is dropped from the products.
        """
        if self.env_rays is None and enable_surf:
            raise RuntimeError("call set_env_rays() first")
        model, chunk = self.model, self.val_chunk_size

        @torch.no_grad()
        def render_fn(params: Optional[Mapping[str, Tensor]], rays: Rays
                      ) -> Dict[str, Tensor]:
            if params is not None:
                model.mlp.load_state_dict(params)
            packed = (pack_params(model.mlp)
                      if self.device.type == "cuda" else None)
            n = rays.origins.shape[0]
            pad = (-n) % chunk
            if pad:
                rays = rays_map(lambda x: torch.cat(
                    [x, x[-1:].expand(pad, x.shape[-1])], 0), rays)
            parts = []
            for start in range(0, n + pad, chunk):
                chunk_rays = rays_map(
                    lambda x: x[start:start + chunk].contiguous(), rays)
                c, f = model(chunk_rays, self.env_rays, self.white_bkgd,
                             enable_surf, packed=packed)
                out = dict(rgb_coarse=c.rgb, dep_coarse=c.distance[:, None],
                           rgb_fine=f.rgb, dep_fine=f.distance[:, None],
                           normal=f.normal)
                if enable_surf:
                    out.update(albedo=f.albedo,
                               roughness=f.roughness[:, None],
                               surf_rgb=f.surf_rgb, shading=f.shading)
                parts.append(out)
            return {k: torch.cat([p[k] for p in parts], 0)[:n]
                    for k in parts[0]}

        return render_fn
