"""Validation: full-panorama rendering, metrics and the product tree.

Counterpart of pano_nerf_tpu/engine/validation.py.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pano_nerf_tpu_torch.core.rays import Rays, rays_map, rays_to_tensors
from pano_nerf_tpu_torch.ops.shading import hdr_to_ldr
from pano_nerf_tpu_torch.utils import metrics as M
from pano_nerf_tpu_torch.utils.vis import hotmap, save_results

# The 11 image products of one validated panorama (directory names), and
# with the emissive head a 12th, `pred_emission`.
PRODUCTS = ("gt_hdr", "pred_hdr", "gt_ldr", "pred_ldr", "gt_normal",
            "pred_normal", "gt_depth", "pred_depth", "pred_hdr_surf",
            "pred_ldr_surf", "pred_albedo")


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def render_full_pano(render_fn: Callable, params, rays: Rays, height: int,
                     width: int, device: torch.device
                     ) -> Dict[str, np.ndarray]:
    """Flatten a panorama's rays, render them chunked, reshape to [H, W, C]."""
    flat = rays_to_tensors(
        rays_map(lambda x: x.reshape(-1, x.shape[-1]), rays), device)
    out = render_fn(params, flat)
    return {k: v.float().cpu().numpy().reshape(height, width, -1)
            for k, v in out.items()}


def validation_metrics(products: Dict[str, np.ndarray], gt_rgb: np.ndarray,
                       gt_depth: np.ndarray, gt_normal: np.ndarray,
                       gt_albedo: Optional[np.ndarray], near: float,
                       far: float) -> Dict[str, float]:
    """Solid-angle-weighted HDR/LDR/geometry metrics of one panorama."""
    pred_hdr = products["rgb_fine"]
    gt_hdr = gt_rgb[..., :3]
    pred_ldr, gt_ldr = hdr_to_ldr(pred_hdr), hdr_to_ldr(gt_hdr)
    out = {"psnr_hdr_vol": M.ws_psnr(pred_hdr, gt_hdr),
           "psnr_ldr_vol": M.ws_psnr(pred_ldr, gt_ldr),
           "ssim_ldr_vol": M.ssim(pred_ldr, gt_ldr)}
    pred_d = np.clip(products["dep_fine"], near, far)
    dm = M.depth_metrics(pred_d[..., 0], gt_depth[..., 0],
                         np.ones_like(gt_depth[..., 0]))
    out.update({f"depth_{k}": v for k, v in dm.items()})
    out["normal_ws_mae"] = M.ws_mae(_normalize(products["normal"]),
                                    _normalize(gt_normal))
    if "surf_rgb" in products:
        out["psnr_hdr_surf"] = M.ws_psnr(products["surf_rgb"], gt_hdr)
    if "albedo" in products and gt_albedo is not None:
        out["albedo_simse"] = M.scale_invariant_mse(products["albedo"],
                                                    gt_albedo)
    return out


def save_validation_products(products: Dict[str, np.ndarray],
                             gt_rgb: np.ndarray, gt_depth: np.ndarray,
                             gt_normal: np.ndarray, save_dir: str,
                             index: int, near: float, far: float) -> None:
    """Write the validation image tree: {gt,pred}_{hdr.exr, ldr.png,
    normal.png, depth.png}, pred_{hdr_surf.exr, ldr_surf.png, albedo.png}
    when the surface products are present and pred_emission.exr (the
    composited self-emission, HDR) with the emissive head."""
    save_dir = Path(save_dir)
    gt_hdr, pred_hdr = gt_rgb[..., :3], products["rgb_fine"]
    name = f"{index:03d}"

    def depth_img(x):
        return hotmap((np.clip(x, near, far) - near) / (far - near))

    save_results(gt_hdr, save_dir / "gt_hdr" / f"{name}.exr")
    save_results(pred_hdr, save_dir / "pred_hdr" / f"{name}.exr")
    save_results(hdr_to_ldr(gt_hdr), save_dir / "gt_ldr" / f"{name}.png")
    save_results(hdr_to_ldr(pred_hdr, quantize=True),
                 save_dir / "pred_ldr" / f"{name}.png")
    save_results((_normalize(gt_normal) + 1) / 2,
                 save_dir / "gt_normal" / f"{name}.png")
    save_results((_normalize(products["normal"]) + 1) / 2,
                 save_dir / "pred_normal" / f"{name}.png")
    save_results(depth_img(gt_depth), save_dir / "gt_depth" / f"{name}.png")
    save_results(depth_img(products["dep_fine"]),
                 save_dir / "pred_depth" / f"{name}.png")
    if "surf_rgb" in products:
        save_results(products["surf_rgb"],
                     save_dir / "pred_hdr_surf" / f"{name}.exr")
        save_results(hdr_to_ldr(products["surf_rgb"], quantize=True),
                     save_dir / "pred_ldr_surf" / f"{name}.png")
    if "albedo" in products:
        save_results(products["albedo"],
                     save_dir / "pred_albedo" / f"{name}.png")
    if "emission" in products:
        save_results(products["emission"],
                     save_dir / "pred_emission" / f"{name}.exr")
