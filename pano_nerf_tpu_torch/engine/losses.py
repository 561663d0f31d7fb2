"""Training losses of the Pano-NeRF and mip-NeRF systems.

Counterpart of pano_nerf_tpu/engine/losses.py over the terms that
`configs/panonerf.yaml` turns on (`pano_losses`): coarse / fine / surface
volume losses on tone-mapped LDR (ground truth quantized to 8 bits,
predictions tone-mapped without the clamp), the albedo chromaticity
prior, the orientation loss, the distortion loss, the saturation runaway
guard and the luma view-consistency tie; and the mip-NeRF baseline's
(`mipnerf_losses`). Loss keys whose non-default value needs a term the
port does not have raise NotImplementedError naming the key
(`check_loss_config`); the baseline reads only its own keys
(`check_mipnerf_loss_config`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from pano_nerf_tpu_torch.ops.shading import compute_illumination, hdr_to_ldr

Tensor = torch.Tensor

# Beyond-reference loss keys and their production defaults (the JAX
# package's EXTENSION_DEFAULTS): filled into a config that lacks them.
EXTENSION_DEFAULTS = {
    "loss.distortion_loss": 0.01,
    "loss.saturation_loss": 0.01,
    "loss.saturation_margin": 2.0,
    "loss.unclipped_pred_tonemap": True,
    "loss.view_consistency": 0.1,
    "loss.vc_luma": True,
    "loss.emission_sparsity": 0.01,
}

# Loss keys whose non-default value needs a term the port does not have:
# key -> predicate that is True when the value is unsupported.
UNSUPPORTED: Dict[str, Callable] = {
    "loss.scale_distill": lambda v: float(v) != 0.0,
    "loss.scale_distill_dist": lambda v: float(v) != 0.0,
    "loss.env_distill": lambda v: float(v) != 0.0,
    "loss.env_distill_acc": lambda v: float(v) != 0.0,
    "loss.env_distill_dist": lambda v: float(v) != 0.0,
    "loss.illum_distill": lambda v: float(v) != 0.0,
    "loss.vc_chroma": lambda v: float(v) != 0.0,
    "loss.vc_sat_mask": bool,
    "loss.chrom_gate": bool,
    "loss.chrom_illum_comp": bool,
}

# Radiance that ACES + gamma tone-maps to exactly 1.0 (ops/shading.py
# constants): a saturated 8-bit pixel says only "radiance >= knee".
SATURATION_KNEE = (0.56 + (0.3584) ** 0.5) / 0.16


def prepare_hparams(hparams: dict) -> dict:
    """A copy of `hparams` with the beyond-reference loss defaults filled
    in (missing keys only)."""
    out = dict(hparams)
    for key, val in EXTENSION_DEFAULTS.items():
        out.setdefault(key, val)
    return out


def check_loss_config(hparams: dict) -> None:
    """Raise NotImplementedError naming the first unsupported loss key."""
    for key, unsupported in UNSUPPORTED.items():
        if key in hparams and unsupported(hparams[key]):
            raise NotImplementedError(
                f"{key}={hparams[key]!r} is not supported by the "
                "PyTorch/CUDA train step")


# The loss keys `mipnerf_losses` reads; it ignores every other loss key,
# as the JAX baseline does.
MIPNERF_KEYS = ("loss.coarse_loss_mult", "loss.ort_loss")


def check_mipnerf_loss_config(hparams: dict) -> None:
    """Raise KeyError naming the first loss key of the baseline that the
    config lacks."""
    for key in MIPNERF_KEYS:
        if key not in hparams:
            raise KeyError(f"{key}: the mip-NeRF loss needs it")


def masked_mse(pred: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """sum(mask * (pred - target)^2) / sum(mask)."""
    return torch.sum(mask * (pred - target) ** 2) / torch.sum(mask)


def _l2_normalize(x: Tensor, eps: float = 1e-12) -> Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=eps)


def chromaticity_loss(ldr_gt: Tensor, albedo: Tensor) -> Tensor:
    """MSE between unit-normalized LDR color and unit-normalized albedo."""
    return torch.mean((_l2_normalize(ldr_gt) - _l2_normalize(albedo)) ** 2)


def saturation_loss(pred_hdr: Tensor, ldr_gt: Tensor, mask: Tensor,
                    margin: float = 1.0) -> Tensor:
    """One-sided L1 pull of saturated-GT channels down to margin x knee:
    zero value and gradient until a channel exceeds it."""
    sat = (ldr_gt >= 1.0).to(pred_hdr.dtype) * mask
    excess = torch.relu(pred_hdr - margin * SATURATION_KNEE)
    return torch.sum(sat * excess) / torch.clamp(torch.sum(sat), min=1.0)


def pano_losses(outputs: Sequence, rgbs_gt: Tensor, mask: Tensor,
                hparams: Dict, enable_surf: bool
                ) -> Dict[str, Optional[Tensor]]:
    """Pano-NeRF training loss over [coarse, fine] LevelOutputs.

    rgbs_gt: [B, 3] HDR ground truth; mask: [B, 1] lossmult. Returns a
    dict with 'loss' and each component (None where the term is off).
    """
    coarse, fine = outputs[0], outputs[-1]
    ldr_gt = hdr_to_ldr(rgbs_gt,
                        quantize=bool(hparams.get("loss.gt_quantize", True)))
    clamp = not bool(hparams.get("loss.unclipped_pred_tonemap", False))
    vol_coarse = masked_mse(hdr_to_ldr(coarse.rgb, clamp=clamp), ldr_gt,
                            mask)
    vol_fine = masked_mse(hdr_to_ldr(fine.rgb, clamp=clamp), ldr_gt, mask)
    loss = hparams["loss.coarse_loss_mult"] * vol_coarse + vol_fine
    parts: Dict[str, Optional[Tensor]] = dict(
        vol_coarse=vol_coarse, vol_fine=vol_fine, vol_surface=None,
        chrom=None, ort=None)
    if enable_surf and fine.surf_rgb is not None:
        vol_surface = masked_mse(hdr_to_ldr(fine.surf_rgb, clamp=clamp),
                                 ldr_gt, mask)
        loss = loss + hparams["loss.surface_loss"] * vol_surface
        parts["vol_surface"] = vol_surface
        if hparams["loss.chrom_loss"] > 0:
            chrom = chromaticity_loss(ldr_gt, fine.albedo)
            loss = loss + hparams["loss.chrom_loss"] * chrom
            parts["chrom"] = chrom
    if fine.ort_loss is not None:
        loss = loss + hparams["loss.ort_loss"] * fine.ort_loss
        parts["ort"] = fine.ort_loss
    w_dist = float(hparams.get("loss.distortion_loss", 0.0))
    if w_dist > 0 and fine.dist_loss is not None:
        dist = fine.dist_loss + (coarse.dist_loss
                                 if coarse.dist_loss is not None else 0.0)
        loss = loss + w_dist * dist
        parts["dist"] = dist
    w_sat = float(hparams.get("loss.saturation_loss", 0.0))
    if w_sat > 0:
        sat = saturation_loss(fine.rgb, ldr_gt, mask, margin=float(
            hparams.get("loss.saturation_margin", 1.0)))
        loss = loss + w_sat * sat
        parts["sat"] = sat
    w_vc = float(hparams.get("loss.view_consistency", 0.0))
    if w_vc > 0 and fine.rgb_alt is not None:
        if bool(hparams.get("loss.vc_luma", False)):
            vc = masked_mse(
                torch.log1p(compute_illumination(torch.relu(fine.rgb_alt))),
                torch.log1p(compute_illumination(torch.relu(fine.rgb))),
                mask)
        else:
            vc = masked_mse(torch.log1p(torch.relu(fine.rgb_alt)),
                            torch.log1p(torch.relu(fine.rgb)), mask)
        loss = loss + w_vc * vc
        parts["vc"] = vc
    parts["loss"] = loss
    return parts


def mipnerf_losses(outputs: Sequence, rgbs_gt: Tensor, mask: Tensor,
                   hparams: Dict) -> Dict[str, Optional[Tensor]]:
    """The mip-NeRF baseline's loss over [coarse, fine] LevelOutputs: LDR
    MSE of both levels against the 8-bit quantized ground truth (the
    predictions tone-mapped with the clamp), the coarse one weighted by
    `loss.coarse_loss_mult`, plus `loss.ort_loss` x the fine orientation
    loss when that weight is positive. Returns 'loss' and each component
    (`ort` None when off)."""
    coarse, fine = outputs[0], outputs[-1]
    ldr_gt = hdr_to_ldr(rgbs_gt, quantize=True)
    vol_coarse = masked_mse(hdr_to_ldr(coarse.rgb), ldr_gt, mask)
    vol_fine = masked_mse(hdr_to_ldr(fine.rgb), ldr_gt, mask)
    loss = hparams["loss.coarse_loss_mult"] * vol_coarse + vol_fine
    parts: Dict[str, Optional[Tensor]] = dict(vol_coarse=vol_coarse,
                                              vol_fine=vol_fine, ort=None)
    if fine.ort_loss is not None and hparams["loss.ort_loss"] > 0:
        loss = loss + hparams["loss.ort_loss"] * fine.ort_loss
        parts["ort"] = fine.ort_loss
    parts["loss"] = loss
    return parts
