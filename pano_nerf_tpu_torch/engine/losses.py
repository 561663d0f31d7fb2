"""Training losses of the Pano-NeRF and mip-NeRF systems.

Counterpart of pano_nerf_tpu/engine/losses.py over the terms that
`configs/panonerf.yaml`, `panonerf_hdr.yaml` and `panonerf_shadow.yaml`
turn on (`pano_losses`): coarse / fine / surface volume losses on
tone-mapped LDR (ground truth quantized to 8 bits, predictions
tone-mapped without the clamp), the albedo chromaticity prior (with the
illuminant-chroma gate and the illuminant-compensated target), the
orientation loss (with `loss.ort_tie_boost`), the distortion loss, the
saturation runaway guard, the luma view-consistency tie (with the
saturation-masked per-channel tie `loss.vc_sat_mask`), the log-chroma
cross-view tie (`loss.vc_chroma`, one-way with `loss.vc_chroma_sg`), the
cross-scale self-distillation (`loss.scale_distill`, `_dist`), the env
distill ties, weighted by the step's trapezoid (`env_distill_schedule`),
the illuminant-field distill with its rise (`illum_distill_rise`) and
the emission sparsity prior; and the mip-NeRF baseline's
(`mipnerf_losses`). A loss key whose non-default value needs a term the
port does not have would raise NotImplementedError naming the key
(`check_loss_config`; none is left); the baseline reads only its own
keys (`check_mipnerf_loss_config`).
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
# key -> predicate that is True when the value is unsupported. Every term
# of the JAX package's `pano_losses` is ported.
UNSUPPORTED: Dict[str, Callable] = {}

# Radiance that ACES + gamma tone-maps to exactly 1.0 (ops/shading.py
# constants): a saturated 8-bit pixel says only "radiance >= knee".
SATURATION_KNEE = (0.56 + (0.3584) ** 0.5) / 0.16


def use_scale_distill(hparams: dict) -> bool:
    """Whether the step needs the scale-distill re-march (JAX's
    `use_sd`): either of its weights is on."""
    return any(float(hparams.get(k, 0.0)) > 0
               for k in ("loss.scale_distill", "loss.scale_distill_dist"))


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


def chromaticity_loss(ldr_gt: Tensor, albedo: Tensor,
                      weights: Optional[Tensor] = None) -> Tensor:
    """MSE between unit-normalized LDR color and unit-normalized albedo;
    with per-pixel `weights` [B, 1], mean(weights x error), a downweighted
    mean over all pixels (not a weighted mean)."""
    err = (_l2_normalize(ldr_gt) - _l2_normalize(albedo)) ** 2
    return torch.mean(err if weights is None else weights * err)


def illuminant_chroma_gate(shading: Tensor, sigma: float) -> Tensor:
    """Per-pixel confidence [B, 1] that the irradiance `shading` [B, 3]
    is neutral: exp(-(s / sigma)^2), s the distance of its unit vector
    from the unit white (zero shading: s = 1). The caller detaches."""
    white = 1.0 / 3.0 ** 0.5
    s = torch.linalg.norm(_l2_normalize(shading) - white, dim=-1,
                          keepdim=True)
    return torch.exp(-(s / sigma) ** 2)


def env_distill_schedule(hparams: Dict, step: Optional[Tensor]
                         ) -> Optional[Tensor]:
    """The env-distill weights' factor at `step` (a scalar tensor), a
    trapezoid in [0, 1] over fractions of `optimizer.max_steps`: 0 until
    `loss.env_distill_start`, a linear ramp over `_ramp`, 1, a linear fall
    to 0 over `_fall` from `_end`. None when no schedule key is set (a
    flat weight), or when no env-distill weight is on. ValueError for a
    fall without an end, or a schedule without a step."""
    if not any(float(hparams.get(f"loss.env_distill{k}", 0.0)) > 0
               for k in ("", "_acc", "_dist")):
        return None
    start, ramp, end, fall = (float(hparams.get(f"loss.env_distill_{k}",
                                                0.0))
                              for k in ("start", "ramp", "end", "fall"))
    if fall > 0 and end == 0:
        raise ValueError("loss.env_distill_fall > 0 requires "
                         "loss.env_distill_end > 0 (the fall window starts "
                         "at `end`)")
    if not (start > 0 or ramp > 0 or end > 0):
        return None
    if step is None:
        raise ValueError("step-scheduled loss.env_distill_{start,ramp,end} "
                         "set but no `step` was passed to pano_losses")
    max_steps = float(hparams["optimizer.max_steps"])
    s = step.to(torch.float32)
    sched = torch.ones_like(s)
    if start > 0 or ramp > 0:
        sched = torch.clamp((s - start * max_steps)
                            / max(ramp * max_steps, 1.0), 0.0, 1.0)
    if end > 0:
        sched = sched * (1.0 - torch.clamp(
            (s - end * max_steps) / max(fall * max_steps, 1.0), 0.0, 1.0))
    return sched


def illum_distill_rise(hparams: Dict, step: Optional[Tensor]
                       ) -> Optional[Tensor]:
    """The illum-distill weight's factor at `step` (a scalar tensor): 0
    until `loss.illum_distill_start` x `optimizer.max_steps`, then a
    linear rise to 1 over `_ramp` x max_steps (at least one step). None
    when neither key is set (a flat weight); ValueError when one is set
    and no step is given."""
    start = float(hparams.get("loss.illum_distill_start", 0.0))
    ramp = float(hparams.get("loss.illum_distill_ramp", 0.0))
    if not (start > 0 or ramp > 0):
        return None
    if step is None:
        raise ValueError("loss.illum_distill_start/_ramp set but no `step` "
                         "was passed to pano_losses")
    max_steps = float(hparams["optimizer.max_steps"])
    return torch.clamp((step.to(torch.float32) - start * max_steps)
                       / max(ramp * max_steps, 1.0), 0.0, 1.0)


def saturation_loss(pred_hdr: Tensor, ldr_gt: Tensor, mask: Tensor,
                    margin: float = 1.0) -> Tensor:
    """One-sided L1 pull of saturated-GT channels down to margin x knee:
    zero value and gradient until a channel exceeds it."""
    sat = (ldr_gt >= 1.0).to(pred_hdr.dtype) * mask
    excess = torch.relu(pred_hdr - margin * SATURATION_KNEE)
    return torch.sum(sat * excess) / torch.clamp(torch.sum(sat), min=1.0)


def pano_losses(outputs: Sequence, rgbs_gt: Tensor, mask: Tensor,
                hparams: Dict, enable_surf: bool,
                step: Optional[Tensor] = None
                ) -> Dict[str, Optional[Tensor]]:
    """Pano-NeRF training loss over [coarse, fine] LevelOutputs.

    rgbs_gt: [B, 3] HDR ground truth; mask: [B, 1] lossmult; step: the
    step as a scalar tensor (on the card the device counter, so that a
    CUDA graph reads it at every replay), needed by the env-distill
    schedule. Returns a dict with 'loss' and each component (None where
    the term is off).
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
            gate = None
            if (bool(hparams.get("loss.chrom_gate", False))
                    and fine.shading is not None):
                gate = illuminant_chroma_gate(
                    fine.shading.detach(),
                    float(hparams.get("loss.chrom_gate_sigma", 0.2)))
            target = ldr_gt
            if (bool(hparams.get("loss.chrom_illum_comp", False))
                    and fine.shading is not None):
                # GT radiance over the irradiance per channel, the divisor
                # floored relative to its brightest channel.
                shade = fine.shading.detach()
                floor = torch.clamp(float(hparams.get(
                    "loss.chrom_illum_floor", 0.1)) * torch.amax(
                        shade, dim=-1, keepdim=True), min=1e-3)
                target = rgbs_gt / torch.maximum(shade, floor)
            chrom = chromaticity_loss(target, fine.albedo, gate)
            loss = loss + hparams["loss.chrom_loss"] * chrom
            parts["chrom"] = chrom
    ed_sched = env_distill_schedule(hparams, step)
    w_ed, w_eda, w_edd = (float(hparams.get(f"loss.env_distill{k}", 0.0))
                          for k in ("", "_acc", "_dist"))
    if fine.ort_loss is not None:
        w_ort = hparams["loss.ort_loss"]
        boost = float(hparams.get("loss.ort_tie_boost", 0.0))
        if boost > 0 and (w_ed > 0 or w_eda > 0):
            # Riding the env-distill trapezoid: boost x the weight while
            # the tie is at full weight, back to it as the tie falls.
            tie = 1.0 if ed_sched is None else ed_sched
            w_ort = w_ort * (1.0 + (boost - 1.0) * tie)
        loss = loss + w_ort * fine.ort_loss
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
            if bool(hparams.get("loss.vc_sat_mask", False)):
                # Plus the per-channel tie on the channels whose ground
                # truth is unsaturated.
                unsat = (ldr_gt < 1.0).to(fine.rgb.dtype) * mask
                diff = (torch.log1p(torch.relu(fine.rgb_alt))
                        - torch.log1p(torch.relu(fine.rgb)))
                vc = vc + torch.sum(unsat * diff ** 2) / torch.clamp(
                    torch.sum(unsat), min=1.0)
        else:
            vc = masked_mse(torch.log1p(torch.relu(fine.rgb_alt)),
                            torch.log1p(torch.relu(fine.rgb)), mask)
        loss = loss + w_vc * vc
        parts["vc"] = vc
    # The log-chroma tie between the two views of the same samples
    # (log1p radiance minus its channel mean), the primary side a
    # stop-gradient target with loss.vc_chroma_sg.
    w_vcc = float(hparams.get("loss.vc_chroma", 0.0))
    if w_vcc > 0 and fine.rgb_alt is not None:
        log_p = torch.log1p(torch.relu(fine.rgb))
        log_a = torch.log1p(torch.relu(fine.rgb_alt))
        chroma_p = log_p - torch.mean(log_p, dim=-1, keepdim=True)
        if bool(hparams.get("loss.vc_chroma_sg", False)):
            chroma_p = chroma_p.detach()
        vcc = masked_mse(log_a - torch.mean(log_a, dim=-1, keepdim=True),
                         chroma_p, mask)
        loss = loss + w_vcc * vcc
        parts["vcc"] = vcc
    # Cross-scale self-distillation: the re-march at the secondary rays'
    # scale tied to the fine level (stop-gradient targets), radiance in
    # log1p space and, with its own weight, the expected distance.
    w_sd = float(hparams.get("loss.scale_distill", 0.0))
    w_sdd = float(hparams.get("loss.scale_distill_dist", 0.0))
    if (w_sd > 0 or w_sdd > 0) and fine.rgb_scale is not None:
        sd = masked_mse(torch.log1p(torch.relu(fine.rgb_scale)),
                        torch.log1p(torch.relu(fine.rgb)).detach(), mask)
        if w_sdd > 0 and fine.dist_scale is not None:
            sd_dist = masked_mse(fine.dist_scale[..., None],
                                 fine.distance.detach()[..., None], mask)
            loss = loss + w_sdd * sd_dist
            parts["scale_distill_dist"] = sd_dist
        loss = loss + w_sd * sd
        parts["scale_distill"] = sd
    # The env-distill ties along each ray's selected env direction, to
    # stop-gradient targets: radiance in log1p space, opacity raw,
    # distance in log space.
    ties = (("env_distill", w_ed, fine.env_read, fine.env_fine,
             lambda x: torch.log1p(torch.relu(x))),
            ("env_distill_acc", w_eda, fine.env_read_acc, fine.env_fine_acc,
             lambda x: x[..., None]),
            ("env_distill_dist", w_edd, fine.env_read_dist,
             fine.env_fine_dist,
             lambda x: torch.log(torch.clamp(x, min=1e-3))[..., None]))
    for name, w, read, target, f in ties:
        if w > 0 and read is not None:
            tie = masked_mse(f(read), f(target), mask)
            loss = loss + (w if ed_sched is None else w * ed_sched) * tie
            parts[name] = tie
    # The illuminant-field distill: the pre-tint secondary read's chroma
    # pulled toward the field's (stop-gradient), per (point, direction).
    w_ild = float(hparams.get("loss.illum_distill", 0.0))
    if w_ild > 0 and fine.env_pre_illum is not None:
        pre = torch.relu(fine.env_pre_illum)
        pre_chroma = pre / (torch.sum(pre, dim=-1, keepdim=True) + 1e-4)
        n = pre_chroma.shape[0]
        ild = masked_mse(pre_chroma.reshape(n, -1),
                         fine.illum_chroma.detach().reshape(n, -1), mask)
        rise = illum_distill_rise(hparams, step)
        loss = loss + (w_ild if rise is None else w_ild * rise) * ild
        parts["illum_distill"] = ild
    # Emission sparsity: L1 of the composited self-emission (non-negative).
    w_em = float(hparams.get("loss.emission_sparsity", 0.0))
    if w_em > 0 and fine.emission is not None:
        em = torch.sum(mask * fine.emission) / (
            3.0 * torch.clamp(torch.sum(mask), min=1.0))
        loss = loss + w_em * em
        parts["emission"] = em
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
