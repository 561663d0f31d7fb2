"""Hyperparameters, level outputs and sampling of the two model families.

Counterpart of pano_nerf_tpu/models/base.py: `from_hparams` (with the
`__post_init__` checks of the tight re-read's variants), `_sample_level`,
`_env_samples` and `_expected_normals`, shared by Pano-NeRF
(`models/pano_mip_nerf.py`) and the mip-NeRF baseline
(`models/mip_nerf.py`). Each model takes the JAX package's kernel route
for its config (for Pano-NeRF's eval the whole-level render kernel, or
kernels 2 and 3 with the tight re-read; the whole-level training kernel
for the coarse level and env queries when `use_train_render_kernel` is
on), so `from_hparams` refuses every config key that would need another
path (`UNSUPPORTED`) with NotImplementedError naming the key,
instead of silently computing something else. The MLP widths are not
config-checked: the CUDA kernels raise on widths they were not compiled
for, while the plain versions on the CPU take any width.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from pano_nerf_tpu_torch.core.rays import Rays
from pano_nerf_tpu_torch.kernels.fused_mlp_ipe import fused_mlp_ipe_apply
from pano_nerf_tpu_torch.kernels.fused_render import softplus
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.ops import mip

Tensor = torch.Tensor


class LevelOutput(NamedTuple):
    """Per-level render products; optional fields are None when absent."""
    rgb: Tensor                        # [B, 3] composited HDR radiance
    distance: Tensor                   # [B] expected termination distance
    acc: Tensor                        # [B] opacity
    normal: Optional[Tensor] = None    # [B, 3] expected surface normal
    albedo: Optional[Tensor] = None    # [B, 3] expected albedo
    roughness: Optional[Tensor] = None  # [B] expected roughness
    surf_rgb: Optional[Tensor] = None  # [B, 3] surface-rendered radiance
    diffuse: Optional[Tensor] = None   # [B, 3] diffuse term
    shading: Optional[Tensor] = None   # [B, 3] irradiance term
    ort_loss: Optional[Tensor] = None  # scalar orientation loss (training)
    dist_loss: Optional[Tensor] = None  # scalar distortion loss (training)
    rgb_alt: Optional[Tensor] = None   # [B, 3] same samples, random viewdir
    # The env-distill pair along one random env direction per ray
    # (training): the secondary read and its stop-gradient target from a
    # finer re-march, as radiance [B, 3], opacity [B], distance [B].
    env_read: Optional[Tensor] = None
    env_fine: Optional[Tensor] = None
    env_read_acc: Optional[Tensor] = None
    env_fine_acc: Optional[Tensor] = None
    env_read_dist: Optional[Tensor] = None
    env_fine_dist: Optional[Tensor] = None


# Config keys whose non-default value needs a render path the port does
# not have: key -> predicate that is True when the value is unsupported.
UNSUPPORTED: Dict[str, Callable] = {
    "nerf.density_noise": lambda v: float(v) != 0.0,
    # Refused alone, so also beside env_tight_rgb > 0 (under env_resample
    # JAX skips the tight re-read and marches a second time instead).
    "nerf.env_resample": bool,
    "nerf.illum_field": bool,
    "nerf.emissive_head": bool,
    "nerf.chroma_head": bool,
    "nerf.env_rotation": bool,
    "nerf.env_importance": bool,
    "nerf.env_sampling": lambda v: v not in ("auto", "fixed"),
    "nerf.disable_integration": bool,
    "nerf.use_viewdirs": lambda v: not bool(v),
    "nerf.append_identity": lambda v: not bool(v),
    "nerf.ray_shape": lambda v: v != "cone",
    "nerf.num_levels": lambda v: int(v) != 2,
    "nerf.stop_resample_grad": lambda v: not bool(v),
    "nerf.mlp.net_depth": lambda v: int(v) != 8,
    "nerf.mlp.skip_index": lambda v: int(v) != 4,
    "nerf.mlp.net_depth_condition": lambda v: int(v) != 1,
    "nerf.mlp.num_rgb_channels": lambda v: int(v) != 3,
    "nerf.min_deg_point": lambda v: int(v) != 0,
    "nerf.max_deg_point": lambda v: int(v) != 16,
    "nerf.deg_view": lambda v: int(v) != 4,
    "val.randomized": bool,
}

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f32": torch.float32, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    """Static hyperparameters of the eval render (reference ctor names)."""
    num_samples: int = 56
    num_coarse_samples: int = 0
    num_levels: int = 2
    resample_padding: float = 0.01
    disparity: bool = False
    min_deg_point: int = 0
    max_deg_point: int = 16
    deg_view: int = 4
    density_bias: float = -1.0
    rgb_padding: float = 0.0
    mlp_net_depth: int = 8
    mlp_net_width: int = 256
    mlp_net_depth_condition: int = 1
    mlp_net_width_condition: int = 128
    mlp_skip_index: int = 4
    mlp_num_rgb_channels: int = 3
    # Set by the model class, never by the config (as in JAX, whose
    # `from_hparams` does not read `nerf.mlp.num_density_channels`):
    # mip-NeRF keeps this default of 1, Pano-NeRF forces 5.
    mlp_num_density_channels: int = 1
    num_env_samples: int = 5
    compute_dtype: torch.dtype = torch.bfloat16
    eval_coarse_samples: int = 0
    eval_fine_samples: int = 0
    eval_env_samples: int = 0
    # The secondary march's tight-scale re-read (env_tight_rgb > 0: the
    # covariance scale; its variants top1 / topk / weights and the
    # luma-ratio combine env_tight_chroma) and the env-distill re-march
    # of `env_distill_samples` Gaussians along one random env direction
    # per ray in training; the JAX package's BaseNeRF fields of the same
    # names, checked in __post_init__ as there.
    env_tight_rgb: float = 0.0
    env_tight_chroma: bool = False
    env_tight_chroma_eps: float = 0.01
    env_tight_top1: bool = False
    env_tight_topk: int = 0
    env_tight_weights: bool = False
    env_distill_samples: int = 0
    # Training: render the coarse level and the env queries through the
    # whole-level kernel 5 (`kernels/fused_render_train.py`), spilling its
    # trunk activations for the backward with `train_kernel_save_acts`.
    # `train_kernel_scope` ("all" | "coarse" | "env") picks the subgraphs;
    # as in the JAX package it is a field, not a config key.
    use_train_render_kernel: bool = False
    train_kernel_save_acts: bool = False
    train_kernel_scope: str = "all"

    def __post_init__(self):
        if self.env_tight_chroma and self.env_tight_rgb <= 0:
            raise ValueError(
                "env_tight_chroma combines the blurred and tight-scale "
                "secondary reads, so it requires env_tight_rgb > 0.")
        if self.env_tight_top1 and not self.env_tight_chroma:
            raise ValueError(
                "env_tight_top1 reads only the dominant hit's chroma, so "
                "it requires env_tight_chroma.")
        if self.env_tight_topk > 0:
            if not self.env_tight_chroma:
                raise ValueError(
                    "env_tight_topk reads only the top-K hits' chroma, so "
                    "it requires env_tight_chroma.")
            if self.env_tight_top1:
                raise ValueError(
                    "env_tight_topk and env_tight_top1 are mutually "
                    "exclusive.")
        if self.env_tight_weights:
            if self.env_tight_rgb <= 0:
                raise ValueError(
                    "env_tight_weights composites the tight re-read, so "
                    "it requires env_tight_rgb > 0.")
            if (self.env_tight_chroma or self.env_tight_top1
                    or self.env_tight_topk > 0):
                raise ValueError(
                    "env_tight_weights needs the full-S tight re-read; "
                    "leave env_tight_chroma/top1/topk off.")

    @classmethod
    def from_hparams(cls, hparams: dict, **overrides) -> "NerfConfig":
        """Build from a flat dot-key config; raise on unsupported keys.
        `overrides` are fields the model class sets (its density-channel
        count)."""
        for key, unsupported in UNSUPPORTED.items():
            if key in hparams and unsupported(hparams[key]):
                raise NotImplementedError(
                    f"{key}={hparams[key]!r} is not supported by the "
                    "PyTorch/CUDA render path")
        return cls(
            num_samples=int(hparams["nerf.num_samples"]),
            num_coarse_samples=int(hparams.get("nerf.num_coarse_samples", 0)),
            num_levels=int(hparams["nerf.num_levels"]),
            resample_padding=float(hparams["nerf.resample_padding"]),
            disparity=bool(hparams["nerf.disparity"]),
            min_deg_point=int(hparams["nerf.min_deg_point"]),
            max_deg_point=int(hparams["nerf.max_deg_point"]),
            deg_view=int(hparams["nerf.deg_view"]),
            density_bias=float(hparams["nerf.density_bias"]),
            rgb_padding=float(hparams["nerf.rgb_padding"]),
            mlp_net_depth=int(hparams["nerf.mlp.net_depth"]),
            mlp_net_width=int(hparams["nerf.mlp.net_width"]),
            mlp_net_depth_condition=int(
                hparams["nerf.mlp.net_depth_condition"]),
            mlp_net_width_condition=int(
                hparams["nerf.mlp.net_width_condition"]),
            mlp_skip_index=int(hparams["nerf.mlp.skip_index"]),
            mlp_num_rgb_channels=int(hparams["nerf.mlp.num_rgb_channels"]),
            num_env_samples=int(hparams["nerf.num_env_samples"]),
            compute_dtype=_DTYPES[str(hparams.get("train.precision",
                                                  "bf16"))],
            eval_coarse_samples=int(hparams.get("val.coarse_samples", 0)),
            eval_fine_samples=int(hparams.get("val.fine_samples", 0)),
            eval_env_samples=int(hparams.get("val.env_samples", 0)),
            use_train_render_kernel=bool(
                hparams.get("nerf.use_train_render_kernel", False)),
            train_kernel_save_acts=bool(
                hparams.get("nerf.train_kernel_save_acts", False)),
            env_tight_rgb=float(hparams.get("nerf.env_tight_rgb", 0.0)),
            env_tight_chroma=bool(hparams.get("nerf.env_tight_chroma",
                                              False)),
            env_tight_chroma_eps=float(hparams.get(
                "nerf.env_tight_chroma_eps", 0.01)),
            env_tight_top1=bool(hparams.get("nerf.env_tight_top1", False)),
            env_tight_topk=int(hparams.get("nerf.env_tight_topk", 0)),
            env_tight_weights=bool(hparams.get("nerf.env_tight_weights",
                                               False)),
            env_distill_samples=int(hparams.get("nerf.env_distill_samples",
                                                0)),
            **overrides,
        )

    @property
    def xyz_dim(self) -> int:
        return (self.max_deg_point - self.min_deg_point) * 3 * 2

    @property
    def view_dim(self) -> int:
        return self.deg_view * 3 * 2 + 3

    def sample_level(self, rays: Rays, i_level: int,
                     t_samples: Optional[Tensor], weights: Optional[Tensor]
                     ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """Coarse: evenly spaced frustums; fine: blurpool resampling of the
        coarse weights. The val.* sample overrides apply (eval counts)."""
        if i_level == 0:
            n = (self.eval_coarse_samples or self.num_coarse_samples
                 or self.num_samples)
            return mip.sample_along_rays(
                rays.origins, rays.directions, rays.radii,
                min(n, self.num_samples), rays.near, rays.far,
                self.disparity)
        return mip.resample_along_rays(
            rays.origins, rays.directions, rays.radii, t_samples, weights,
            self.resample_padding,
            num_samples=self.eval_fine_samples or self.num_samples)

    def train_coarse_samples(self) -> int:
        """Coarse samples of a training step: the coarse-only cut, never
        more than the fine level's count."""
        return min(self.num_coarse_samples or self.num_samples,
                   self.num_samples)

    def env_samples(self) -> int:
        """Samples per secondary (irradiance) env ray at eval."""
        return self.eval_env_samples or self.num_env_samples


class NerfModel(nn.Module):
    """What both models share: the config, the NerfMLP it specifies (the
    density-channel count from the model class) and the activations of
    the raw outputs."""

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

    def _rgb(self, raw_rgb: Tensor) -> Tensor:
        pad = self.cfg.rgb_padding
        return softplus(raw_rgb) * (1.0 + 2.0 * pad) - pad

    def _density(self, raw_sigma: Tensor) -> Tensor:
        return softplus(raw_sigma + self.cfg.density_bias)

    def _venc(self, dirs: Tensor) -> Tensor:
        """The viewdir encoding [..., 1, 27] of directions [..., 3]."""
        return mip.pos_enc(dirs, 0, self.cfg.deg_view, True)[..., None, :]

    def _march(self, means: Tensor, covs: Tensor, v_enc: Tensor,
               t_samples: Tensor, dirs: Tensor, white_bkgd: bool,
               packed: Optional[Tuple[Tensor, Tensor]]
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """One march without normals through kernel 2 and plain
        compositing: (rgb, distance, acc, weights)."""
        cfg = self.cfg
        raw_rgb, raw_density = fused_mlp_ipe_apply(
            self.mlp, means, covs, v_enc, min_deg=cfg.min_deg_point,
            max_deg=cfg.max_deg_point, packed=packed)
        return mip.volumetric_rendering(
            self._rgb(raw_rgb), self._density(raw_density[..., :1]),
            t_samples, dirs, white_bkgd)


def expected_normals(weights: Tensor, normals: Tensor, directions: Tensor,
                     use_ort_loss: bool
                     ) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """Weight-average per-sample normals [B, N, 3]; optional orientation
    loss mean_B sum_N w_norm relu(n . d)^2. Returns (normal [B, 3],
    ort_loss, w_norm [B, N, 1]). `safe_normalize` keeps the backward
    finite at a sample whose density gradient is exactly zero."""
    w_norm = weights[..., None] / torch.sum(weights, dim=-1)[..., None, None]
    normals = mip.safe_normalize(normals)
    normal = mip.safe_normalize(torch.sum(w_norm * normals, dim=-2))
    ort_loss = None
    if use_ort_loss:
        dot = torch.sum(normals * directions[..., None, :], dim=-1,
                        keepdim=True)
        ort_loss = torch.mean(torch.sum(w_norm * torch.relu(dot) ** 2,
                                        dim=-2))
    return normal, ort_loss, w_norm
