"""Hyperparameters, level outputs and sampling of the two model families.

Counterpart of pano_nerf_tpu/models/base.py: `from_hparams` (with the
`__post_init__` checks of the tight re-read's variants), `_sample_level`,
`_env_samples`, `_env_mode`, `_density_noise`, the illuminant field's
parameters (`models/illum.py`), `_rgb_from_raw` with the chroma head,
`_expected_normals` and `_kernel_topology_ok`, shared by Pano-NeRF
(`models/pano_mip_nerf.py`) and the mip-NeRF baseline
(`models/mip_nerf.py`).

Two routes, as in JAX, decided from the config alone when the model is
built (`plain_route_reasons`, the same on every device): where JAX's
`_kernel_topology_ok` sends the model to its kernels (the 8-deep trunk
with its skip at 4, one view layer, view directions, bf16, no emissive
or chroma head) every MLP query goes through the kernels' wrappers (on
the CPU their plain versions); otherwise every query goes through the
general NerfMLP with torch autograd (`NerfModel._query`,
`_query_normals`: JAX's XLA route). JAX's kernels read the widths and
encodings from the parameter shapes; the CUDA kernels are built per shape
for a set of them (`kernels/shapes.py`: trunk 128, 256 or 512, view
branch 64, 128 or 256, IPE degrees 1..16, deg_view 1..4; a narrower trunk
or view branch runs zero-padded in the next build), so on the kernel
route a system on the card refuses what they are not built for
(`kernel_build_gaps`: trunks above 512, view branches above 256, more
IPE or viewdir degrees) instead of taking another route. A kernel that
fails raises; the route never changes at run time. `from_hparams`
refuses every config key that would need a path the port lacks
(`UNSUPPORTED`) with
NotImplementedError naming the key, instead of silently computing
something else.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Tuple)

import torch
from torch import nn

from pano_nerf_tpu_torch.core.rays import Rays
from pano_nerf_tpu_torch.kernels import shapes
from pano_nerf_tpu_torch.kernels.fused_mlp_ipe import fused_mlp_ipe_apply
from pano_nerf_tpu_torch.kernels.fused_mlp_normals import (
    fused_mlp_normals_apply)
from pano_nerf_tpu_torch.kernels.fused_render import softplus
from pano_nerf_tpu_torch.models import normals as normals_lib
from pano_nerf_tpu_torch.models.illum import IllumField
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
    # With the illuminant field (training): the secondary read [B, D, 3]
    # before the field's re-tint and the field's chroma at the same
    # (point, direction) pairs, for loss.illum_distill.
    env_pre_illum: Optional[Tensor] = None
    illum_chroma: Optional[Tensor] = None
    # With the emissive head: the composited self-emission [B, 3].
    emission: Optional[Tensor] = None
    # With loss.scale_distill(_dist) (training): the primary ray re-marched
    # at num_env_samples Gaussians, radiance [B, 3] and distance [B].
    rgb_scale: Optional[Tensor] = None
    dist_scale: Optional[Tensor] = None


# The env-direction estimators of a training step (`nerf.env_sampling`;
# "auto" resolves from `env_importance` / `env_rotation`, `env_mode`).
ENV_MODES = ("fixed", "rotated", "stratified", "importance")

# `nerf.ray_shape` is accepted and not read: JAX casts every ray as a cone
# whatever it says (pano_nerf_tpu/ops/mip.py:85-102 `cast_rays`).
# Config keys whose non-default value needs a render path the port does
# not have: key -> (predicate that is True when the value is unsupported,
# what the refusal adds where JAX reads the key but cannot run it either).
UNSUPPORTED: Dict[str, Tuple[Callable, str]] = {
    "nerf.env_sampling": (lambda v: v not in ENV_MODES + ("auto",), ""),
    "nerf.mlp.num_rgb_channels": (
        lambda v: int(v) != 3,
        "; JAX cannot train or serve it either: the surface render "
        "multiplies the radiance with 3-channel albedo and irradiance "
        "(pano_nerf_tpu/ops/shading.py:127) and the losses meet 3-channel "
        "targets (pano_nerf_tpu/engine/losses.py:71)"),
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
    # Whether the resampled fenceposts carry no gradient back into the
    # previous level's weights (JAX's `stop_resample_grad`).
    stop_resample_grad: bool = True
    # Zero covariances before every MLP query: the point encoding of NeRF
    # instead of the integrated one (JAX's `disable_integration`).
    disable_integration: bool = False
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
    use_viewdirs: bool = True
    append_identity: bool = True
    # Set by the model class, never by the config (as in JAX, whose
    # `from_hparams` does not read `nerf.mlp.num_density_channels`):
    # mip-NeRF keeps this default of 1, Pano-NeRF forces 5 (+ 3 for each
    # head).
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
    # The study switches of training (JAX BaseNeRF fields of the same
    # names). The env-direction estimator (`env_mode`): the fixed set,
    # rotated per ray, rotated and jittered in its cells (stratified), or
    # importance-sampled after a probe march of `env_probe_dirs` cells x
    # `env_probe_samples` samples; eval keeps the fixed set.
    env_rotation: bool = False
    env_importance: bool = False
    env_probe_dirs: int = 16
    env_probe_samples: int = 4
    env_sampling: str = "auto"
    # A second env march of `num_env_fine_samples` Gaussians placed by the
    # first one's weights (blurpool CDF), which then carries the radiance.
    env_resample: bool = False
    num_env_fine_samples: int = 5
    # Gaussian noise x density_noise on the raw density of the coarse and
    # fine levels in training.
    density_noise: float = 0.0
    # Training normals from one density-gradient query per ray at the
    # expected Gaussian instead of the per-sample average.
    point_normals: bool = False
    # The illuminant field (`models/illum.py`) re-tinting the env read.
    illum_field: bool = False
    illum_sh_deg: int = 2
    illum_net_width: int = 64
    illum_posenc_deg: int = 4
    # Pano-NeRF's heads on the density head: a view-independent
    # self-emission softplus(raw + emission_bias) added to the radiance of
    # every query, and a view-independent chroma simplex (softmax) that
    # multiplies 3 softplus(mean raw_rgb).
    emissive_head: bool = False
    emission_bias: float = -3.0
    chroma_head: bool = False

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
            if self.env_resample:
                raise ValueError(
                    "env_tight_weights and env_resample are alternative "
                    "second-scale marches; pick one.")

    @classmethod
    def from_hparams(cls, hparams: dict, **overrides) -> "NerfConfig":
        """Build from a flat dot-key config; raise on unsupported keys.
        `overrides` are fields the model class sets (its density-channel
        count)."""
        for key, (unsupported, why) in UNSUPPORTED.items():
            if key in hparams and unsupported(hparams[key]):
                raise NotImplementedError(
                    f"{key}={hparams[key]!r} is not supported by the "
                    "PyTorch/CUDA render path" + why)
        return cls(
            num_samples=int(hparams["nerf.num_samples"]),
            num_coarse_samples=int(hparams.get("nerf.num_coarse_samples", 0)),
            num_levels=int(hparams["nerf.num_levels"]),
            resample_padding=float(hparams["nerf.resample_padding"]),
            stop_resample_grad=bool(hparams.get("nerf.stop_resample_grad",
                                                True)),
            disable_integration=bool(hparams.get("nerf.disable_integration",
                                                 False)),
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
            use_viewdirs=bool(hparams["nerf.use_viewdirs"]),
            # 'Ture' (the reference config's typo) is truthy, as in JAX.
            append_identity=bool(hparams["nerf.append_identity"]),
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
            env_rotation=bool(hparams.get("nerf.env_rotation", False)),
            env_importance=bool(hparams.get("nerf.env_importance", False)),
            env_probe_dirs=int(hparams.get("nerf.env_probe_dirs", 16)),
            env_probe_samples=int(hparams.get("nerf.env_probe_samples", 4)),
            env_sampling=str(hparams.get("nerf.env_sampling", "auto")),
            env_resample=bool(hparams.get("nerf.env_resample", False)),
            num_env_fine_samples=int(hparams.get(
                "nerf.num_env_fine_samples", 5)),
            density_noise=float(hparams.get("nerf.density_noise", 0.0)),
            point_normals=bool(hparams.get("nerf.point_normals", False)),
            illum_field=bool(hparams.get("nerf.illum_field", False)),
            illum_sh_deg=int(hparams.get("nerf.illum_sh_deg", 2)),
            illum_net_width=int(hparams.get("nerf.illum_net_width", 64)),
            illum_posenc_deg=int(hparams.get("nerf.illum_posenc_deg", 4)),
            emissive_head=bool(hparams.get("nerf.emissive_head", False)),
            emission_bias=float(hparams.get("nerf.emission_bias", -3.0)),
            chroma_head=bool(hparams.get("nerf.chroma_head", False)),
            **overrides,
        )

    @property
    def xyz_dim(self) -> int:
        return (self.max_deg_point - self.min_deg_point) * 3 * 2

    @property
    def view_dim(self) -> int:
        return self.deg_view * 3 * 2 + (3 if self.append_identity else 0)

    def sample_level(self, rays: Rays, i_level: int,
                     t_samples: Optional[Tensor], weights: Optional[Tensor],
                     eval_counts: bool = True, u: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """Level 0: frustums over [near, far], evenly spaced or stratified
        by the uniforms `u`; a later level: blurpool resampling of the
        previous level's weights, evenly or at the uniforms `u`, with the
        resampling's gradient as `stop_resample_grad` says (JAX
        `_sample_level`). `eval_counts` applies the val.* sample
        overrides."""
        if i_level == 0:
            return mip.sample_along_rays(
                rays.origins, rays.directions, rays.radii,
                self.coarse_samples(eval_counts), rays.near, rays.far,
                self.disparity, t_rand=u)
        return mip.resample_along_rays(
            rays.origins, rays.directions, rays.radii, t_samples, weights,
            self.resample_padding, num_samples=self.fine_samples(eval_counts),
            u_rand=u, stop_grad=self.stop_resample_grad)

    def coarse_samples(self, eval_counts: bool) -> int:
        """Samples of level 0: the coarse-only cut (at eval the
        val.coarse_samples one), never more than the fine level's count."""
        n = (self.eval_coarse_samples if eval_counts
             and self.eval_coarse_samples else self.num_coarse_samples
             or self.num_samples)
        return min(n, self.num_samples)

    def fine_samples(self, eval_counts: bool) -> int:
        """Samples of every resampled level (at eval val.fine_samples)."""
        return (self.eval_fine_samples if eval_counts
                and self.eval_fine_samples else self.num_samples)

    def fine_level(self, i_level: int) -> bool:
        """Whether level `i_level` is Pano-NeRF's fine level, the one with
        normals and the surface path: the last of two or more (JAX
        `pano_mip_nerf.py:197, 318-319`; at one level there is none)."""
        return i_level == self.num_levels - 1 and self.num_levels >= 2

    def env_samples(self) -> int:
        """Samples per secondary (irradiance) env ray at eval."""
        return self.eval_env_samples or self.num_env_samples

    def env_mode(self) -> str:
        """The training env-direction estimator: `env_sampling`, or with
        "auto" importance > rotated > fixed from the booleans."""
        if self.env_sampling != "auto":
            return self.env_sampling
        if self.env_importance:
            return "importance"
        return "rotated" if self.env_rotation else "fixed"


def plain_route_reasons(cfg: NerfConfig) -> List[str]:
    """Why the model takes the plain route, or [] when it takes the
    kernels: the port's `_kernel_topology_ok`, JAX's conditions
    (pano_nerf_tpu/models/base.py:609-626), on every device."""
    checks = (
        (cfg.use_viewdirs, "nerf.use_viewdirs false"),
        (cfg.mlp_net_depth == 8, f"nerf.mlp.net_depth {cfg.mlp_net_depth}"),
        (cfg.mlp_skip_index == 4,
         f"nerf.mlp.skip_index {cfg.mlp_skip_index}"),
        (cfg.mlp_net_depth_condition == 1,
         f"nerf.mlp.net_depth_condition {cfg.mlp_net_depth_condition}"),
        (cfg.compute_dtype == torch.bfloat16, "train.precision f32"),
        (not cfg.emissive_head, "nerf.emissive_head"),
        (not cfg.chroma_head, "nerf.chroma_head"))
    return [why for ok, why in checks if not ok]


def kernel_build_gaps(cfg: NerfConfig, device: torch.device) -> List[str]:
    """What a model on the kernel route needs that the kernels on
    `device` are not built for, or [] (`kernels/shapes.py`): on every
    device at least one IPE degree (max_deg_point - min_deg_point) and
    one viewdir degree; on the card also IPE degrees 1..16 and deg_view
    1..4 (the builds' XF and VP columns), a trunk width of at most 512 and
    a view-branch width of at most 256 (a narrower one runs zero-padded
    in the next build, `shapes.build_shape`) and the density-channel
    counts 1 and 5. The plain versions on the CPU take any width, count
    and degree, as JAX's kernels do."""
    L = cfg.max_deg_point - cfg.min_deg_point
    cuda = device.type == "cuda"
    checks = (
        (1 <= L <= (shapes.MAX_DEGREES if cuda else L),
         f"nerf.min_deg_point..max_deg_point {cfg.min_deg_point}.."
         f"{cfg.max_deg_point}"),
        (1 <= cfg.deg_view <= (shapes.MAX_DEG_VIEW if cuda else cfg.deg_view),
         f"nerf.deg_view {cfg.deg_view}"))
    if cuda:
        checks += (
            (1 <= cfg.mlp_net_width <= shapes.WIDTHS[-1],
             f"nerf.mlp.net_width {cfg.mlp_net_width}"),
            (1 <= cfg.mlp_net_width_condition <= shapes.VIEW_WIDTHS[-1],
             f"nerf.mlp.net_width_condition {cfg.mlp_net_width_condition}"),
            (cfg.mlp_num_density_channels in shapes.DENSITY_CHANNELS,
             f"{cfg.mlp_num_density_channels} density channels"))
    return [why for ok, why in checks if not ok]


class NerfModel(nn.Module):
    """What both models share: the config, the NerfMLP it specifies (the
    density-channel count from the model class), the route of its MLP
    queries (`kernels`: the kernels' wrappers, else the plain NerfMLP)
    and the activations of the raw outputs."""

    def __init__(self, cfg: NerfConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.kernels = not plain_route_reasons(cfg)
        self.mlp = NerfMLP(
            xyz_dim=cfg.xyz_dim, view_dim=cfg.view_dim,
            net_depth=cfg.mlp_net_depth, net_width=cfg.mlp_net_width,
            net_depth_condition=cfg.mlp_net_depth_condition,
            net_width_condition=cfg.mlp_net_width_condition,
            skip_index=cfg.mlp_skip_index,
            num_rgb_channels=cfg.mlp_num_rgb_channels,
            num_density_channels=cfg.mlp_num_density_channels,
            compute_dtype=cfg.compute_dtype, generator=generator,
            use_viewdirs=cfg.use_viewdirs)
        self.illum = (IllumField(cfg.illum_sh_deg, cfg.illum_net_width,
                                 cfg.illum_posenc_deg, generator)
                      if cfg.illum_field else None)

    def named_params(self) -> List[Tuple[str, nn.Parameter]]:
        """Every trained parameter under its `utils/params.py` name: the
        MLP's state_dict keys, then the illuminant field's leaves as
        `illum.<leaf>`. The optimizer, the clip and checkpoints take them
        in this order."""
        out = list(self.mlp.named_parameters())
        if self.illum is not None:
            out += [(f"illum.{n}", p)
                    for n, p in self.illum.named_parameters()]
        return out

    def param_state(self) -> Dict[str, Tensor]:
        """The parameters by `named_params` name (what a checkpoint's
        "params" holds)."""
        return {n: p.detach() for n, p in self.named_params()}

    def load_params(self, params: Mapping[str, Tensor]) -> None:
        """Load a `param_state` (or `utils/params.params_from_jax`) dict;
        raises on a missing or unexpected key, an `illum.*` key included
        when the field is off."""
        mlp = {k: v for k, v in params.items()
               if not k.startswith("illum.")}
        illum = {k[len("illum."):]: v for k, v in params.items()
                 if k.startswith("illum.")}
        self.mlp.load_state_dict(mlp)
        if self.illum is not None:
            self.illum.load_state_dict(illum)
        elif illum:
            raise ValueError("the parameters hold an illuminant field, "
                             "but nerf.illum_field is off")

    def _covs(self, covs: Tensor) -> Tensor:
        """The covariances an MLP query reads: zeros under
        `disable_integration` (JAX `_raw_outputs`, :652), on every route
        and query."""
        if self.cfg.disable_integration:
            return torch.zeros_like(covs)
        return covs

    def _query(self, means: Tensor, covs: Tensor, v_enc: Tensor,
               packed: Optional[Tuple[Tensor, Tensor]]
               ) -> Tuple[Tensor, Tensor]:
        """(raw_rgb, raw_density) at Gaussians [..., 3]: kernel 2, or on
        the plain route IPE -> NerfMLP (JAX `_raw_outputs`)."""
        cfg = self.cfg
        covs = self._covs(covs)
        if self.kernels:
            return fused_mlp_ipe_apply(
                self.mlp, means, covs, v_enc, min_deg=cfg.min_deg_point,
                max_deg=cfg.max_deg_point, packed=packed)
        return self.mlp(mip.integrated_pos_enc(
            means, covs, cfg.min_deg_point, cfg.max_deg_point), v_enc)

    def _query_normals(self, means: Tensor, covs: Tensor, v_enc: Tensor,
                       packed: Optional[Tuple[Tensor, Tensor]]
                       ) -> Tuple[Tensor, Tensor, Tensor]:
        """(raw_rgb, raw_density, d raw_sigma / d means): kernel 3, or on
        the plain route the explicit chain of `models/normals.py` (JAX
        `_raw_outputs_density_grad`)."""
        cfg = self.cfg
        covs = self._covs(covs)
        if self.kernels:
            return fused_mlp_normals_apply(
                self.mlp, means, covs, v_enc, min_deg=cfg.min_deg_point,
                max_deg=cfg.max_deg_point, packed=packed)
        x = mip.integrated_pos_enc(means, covs, cfg.min_deg_point,
                                   cfg.max_deg_point)
        raw_rgb, raw_density, g_enc = normals_lib.mlp_with_density_grad(
            self.mlp, x, v_enc)
        return raw_rgb, raw_density, normals_lib.density_means_grad(
            g_enc, x, cfg.min_deg_point, cfg.max_deg_point)

    def _rgb(self, raw_rgb: Tensor, chroma: Optional[Tensor] = None
             ) -> Tensor:
        """The radiance activation with the rgb_padding affine (JAX
        `_rgb_from_raw`): softplus per channel, or with a chroma simplex
        3 softplus(mean raw_rgb) chroma."""
        pad = self.cfg.rgb_padding
        if chroma is None:
            rgb = softplus(raw_rgb)
        else:
            rgb = 3.0 * softplus(torch.mean(raw_rgb, dim=-1,
                                            keepdim=True)) * chroma
        return rgb * (1.0 + 2.0 * pad) - pad

    def _emission(self, raw_density: Tensor) -> Optional[Tensor]:
        """The self-emission [..., 3] of the emissive head (JAX
        `_split_emission`), or None."""
        if not self.cfg.emissive_head:
            return None
        return softplus(raw_density[..., 5:8] + self.cfg.emission_bias)

    def _chroma(self, raw_density: Tensor) -> Optional[Tensor]:
        """The chroma simplex [..., 3] of the chroma head, after the
        emission channels (JAX `_split_chroma`), or None."""
        if not self.cfg.chroma_head:
            return None
        off = 8 if self.cfg.emissive_head else 5
        return torch.softmax(raw_density[..., off:off + 3], dim=-1)

    def _radiance(self, raw_rgb: Tensor, raw_density: Tensor) -> Tensor:
        """A query's radiance: `_rgb` with the chroma head's simplex, plus
        the emissive head's emission (JAX `make_graph`)."""
        rgb = self._rgb(raw_rgb, self._chroma(raw_density))
        emission = self._emission(raw_density)
        return rgb if emission is None else rgb + emission

    def _density(self, raw_sigma: Tensor) -> Tensor:
        return softplus(raw_sigma + self.cfg.density_bias)

    def _venc(self, dirs: Tensor) -> Tensor:
        """The viewdir encoding [..., 1, view_dim] of directions [..., 3]
        (27 wide at deg_view 4 with identity)."""
        return mip.pos_enc(dirs, 0, self.cfg.deg_view,
                           self.cfg.append_identity)[..., None, :]

    def _noisy(self, raw_sigma: Tensor, noise: Optional[Tensor]) -> Tensor:
        """raw_sigma + density_noise x the standard normals `noise` (JAX
        `_density_noise`); unchanged without them."""
        if noise is None:
            return raw_sigma
        return raw_sigma + self.cfg.density_noise * noise

    def _march(self, means: Tensor, covs: Tensor, v_enc: Tensor,
               t_samples: Tensor, dirs: Tensor, white_bkgd: bool,
               packed: Optional[Tuple[Tensor, Tensor]],
               noise: Optional[Tensor] = None
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """One march without normals (`_query`: kernel 2 or the plain
        NerfMLP) and plain compositing, the raw density noised by `noise`
        when given: (rgb, distance, acc, weights)."""
        raw_rgb, raw_density = self._query(means, covs, v_enc, packed)
        return mip.volumetric_rendering(
            self._radiance(raw_rgb, raw_density),
            self._density(self._noisy(raw_density[..., :1], noise)),
            t_samples, dirs, white_bkgd)


def level_uniforms(draws, i_level: int) -> Optional[Tensor]:
    """The uniforms that place level `i_level` in `draws` (a TrainDraws or
    MipDraws, or None: evenly): the stratification of level 0
    (`t_coarse`), the resampling jitter of level 1 (`u_fine`) or of a
    later one (`u_more[i_level - 2]`)."""
    if draws is None:
        return None
    if i_level < 2:
        return (draws.t_coarse, draws.u_fine)[i_level]
    return draws.u_more[i_level - 2]


def level_noise(draws, i_level: int) -> Optional[Tensor]:
    """The standard normals on level `i_level`'s raw density in `draws`,
    or None without density noise (`noise_coarse`, `noise_fine`,
    `noise_more[i_level - 2]`)."""
    if draws is None or draws.noise_coarse is None:
        return None
    if i_level < 2:
        return (draws.noise_coarse, draws.noise_fine)[i_level]
    return draws.noise_more[i_level - 2]


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
