"""The Pano-NeRF system: model, env rays, the train step and the renderer.

Counterpart of pano_nerf_tpu/engine/system.py: `PanoNeRFSystem.
make_train_step` (one optimizer step on a ray batch, Adam on
`mip_lr_decay` behind the global-norm clip) and `make_render_image`
(chunked by `BaseSystem._chunked`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Union

import torch

from pano_nerf_tpu_torch.core.device import resolve_device
from pano_nerf_tpu_torch.core.rays import Rays, rays_map, rays_to_tensors
from pano_nerf_tpu_torch.engine import losses as losses_lib
from pano_nerf_tpu_torch.engine.schedule import mip_lr_decay
from pano_nerf_tpu_torch.kernels.fused_render import pack_params
from pano_nerf_tpu_torch.models.pano_mip_nerf import PanoMipNeRF, TrainDraws

Tensor = torch.Tensor

# Keys whose value needs a training path the port does not have.
TRAIN_UNSUPPORTED: Dict[str, Callable] = {
    "train.randomized": lambda v: not bool(v),
    "nerf.point_normals": bool,
    "nerf.env_distill_samples": lambda v: int(v) > 0,
    "parallel.num_devices": lambda v: v is not None and int(v) > 1,
}


def check_train_config(hparams: Dict) -> None:
    """Raise NotImplementedError naming the first key that needs a
    training path the port lacks (model keys are checked by NerfConfig)."""
    for key, unsupported in TRAIN_UNSUPPORTED.items():
        if key in hparams and unsupported(hparams[key]):
            raise NotImplementedError(
                f"{key}={hparams[key]!r} is not supported by the "
                "PyTorch/CUDA train step")
    losses_lib.check_loss_config(hparams)


def clip_by_global_norm_(params: List[Tensor], max_norm: float) -> Tensor:
    """Scale the gradients in place by max_norm / max(norm, max_norm),
    the JAX package's `clip_by_global_norm`: exactly 1.0 under the bound
    (torch's clip_grad_norm_ adds 1e-6 to the norm and so changes every
    clipped step). Returns the global norm."""
    norm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in params))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for p in params:
        p.grad.mul_(scale)
    return norm


@dataclasses.dataclass
class TrainState:
    """The mutable training state: step count and optimizer (whose
    parameters are the model's)."""
    step: int
    optimizer: torch.optim.Optimizer


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
        self.hparams = hparams = losses_lib.prepare_hparams(hparams)
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(init_seed))
        self.model = PanoMipNeRF.from_hparams(hparams, gen).to(self.device)
        self.model.eval()
        self.white_bkgd = bool(hparams["train.white_bkgd"])
        self.val_chunk_size = int(hparams["val.chunk_size"])
        self.env_rays: Optional[Rays] = None

    def create_state(self) -> TrainState:
        """Step 0 and a fresh Adam over the MLP's parameters.

        Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
        square root, no weight decay): torch.optim.Adam computes the same
        update, lr * m_hat / (sqrt(v_hat) + eps); checked against the JAX
        step in tests/test_torch_train_step.py. The learning rate is set
        from the schedule before each step.
        """
        return TrainState(step=0, optimizer=torch.optim.Adam(
            self.model.mlp.parameters(), lr=0.0, betas=(0.9, 0.999),
            eps=1e-8))

    def make_train_step(self, enable_surf: bool) -> Callable:
        """Returns train_step(state, rays, rgbs, draws) -> loss parts.

        One optimizer step on a ray batch (flat [B, ...] tensors on the
        system's device), as the JAX `make_train_step`: randomized forward
        (kernels 2 and 3 on the card, and kernel 5 for the coarse level and
        the env queries with `nerf.use_train_render_kernel`),
        `pano_losses`, backward, the global-norm clip
        (`optimizer.grad_clip`, 0 = none), the learning rate of
        `state.step`, Adam. The parts are detached tensors; read them only
        when needed (reading waits for the device).
        """
        check_train_config(self.hparams)
        if self.env_rays is None and enable_surf:
            raise RuntimeError("call set_env_rays() first")
        hp, model = self.hparams, self.model
        use_ort = hp["loss.ort_loss"] > 0
        use_vc = float(hp.get("loss.view_consistency", 0.0)) > 0
        clip = float(hp.get("optimizer.grad_clip", 0.0))
        schedule = mip_lr_decay(
            float(hp["optimizer.lr_init"]), float(hp["optimizer.lr_final"]),
            int(hp["optimizer.max_steps"]),
            int(hp["optimizer.lr_delay_steps"]),
            float(hp["optimizer.lr_delay_mult"]))
        params = list(model.mlp.parameters())

        def train_step(state: TrainState, rays: Rays, rgbs: Tensor,
                       draws: TrainDraws) -> Dict[str, Tensor]:
            packed = (pack_params(model.mlp)
                      if self.device.type == "cuda" else None)
            state.optimizer.zero_grad(set_to_none=True)
            outs = model.train_forward(
                rays, self.env_rays, draws, self.white_bkgd, enable_surf,
                use_ort, use_vc, packed=packed)
            parts = losses_lib.pano_losses(outs, rgbs[..., :3],
                                           rays.lossmult, hp, enable_surf)
            parts["loss"].backward()
            if clip > 0:
                clip_by_global_norm_(params, clip)
            for group in state.optimizer.param_groups:
                group["lr"] = schedule(state.step)
            state.optimizer.step()
            state.step += 1
            return {k: v.detach() for k, v in parts.items()
                    if v is not None}

        return train_step

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
