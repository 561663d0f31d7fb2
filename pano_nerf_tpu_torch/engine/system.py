"""The training systems: model, the train step and the renderer.

Counterpart of pano_nerf_tpu/engine/system.py: `BaseSystem` (the device,
Adam on `mip_lr_decay` behind the global-norm clip, the state), the two
systems `PanoNeRFSystem` (env rays, the surface path) and `MipNeRFSystem`
(the LDR-supervised baseline) with their `make_train_step` (one optimizer
step on a ray batch), `make_train_step_device_data` (the batch drawn on
the device from the resident ray set, K steps per dispatch: `_jit_steps`)
and `make_render_image` (chunked by `BaseSystem._chunked`), and
`build_system`, keyed on `nerf.mlp_name`. Where JAX jits, the port
captures CUDA graphs on the card (`engine/graphs.py`): the K-step train
dispatch and the eval chunk; the eager step stays as the body that is
captured, and is what runs on the CPU. A model on the plain route
(`models/base.py` `plain_route_reasons`) is said so once, as
`[route] plain on <device>: <reasons>`, and gets no packed kernel
parameters; one on the kernel route with a width or encoding the
kernels on its device are not built for (`kernel_build_gaps`) is refused
with NotImplementedError. `train.randomized` and `val.randomized` are
JAX's: a step draws its random numbers only with the first, and under
the second every eval chunk is randomized by the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch

from pano_nerf_tpu_torch.core.device import resolve_device
from pano_nerf_tpu_torch.core.rays import Rays, rays_map, rays_to_tensors
from pano_nerf_tpu_torch.engine import losses as losses_lib
from pano_nerf_tpu_torch.engine.graphs import CapturedGraph
from pano_nerf_tpu_torch.engine.schedule import lr_table
from pano_nerf_tpu_torch.kernels.fused_render import pack_params
from pano_nerf_tpu_torch.models import build_model
from pano_nerf_tpu_torch.models.base import (kernel_build_gaps,
                                             plain_route_reasons)

Tensor = torch.Tensor

# Keys whose value needs a training path the port does not have.
TRAIN_UNSUPPORTED: Dict[str, Callable] = {
    "parallel.num_devices": lambda v: v is not None and int(v) > 1,
}


def check_train_config(hparams: Dict) -> None:
    """Raise NotImplementedError naming the first key that needs a
    training path the port lacks (model keys are checked by NerfConfig,
    loss keys by the system's `_check_losses`)."""
    for key, unsupported in TRAIN_UNSUPPORTED.items():
        if key in hparams and unsupported(hparams[key]):
            raise NotImplementedError(
                f"{key}={hparams[key]!r} is not supported by the "
                "PyTorch/CUDA train step")


_ROUTES_SAID = set()


def say_route(device: torch.device, reasons: Sequence[str]) -> None:
    """Print `[route] plain on <device>: <reasons>` the first time a
    model on the plain route is built for this device and these
    reasons."""
    line = f"[route] plain on {device.type}: {', '.join(reasons)}"
    if line not in _ROUTES_SAID:
        _ROUTES_SAID.add(line)
        print(line, flush=True)


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
    """The mutable training state: the step count, the optimizer (whose
    parameters are the model's) and, on the card, the step count as a
    device tensor (`step_t`, int64), which a CUDA graph reads and
    advances where it cannot read a Python int."""
    step: int
    optimizer: torch.optim.Optimizer
    step_t: Optional[torch.Tensor] = None


def rollback_point(state: TrainState, params: List[Tensor],
                   gen: torch.Generator) -> Callable[[], None]:
    """Returns restore(): puts the parameters, Adam's state, `step_t`,
    `state.step` and the generator back as they are now, in place (a CUDA
    graph keeps the tensors it captured). Adam state that did not exist
    yet is zeroed, which is where a fresh Adam starts."""
    saved = [p.detach().clone() for p in params]
    moments = {p: {k: v.clone() for k, v in state.optimizer.state[p].items()}
               for p in params if p in state.optimizer.state}
    step, gen_state = state.step, gen.get_state()
    step_t = None if state.step_t is None else state.step_t.clone()

    def restore() -> None:
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)
                for k, t in state.optimizer.state.get(p, {}).items():
                    if p in moments:
                        t.copy_(moments[p][k])
                    else:
                        t.zero_()
            if step_t is not None:
                state.step_t.copy_(step_t)
        state.step = step
        gen.set_state(gen_state)

    return restore


def _k_steps(one: Callable, k: int) -> Callable:
    """run(state) -> (loss parts of the last step, losses [k]): `k` calls
    of the step `one`."""
    def run(state: TrainState) -> Tuple[Dict[str, Tensor], Tensor]:
        losses = []
        for _ in range(k):
            parts = one(state)
            losses.append(parts["loss"])
        return parts, torch.stack(losses)

    return run


def render_products(enable_surf: bool, emission: bool = False
                    ) -> List[Tuple[str, int]]:
    """What `make_render_image` returns per ray, in its order: (name,
    channels); `emission` with the emissive head (JAX's eval tree puts it
    beside the surface products)."""
    products = [("rgb_coarse", 3), ("dep_coarse", 1), ("rgb_fine", 3),
                ("dep_fine", 1), ("normal", 3)]
    if enable_surf:
        products += [("albedo", 3), ("roughness", 1), ("surf_rgb", 3),
                     ("shading", 3)]
        if emission:
            products.append(("emission", 3))
    return products


class BaseSystem:
    """Holds a model on its device, its train step and its renderer.

    `device` defaults to the CUDA card; pass "cpu" for the plain PyTorch
    path. `init_seed` seeds the `torch.Generator` of the Xavier init. A
    subclass names its family (`mlp_name`), says whether it has the
    surface path (`surface`) and supplies the forward and loss of a train
    step, the draws of a step, the render of a chunk and its products.
    """

    mlp_name = ""
    surface = False   # env rays and the surface products (Pano-NeRF)

    def __init__(self, hparams: Dict,
                 device: Optional[Union[str, torch.device]] = None,
                 init_seed: int = 0):
        if hparams["nerf.mlp_name"] != self.mlp_name:
            raise ValueError(
                f"nerf.mlp_name={hparams['nerf.mlp_name']!r}: "
                f"{type(self).__name__} serves {self.mlp_name!r}; "
                "build_system picks the system")
        self.hparams = hparams = losses_lib.prepare_hparams(hparams)
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(init_seed))
        model = build_model(hparams, gen)
        if model.kernels:
            gaps = kernel_build_gaps(model.cfg, self.device)
            if gaps:
                raise NotImplementedError(
                    f"{', '.join(gaps)}: this topology takes the kernels "
                    f"(as in JAX), which on {self.device.type} are not "
                    "built for it")
        else:
            say_route(self.device, plain_route_reasons(model.cfg))
        self.model = model.to(self.device)
        self.model.eval()
        self.white_bkgd = bool(hparams["train.white_bkgd"])
        self.val_chunk_size = int(hparams["val.chunk_size"])
        # JAX's `randomized` of the train step and of the eval render
        # (pano_nerf_tpu/engine/system.py:63-64).
        self.train_randomized = bool(hparams.get("train.randomized", True))
        self.val_randomized = bool(hparams.get("val.randomized", False))

    # ---- the family's parts ----

    def _check_ready(self, enable_surf: bool) -> None:
        """Raise if a step or render with `enable_surf` lacks an input."""

    def _check_render(self) -> None:
        """Raise if the family's eval render cannot serve the config."""

    def _check_losses(self) -> None:
        """Raise on a loss key the family's loss cannot honour."""
        raise NotImplementedError

    def _train_forward(self, rays: Rays, draws: Any, enable_surf: bool,
                       packed: Optional[Tuple[Tensor, Tensor]]
                       ) -> Sequence:
        raise NotImplementedError

    def _losses(self, outs: Sequence, rgbs: Tensor, mask: Tensor,
                enable_surf: bool, step: Tensor
                ) -> Dict[str, Optional[Tensor]]:
        raise NotImplementedError

    def make_draws(self, batch: int, gen: torch.Generator,
                   eval_counts: bool = False) -> Any:
        """One step's random numbers (at `eval_counts` one randomized eval
        chunk's), drawn on `gen`'s device."""
        raise NotImplementedError

    def render_products(self, enable_surf: bool) -> List[Tuple[str, int]]:
        """What `make_render_image` returns per ray, in its order: (name,
        channels)."""
        raise NotImplementedError

    def render_chunk(self, rays: Rays, packed: Optional[Tuple[Tensor,
                                                              Tensor]],
                     enable_surf: bool = True, draws: Any = None) -> Tensor:
        """The eval forward of one chunk of rays, randomized by `draws`
        (`val.randomized`) or deterministic: [chunk, C], the products of
        `render_products(enable_surf)` side by side. The body the eval
        chunk graph captures."""
        raise NotImplementedError

    # ---- shared ----

    @property
    def graphed(self) -> bool:
        """Whether steps and chunks run as CUDA graphs (on the card)."""
        return self.device.type == "cuda"

    def packed(self) -> Optional[Tuple[Tensor, Tensor]]:
        """The kernels' packed parameters of the current weights, on the
        card's kernel route; else None (the plain versions and the plain
        route take the MLP's own parameters)."""
        if self.device.type == "cuda" and self.model.kernels:
            return pack_params(self.model.mlp)
        return None

    def params(self) -> List[Tensor]:
        """The trained parameters, in `NerfModel.named_params` order: the
        MLP's, then the illuminant field's."""
        return [p for _, p in self.model.named_params()]

    def create_state(self) -> TrainState:
        """Step 0 and a fresh Adam over the model's parameters (`params`).

        Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
        square root, no weight decay): torch.optim.Adam computes the same
        update, lr * m_hat / (sqrt(v_hat) + eps); checked against the JAX
        step in tests/test_torch_train_step.py. The learning rate is set
        from the schedule before each step. On the card Adam is
        `capturable` (its step counts and the learning rate are device
        tensors, so a CUDA graph can hold it) in graphed and eager steps
        alike; torch refuses `capturable` on the CPU, which keeps the
        plain form.
        """
        return TrainState(
            step=0, optimizer=torch.optim.Adam(
                self.params(), lr=0.0, betas=(0.9, 0.999),
                eps=1e-8, capturable=self.graphed),
            step_t=(torch.zeros((), dtype=torch.int64, device=self.device)
                    if self.graphed else None))

    def restore_state(self, state: TrainState, saved: Mapping) -> None:
        """Load a checkpoint's parameters, optimizer state and step into
        `state` (the optimizer's tensors are replaced: a graph that holds
        them must be captured again). An imported reference checkpoint
        (`import_reference_ckpt`) has no optimizer state: Adam starts
        fresh from it."""
        self.model.load_params(saved["params"])
        opt = saved.get("optimizer")   # saved on the card or on the CPU
        if opt is not None:
            state.optimizer.load_state_dict(dict(opt, param_groups=[
                dict(g, capturable=self.graphed)
                for g in opt["param_groups"]]))
        state.step = int(saved["step"])
        if state.step_t is not None:
            state.step_t.fill_(state.step)

    def eval_draws(self) -> Any:
        """The random numbers of every eval chunk under `val.randomized`,
        else None: JAX renders every chunk with `PRNGKey(0)`, the port
        draws one chunk's on the device from a generator seeded with 0."""
        if not self.val_randomized:
            return None
        return self.make_draws(self.val_chunk_size, torch.Generator(
            device=self.device).manual_seed(0), eval_counts=True)

    def make_train_step(self, enable_surf: bool) -> Callable:
        """Returns train_step(state, rays, rgbs, draws) -> loss parts.

        One optimizer step on a ray batch (flat [B, ...] tensors on the
        system's device), as the JAX `make_train_step`: the family's
        randomized forward (`_train_forward`, the kernels on the card) and
        loss (`_losses`), backward, `train.illum_freeze`'s mask on the
        illuminant field's gradients, the global-norm clip
        (`optimizer.grad_clip`, 0 = none), the learning rate of the step
        (read at `state.step_t` on the device where there is one), Adam.
        The parts are detached tensors; read them only when needed
        (reading waits for the device). No host read happens inside, so a
        CUDA graph can capture it.
        """
        check_train_config(self.hparams)
        self._check_losses()
        self._check_ready(enable_surf)
        hp, model = self.hparams, self.model
        clip = float(hp.get("optimizer.grad_clip", 0.0))
        lrs = torch.as_tensor(lr_table(
            float(hp["optimizer.lr_init"]), float(hp["optimizer.lr_final"]),
            int(hp["optimizer.max_steps"]),
            int(hp["optimizer.lr_delay_steps"]),
            float(hp["optimizer.lr_delay_mult"]))).to(self.device)
        last = lrs.shape[0] - 1
        params = self.params()
        illum = ([] if model.illum is None
                 else list(model.illum.parameters()))
        freeze = (float(hp.get("train.illum_freeze", 0.0))
                  * float(hp["optimizer.max_steps"]))

        def train_step(state: TrainState, rays: Rays, rgbs: Tensor,
                       draws: Any) -> Dict[str, Tensor]:
            packed = self.packed()
            state.optimizer.zero_grad(set_to_none=True)
            outs = self._train_forward(rays, draws, enable_surf, packed)
            # The step before this one's increment, as JAX reads
            # state.step; on the card the device counter, which a graph
            # reads at every replay (a Python int would be frozen into
            # it at capture).
            step_now = (torch.tensor(state.step) if state.step_t is None
                        else state.step_t)
            parts = self._losses(outs, rgbs[..., :3], rays.lossmult,
                                 enable_surf, step_now)
            parts["loss"].backward()
            for p in params:
                # A parameter the step did not reach (the illuminant
                # field without the surface path) gets JAX's zero
                # gradient, which Adam still steps.
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if freeze > 0 and illum:
                # train.illum_freeze (JAX `_freeze_illum_grads`): the
                # field's gradients x 0 from step freeze x max_steps on,
                # a mask computed on the device from the step.
                keep = (step_now.to(torch.float32) < freeze).to(
                    torch.float32)
                for p in illum:
                    p.grad.mul_(keep)
            if clip > 0:
                clip_by_global_norm_(params, clip)
            if state.step_t is None:
                lr = float(lrs[min(state.step, last)])
            else:
                lr = lrs.index_select(0, state.step_t.clamp(max=last)
                                      .view(1))[0]
                state.step_t += 1
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            state.step += 1
            return {k: v.detach() for k, v in parts.items()
                    if v is not None}

        return train_step

    def make_device_step(self, dataset: Tuple[Rays, Tensor],
                         gen: torch.Generator, enable_surf: bool,
                         batch_size: int) -> Callable:
        """Returns device_step(state) -> loss parts: one train step on a
        batch drawn on the device, the JAX `one_step` of
        `make_train_step_device_data`. `dataset` is the flattened training
        set on the device (Rays [N, ...], rgbs [N, C]); the batch is drawn
        uniformly with replacement, then (`train.randomized`) the step's
        random numbers, all from `gen`."""
        rays_all, rgbs_all = dataset
        n = rgbs_all.shape[0]
        step = self.make_train_step(enable_surf)

        def device_step(state: TrainState) -> Dict[str, Tensor]:
            idx = torch.randint(0, n, (batch_size,), generator=gen,
                                device=self.device)
            rays = rays_map(lambda x: x[idx], rays_all)
            draws = (self.make_draws(batch_size, gen)
                     if self.train_randomized else None)
            return step(state, rays, rgbs_all[idx], draws)

        return device_step

    def make_train_step_device_data(self, state: TrainState,
                                    dataset: Tuple[Rays, Tensor],
                                    gen: torch.Generator, enable_surf: bool,
                                    batch_size: int, steps_per_call: int = 1
                                    ) -> Callable:
        """Returns run(state) -> (loss parts, losses [K]): K =
        `steps_per_call` steps of `make_device_step` per call, the JAX
        `make_train_step_device_data`. The parts are the last step's (as
        JAX returns them); `losses` holds every step's loss. On the card
        the K steps are one CUDA graph (`make_graphed_train_step`), bound
        to `state`; on the CPU they run eagerly, one after the other."""
        if self.graphed:
            return self.make_graphed_train_step(state, dataset, gen,
                                                enable_surf, batch_size,
                                                steps_per_call)
        return _k_steps(self.make_device_step(dataset, gen, enable_surf,
                                              batch_size), steps_per_call)

    def make_graphed_train_step(self, state: TrainState,
                                dataset: Tuple[Rays, Tensor],
                                gen: torch.Generator, enable_surf: bool,
                                batch_size: int, steps: int) -> Callable:
        """The K-step dispatch as one CUDA graph, the counterpart of JAX's
        `_jit_steps` (`lax.scan` of `steps` steps; 1: the jitted step).

        The graph holds `steps` copies of the whole step: the batch draw
        and the step's random numbers on `gen` (registered with the
        graph), the gather from the resident ray set, `pack_params`, the
        forward, the loss, backward, the clip, the learning rate at
        `state.step_t` and Adam. It is captured at the first call (see
        `engine/graphs.py`: the warm-up steps are rolled back in place:
        parameters, Adam's state, `step_t`, `state.step` and the
        generator) and replayed at every call after; `state.step`
        advances by `steps`. Returns run(state) -> (loss parts of the last
        step, losses [steps]), static tensors overwritten by the next
        replay."""
        one = self.make_device_step(dataset, gen, enable_surf, batch_size)
        params = self.params()
        body = _k_steps(one, steps)
        graph = CapturedGraph(lambda: body(state), warmup=lambda: one(state),
                              snapshot=lambda: rollback_point(state, params,
                                                              gen),
                              generators=(gen,))

        def run(st: TrainState) -> Tuple[Dict[str, Tensor], Tensor]:
            if st is not state:
                raise ValueError("a graphed train step runs on the state "
                                 "it was made for")
            out = graph()
            state.step += steps
            return out

        run.graph = graph
        return run

    def make_render_image(self, enable_surf: bool = True,
                          draws: Any = None) -> Callable:
        """Returns render_fn(params, rays) -> dict of [N, C] host tensors.

        `params` is a `NerfModel.param_state` dict (loaded into the model
        first) or None to keep the current weights; `rays` are flat
        [N, ...] tensors on the system's device. Rays are rendered
        `val.chunk_size` at a time (the last chunk padded with the last
        ray) into one [N, C] buffer on the device, which comes to the host
        in one copy. On the
        card each chunk is a replay of one CUDA graph of `render_chunk`
        (captured at the first call): the chunk is copied into its static
        input rays, and the weights are packed into its static weight
        buffer once per call, so each call renders the current weights.

        With `val.randomized` every chunk is randomized by the same
        numbers: `draws` (one chunk's, `make_draws(chunk, gen,
        eval_counts=True)`), by default `eval_draws()`. They stay put in
        memory, so each replay of the chunk graph reads them, and two
        renders of the same weights agree.
        """
        self._check_ready(enable_surf)
        self._check_render()
        model, chunk = self.model, self.val_chunk_size
        names = self.render_products(enable_surf)
        if not self.val_randomized:
            draws = None
        elif draws is None:
            draws = self.eval_draws()
        graph: Optional[CapturedGraph] = None
        static_rays: Optional[Rays] = None
        static_packed: Optional[Tuple[Tensor, Tensor]] = None

        @torch.no_grad()
        def render_fn(params: Optional[Mapping[str, Tensor]], rays: Rays
                      ) -> Dict[str, Tensor]:
            nonlocal graph, static_rays, static_packed
            if params is not None:
                model.load_params(params)
            n = rays.origins.shape[0]
            pad = (-n) % chunk
            if pad:
                rays = rays_map(lambda x: torch.cat(
                    [x, x[-1:].expand(pad, x.shape[-1])], 0), rays)
            slab = torch.empty((n + pad, sum(w for _, w in names)),
                               device=self.device)
            packed = self.packed()
            if self.graphed and graph is None:
                static_rays = rays_map(lambda x: x[:chunk].clone(), rays)
                static_packed = (None if packed is None
                                 else tuple(t.clone() for t in packed))
                graph = CapturedGraph(lambda: self.render_chunk(
                    static_rays, static_packed, enable_surf, draws))
            if self.graphed and packed is not None:
                for dst, src in zip(static_packed, packed):
                    dst.copy_(src)
            for start in range(0, n + pad, chunk):
                chunk_rays = rays_map(lambda x: x[start:start + chunk],
                                      rays)
                if self.graphed:
                    for dst, src in zip(static_rays, chunk_rays):
                        dst.copy_(src)
                    out = graph()
                else:
                    out = self.render_chunk(rays_map(
                        lambda x: x.contiguous(), chunk_rays), packed,
                        enable_surf, draws)
                slab[start:start + chunk].copy_(out)
            host = slab[:n].cpu()
            parts, col = {}, 0
            for name, width in names:
                parts[name] = host[:, col:col + width]
                col += width
            return parts

        return render_fn


class PanoNeRFSystem(BaseSystem):
    """Pano-NeRF: the surface path's env rays (`set_env_rays`), the
    Pano-NeRF train forward (kernels 2 and 3 on the card, and kernel 5 for
    the coarse level and the env queries with
    `nerf.use_train_render_kernel`; the plain NerfMLP on the plain route)
    and `pano_losses`; the eval render through kernel 4 (with the tight
    re-read, kernels 2 and 3; on the plain route the plain NerfMLP), 5
    products or (`enable_surf`) 9, 10 with the emissive head."""

    mlp_name = "panonerf"
    surface = True

    def __init__(self, hparams: Dict,
                 device: Optional[Union[str, torch.device]] = None,
                 init_seed: int = 0):
        super().__init__(hparams, device, init_seed)
        self.env_rays: Optional[Rays] = None

    def set_env_rays(self, env_rays) -> None:
        """Env directions: a Rays of numpy arrays, [D, ...]."""
        self.env_rays = rays_to_tensors(env_rays, self.device)

    def _check_ready(self, enable_surf: bool) -> None:
        if self.env_rays is None and enable_surf:
            raise RuntimeError("call set_env_rays() first")

    def _check_render(self) -> None:
        if self.model.cfg.num_levels < 2:
            raise NotImplementedError(
                f"nerf.num_levels={self.model.cfg.num_levels}: the eval "
                "products read the fine level's normal and roughness, and "
                "at one level there is none (nor in JAX, whose render "
                "raises there: pano_nerf_tpu/engine/system.py:347-354)")

    def _check_losses(self) -> None:
        losses_lib.check_loss_config(self.hparams)

    def _train_forward(self, rays, draws, enable_surf, packed):
        hp = self.hparams
        return self.model.train_forward(
            rays, self.env_rays, draws, self.white_bkgd, enable_surf,
            hp["loss.ort_loss"] > 0,
            float(hp.get("loss.view_consistency", 0.0)) > 0, packed=packed)

    def _losses(self, outs, rgbs, mask, enable_surf, step):
        return losses_lib.pano_losses(outs, rgbs, mask, self.hparams,
                                      enable_surf, step=step)

    def make_draws(self, batch: int, gen: torch.Generator,
                   eval_counts: bool = False):
        return self.model.make_draws(
            batch, int(self.hparams["nerf.num_ray_samples"]), gen,
            scale_distill=(not eval_counts
                           and losses_lib.use_scale_distill(self.hparams)),
            eval_counts=eval_counts)

    def render_products(self, enable_surf: bool) -> List[Tuple[str, int]]:
        return render_products(enable_surf, self.model.cfg.emissive_head)

    def render_chunk(self, rays: Rays, packed: Optional[Tuple[Tensor,
                                                              Tensor]],
                     enable_surf: bool = True, draws: Any = None) -> Tensor:
        outs = self.model(rays, self.env_rays, self.white_bkgd, enable_surf,
                          packed=packed, draws=draws)
        c, f = outs[0], outs[-1]
        cols = [c.rgb, c.distance[:, None], f.rgb, f.distance[:, None],
                f.normal]
        if enable_surf:
            cols += [f.albedo, f.roughness[:, None], f.surf_rgb, f.shading]
            if f.emission is not None:
                cols.append(f.emission)
        return torch.cat([x.float() for x in cols], 1)


class MipNeRFSystem(BaseSystem):
    """The mip-NeRF baseline (JAX `MipNeRFSystem`): no env rays and no
    surface path (`enable_surf` is ignored, as JAX's trainer does for
    it); the train forward through kernel 2 on both levels (kernel 3 on
    the fine one with `loss.ort_loss` > 0) and `mipnerf_losses`; the eval
    render through kernel 2 (coarse) and kernel 3's forward (fine, with
    the normal), 5 products."""

    mlp_name = "mipnerf"

    def _check_losses(self) -> None:
        losses_lib.check_mipnerf_loss_config(self.hparams)

    def _train_forward(self, rays, draws, enable_surf, packed):
        return self.model.train_forward(
            rays, draws, self.white_bkgd,
            self.hparams["loss.ort_loss"] > 0, packed=packed)

    def _losses(self, outs, rgbs, mask, enable_surf, step):
        return losses_lib.mipnerf_losses(outs, rgbs, mask, self.hparams)

    def make_draws(self, batch: int, gen: torch.Generator,
                   eval_counts: bool = False):
        return self.model.make_draws(batch, gen, eval_counts=eval_counts)

    def render_products(self, enable_surf: bool) -> List[Tuple[str, int]]:
        return render_products(False)

    def render_chunk(self, rays: Rays, packed: Optional[Tuple[Tensor,
                                                              Tensor]],
                     enable_surf: bool = False, draws: Any = None) -> Tensor:
        outs = self.model(rays, self.white_bkgd, packed=packed, draws=draws)
        c, f = outs[0], outs[-1]
        return torch.cat([x.float() for x in (
            c.rgb, c.distance[:, None], f.rgb, f.distance[:, None],
            f.normal)], 1)


SYSTEMS = {cls.mlp_name: cls for cls in (PanoNeRFSystem, MipNeRFSystem)}


def build_system(hparams: Dict,
                 device: Optional[Union[str, torch.device]] = None,
                 init_seed: int = 0) -> BaseSystem:
    """The system of `nerf.mlp_name` (JAX's `build_system`)."""
    name = hparams["nerf.mlp_name"]
    if name not in SYSTEMS:
        raise ValueError(f"Unknown system {name!r}")
    return SYSTEMS[name](hparams, device, init_seed)
