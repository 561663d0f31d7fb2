"""The training loop: device-resident data, train steps, validation,
checkpoints, and recovery from non-finite steps.

Counterpart of pano_nerf_tpu/engine/trainer.py (`Trainer.fit`), for
either family (`build_system`; only Pano-NeRF has env rays and the
surface flag): the flattened training ray set is uploaded to the device
once and each step samples its batch there, uniformly with replacement,
from a `torch.Generator` seeded from `seed + 1` that also draws the
step's random numbers. Steps are dispatched as in JAX: `train.steps_per_call` (K) steps
per call where `group_ok` allows it (no log or validation boundary inside
the group, no change of the surface flag, no group past `max_steps`),
single steps at the edges and through the cooldown after a recovery; on
the card each dispatch is the replay of a CUDA graph (one per surface flag
and K, captured at first use and again after every restore), on the CPU K
eager steps. Scalars (the last step's of a dispatch, as in JAX) go to
stdout and `metrics.jsonl` (with `rays_per_sec`) every `log_every_n_step`;
validation renders through the eval path (on the card kernel 4 for
Pano-NeRF, kernels 2 and 3 for its HDR presets and mip-NeRF) with a
one-image sanity pass at step 0, every `val.check_every_n_epoch` x 1000
steps and at the end, each followed by a checkpoint. A non-finite loss is
triaged as in the JAX trainer: a false alarm when the parameters are
finite, else a rewind to the last checkpoint with a re-seeded stream
(`train.nan_recovery` times) and single steps for one log period, else an
abort that names the last good checkpoint. JAX's profiler window
(`profile_dir`) has no counterpart here.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pano_nerf_tpu_torch.core.rays import rays_to_tensors
from pano_nerf_tpu_torch.data.pano_dataset import PanoDataset
from pano_nerf_tpu_torch.engine import validation as val_lib
from pano_nerf_tpu_torch.engine.checkpoint import Checkpointer
from pano_nerf_tpu_torch.engine.system import TrainState, build_system


def _all_finite(tensors) -> bool:
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all())


def group_ok(step: int, spc: int, max_steps: int, log_every: int,
             val_every: int, surface_start_step: int,
             steps_with_surface: bool) -> bool:
    """True when the K = `spc` steps [step, step + K) may run as one
    dispatch: they cross no log or validation boundary, the surface flag
    is constant over them and they end by `max_steps` (JAX's `_group_ok`;
    its profiler edges have no counterpart here)."""
    if spc <= 1 or step + spc > max_steps:
        return False
    for cad in (log_every, val_every):
        if step // cad != (step + spc - 1) // cad:
            return False
    return not (steps_with_surface
                and step < surface_start_step <= step + spc - 1)


class Trainer:
    def __init__(self, hparams: Dict, device: Optional[str] = None,
                 init_seed: Optional[int] = None):
        self.hparams = hparams
        self.max_steps = int(hparams["optimizer.max_steps"])
        self.log_every = int(hparams.get("log_every_n_step", 100))
        self.val_every = max(1, int(
            float(hparams["val.check_every_n_epoch"]) * 1000))
        self.save_dir = hparams["save_dir"]
        self.surface_start_step = int(hparams.get("train.surface_start_step",
                                                  0))
        self.use_surface = bool(hparams.get("train.surface", True))
        seed = int(hparams["seed"])
        self.system = build_system(
            hparams, device=device,
            init_seed=seed if init_seed is None else init_seed)
        self.device = self.system.device
        # Only Pano-NeRF has the surface path and its env rays; the
        # baseline ignores `train.surface` (JAX's `steps_with_surface`).
        self.steps_with_surface = self.use_surface and self.system.surface

        data = dict(num=hparams["train.sample_num"], range=hparams["range"],
                    meta_file=hparams.get("meta_file", "transforms_all"),
                    reform_cam=bool(hparams.get("reform_cam", 0)))
        self.train_dataset = PanoDataset(
            hparams["data_path"], split="train",
            white_bkgd=hparams["train.white_bkgd"],
            factor=hparams["train.factor"], **data)
        self.val_dataset = PanoDataset(
            hparams["data_path"], split="val",
            white_bkgd=hparams["val.white_bkgd"],
            factor=hparams["val.factor"], **data)
        if self.system.surface:
            self.system.set_env_rays(self.train_dataset.generate_lit_rays(
                num=hparams["nerf.num_ray_samples"], near=0.0,
                far=float(hparams["range"][1])))
        self.ckpt = Checkpointer(
            os.path.join(self.save_dir, "checkpoints"),
            keep_every_n_steps=int(hparams.get(
                "checkpoint.keep_every_n_steps", 0) or 0))
        self.metrics_path = os.path.join(self.save_dir, "metrics.jsonl")
        self._render_fn = None
        if bool(hparams.get("log.tensorboard", False)):
            print("[log] tensorboard disabled: the port writes "
                  "metrics.jsonl only")

    def _log(self, record: Dict) -> None:
        with open(self.metrics_path, "a") as fp:
            fp.write(json.dumps(record) + "\n")

    def validate(self, step: int, max_images: Optional[int] = None,
                 tag: str = "val") -> Dict[str, float]:
        """Render every val panorama (or the first `max_images`), save the
        products under `<tag>_<step>/`, log and return the mean metrics."""
        if self._render_fn is None:
            self._render_fn = self.system.make_render_image(
                enable_surf=self.system.surface)
        near, far = self.hparams["range"]
        save_dir = os.path.join(self.save_dir, f"{tag}_{step:06d}")
        n = len(self.val_dataset)
        if max_images is not None:
            n = min(n, max_images)
        agg: Dict[str, list] = {}
        for i in range(n):
            rays, gt_rgb, gt_depth, gt_normal, gt_albedo = self.val_dataset[i]
            products = val_lib.render_full_pano(
                self._render_fn, None, rays, self.val_dataset.h,
                self.val_dataset.w, self.device)
            m = val_lib.validation_metrics(products, gt_rgb, gt_depth,
                                           gt_normal, gt_albedo, near, far)
            val_lib.save_validation_products(products, gt_rgb, gt_depth,
                                             gt_normal, save_dir, i, near,
                                             far)
            for k, v in m.items():
                agg.setdefault(k, []).append(v)
        means = {k: float(np.mean(v)) for k, v in agg.items()}
        means.update(step=step, kind=tag)
        self._log(means)
        keys = ("psnr_hdr_vol", "psnr_ldr_vol", "ssim_ldr_vol")
        shown = ", ".join(f"{k}={means[k]:.3f}" for k in keys if k in means)
        print(f"[{tag} @ {step}] {shown}", flush=True)
        return means

    def _save(self, state: TrainState, gen: torch.Generator) -> None:
        self.ckpt.save(state.step, dict(
            params=self.system.model.param_state(),
            optimizer=state.optimizer.state_dict(),
            generator=gen.get_state()))

    def _restore(self, state: TrainState, gen: torch.Generator,
                 ckpt: Checkpointer) -> None:
        saved = ckpt.restore(map_location=self.device)
        self.system.restore_state(state, saved)
        if "generator" in saved:   # an imported checkpoint has none
            gen.set_state(saved["generator"].cpu())

    def fit(self, resume_path: Optional[str] = None,
            sanity_val: bool = True) -> None:
        hp, system = self.hparams, self.system
        state = system.create_state()
        seed = int(hp["seed"])
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        if resume_path:
            self._restore(state, gen, Checkpointer(resume_path))
            print(f"[resume] restored step {state.step} from {resume_path}")
        elif self.ckpt.latest_step() is not None:
            self._restore(state, gen, self.ckpt)
            print(f"[resume] restored step {state.step}")
        start_step = state.step

        ds = self.train_dataset
        batch = int(hp["train.batch_size"])
        spc = max(1, int(hp.get("train.steps_per_call", 8)))
        steps_fns: Dict[Tuple[bool, int], Callable] = {}
        dataset = None

        def build_device_fns():
            """(Re)upload the ray set and drop the step functions, which
            are made (on the card: captured) again at first use over the
            fresh buffers and the restored state: JAX's
            `build_device_fns`."""
            nonlocal dataset
            steps_fns.clear()
            dataset = (rays_to_tensors(ds.rays, self.device),
                       torch.as_tensor(ds.images, dtype=torch.float32).to(
                           self.device))

        def run_steps(surf: bool, k: int):
            if (surf, k) not in steps_fns:
                steps_fns[surf, k] = system.make_train_step_device_data(
                    state, dataset, gen, surf, batch, k)
            return steps_fns[surf, k](state)

        build_device_fns()
        print(f"[data] device-resident ({ds.num_rays:,} rays on "
              f"{self.device}" + (f", {spc} steps/dispatch" if spc > 1
                                  else "") + ")", flush=True)

        if sanity_val and start_step == 0:
            self.validate(step=0, max_images=1)

        nan_retries_left = int(hp.get("train.nan_recovery", 2))
        nan_retry, nan_failed_step, nan_cooldown_until = 0, -1, -1
        t0 = self._sync_clock()
        rays_done = 0
        params = system.params()
        while state.step < self.max_steps:
            surf = (self.steps_with_surface
                    and state.step >= self.surface_start_step)
            k = (spc if state.step >= nan_cooldown_until and group_ok(
                state.step, spc, self.max_steps, self.log_every,
                self.val_every, self.surface_start_step,
                self.steps_with_surface)
                 else 1)
            parts, _ = run_steps(surf, k)
            rays_done += batch * k

            if state.step % self.log_every == 0:
                scalars = {k: float(v) for k, v in parts.items()}
                dt = self._sync_clock() - t0
                if not np.isfinite(scalars["loss"]):
                    if _all_finite(params):
                        self._log({"step": state.step,
                                   "kind": "nan_false_alarm", **scalars})
                        print(f"[recover] non-finite loss READING at step "
                              f"{state.step} but params are finite — false "
                              f"alarm, continuing")
                    else:
                        if (nan_failed_step >= 0 and state.step
                                >= nan_failed_step + 2 * self.val_every):
                            nan_retry = 0   # real progress past the failure
                        restored = (self.ckpt.latest_step()
                                    if nan_retry < nan_retries_left else None)
                        if restored is None:
                            self._log({"step": state.step, "kind": "abort",
                                       "reason": "non-finite loss",
                                       **scalars})
                            raise FloatingPointError(
                                f"non-finite loss at step {state.step}: "
                                f"{scalars} — last good checkpoint: "
                                f"{self.ckpt.latest_step()} in "
                                f"{self.ckpt.directory}")
                        nan_retry += 1
                        nan_failed_step = state.step
                        # Single steps through one log period (JAX: a
                        # different executable mix is part of the cure).
                        nan_cooldown_until = state.step + self.log_every
                        data_finite = _all_finite([dataset[1], *dataset[0]])
                        self._log({"step": state.step, "kind": "nan_recovery",
                                   "retry": nan_retry,
                                   "restored_step": restored,
                                   "device_data_finite": data_finite,
                                   **scalars})
                        failed_at = state.step
                        build_device_fns()
                        self._restore(state, gen, self.ckpt)
                        # A re-rolled batch stream from the restored state.
                        gen.manual_seed(seed + 1 + 7919 * nan_retry)
                        print(f"[recover] non-finite loss at step "
                              f"{failed_at}; restored step {state.step} "
                              f"(retry {nan_retry}/{nan_retries_left}, "
                              f"re-rolled batch stream, single-step "
                              f"cooldown to {nan_cooldown_until}, device "
                              f"data finite: {data_finite})")
                        t0, rays_done = self._sync_clock(), 0
                        continue
                else:
                    rps = rays_done / dt
                    self._log({"step": state.step, "kind": "train",
                               "rays_per_sec": rps, **scalars})
                    print(f"[{state.step}/{self.max_steps}] "
                          f"loss={scalars['loss']:.5f} rays/s={rps:,.0f}",
                          flush=True)
                t0, rays_done = self._sync_clock(), 0

            if state.step % self.val_every == 0 or state.step == self.max_steps:
                self._save(state, gen)
                self.validate(step=state.step)
                t0, rays_done = self._sync_clock(), 0

        self._save(state, gen)
        print("[done] training complete", flush=True)

    def _sync_clock(self) -> float:
        """Host clock after the device has finished its queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()
