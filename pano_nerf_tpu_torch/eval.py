"""Render and evaluate the validation panoramas of a scene on the H100.

Counterpart of scripts/eval.py (`Trainer.validate`): every val panorama is
rendered through the chunked renderer of the config's system
(`nerf.mlp_name`: Pano-NeRF through the CUDA fused render kernel,
its HDR presets and mip-NeRF through kernels 2 and 3), the
solid-angle-weighted metric family
is computed, and the image tree is written under
`<out_dir>/eval_<step>/` (11 products for Pano-NeRF, 12 with the
emissive head, 8 for mip-NeRF, which has no surface path). With f32
`train.precision` TF32 is off (`core/device.py` `set_precision`). Prints one JSON line of mean metrics, with
the render's time per panorama and rays/s.

Usage:
  python -m pano_nerf_tpu_torch.eval --data_path SCENE --out_dir OUT \
      (--ckpt_dir EXP [--step N] | --params params.npz | --init_seed N)
      [--config configs/panonerf.yaml] [--max_images N]
      [--device cuda|cpu] [opts k v ...]

`--ckpt_dir` is a run of `python -m pano_nerf_tpu_torch.train` (its
`<out_dir>/<exp_name>`): the weights of its checkpoint `--step` (default:
the latest) under `checkpoints/` are rendered, as scripts/eval.py restores
a JAX run. `--params` is a JAX-layout parameter tree flattened into an
`.npz` (utils/params.py shows the one-line export); `--init_seed` renders
freshly initialized weights from that seed instead. The products go to
`eval_<step>/`: the restored step, else `--step` (default 0).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from pano_nerf_tpu_torch.core.config import parse_args
from pano_nerf_tpu_torch.core.device import set_precision
from pano_nerf_tpu_torch.data.pano_dataset import PanoDataset
from pano_nerf_tpu_torch.engine import validation as val_lib
from pano_nerf_tpu_torch.engine.checkpoint import Checkpointer
from pano_nerf_tpu_torch.engine.system import build_system
from pano_nerf_tpu_torch.utils.params import load_npz, params_from_jax


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_path", required=True,
                        help="scene directory with transforms_all.json")
    parser.add_argument("--out_dir", required=True)
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--ckpt_dir",
                       help="a port training run (checkpoints/ inside)")
    group.add_argument("--params", help="JAX-layout parameter tree (.npz)")
    group.add_argument("--init_seed", type=int,
                       help="render freshly initialized weights")
    parser.add_argument("--config", default="./configs/panonerf.yaml")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step to restore (default: the "
                        "latest); without --ckpt_dir, the step number of "
                        "the eval_<step> directory (default: 0)")
    parser.add_argument("--max_images", type=int, default=None)
    parser.add_argument("--range", nargs="+", type=float, default=[0, 10])
    parser.add_argument("--meta_file", default="transforms_all")
    parser.add_argument("--reform_cam", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="dot-key overrides: e.g. val.chunk_size 4096")
    return parser


def prepare_hparams(hparams: dict) -> dict:
    """'n45_46_72' -> [45, 46, 72] (the train script's fixup)."""
    if isinstance(hparams["train.sample_num"], str):
        hparams["train.sample_num"] = [
            int(x) for x in hparams["train.sample_num"][1:].split("_")]
    return hparams


def evaluate(hparams: dict, device: Optional[str] = None) -> Dict[str, float]:
    """Render every val panorama, write the products, return mean metrics."""
    set_precision(hparams)
    data = dict(white_bkgd=hparams["val.white_bkgd"],
                num=hparams["train.sample_num"], range=hparams["range"],
                meta_file=hparams["meta_file"],
                reform_cam=bool(hparams["reform_cam"]))
    train_set = PanoDataset(hparams["data_path"], split="train",
                            factor=hparams["train.factor"],
                            **{**data, "white_bkgd":
                               hparams["train.white_bkgd"]})
    val_set = PanoDataset(hparams["data_path"], split="val",
                          factor=hparams["val.factor"], **data)
    system = build_system(hparams, device=device,
                          init_seed=hparams.get("init_seed") or 0)
    near, far = hparams["range"]
    if system.surface:
        system.set_env_rays(train_set.generate_lit_rays(
            num=hparams["nerf.num_ray_samples"], near=0.0, far=float(far)))
    step = hparams.get("step")
    if hparams.get("ckpt_dir"):
        saved = Checkpointer(os.path.join(hparams["ckpt_dir"],
                                          "checkpoints")).restore(
            step, map_location=system.device)
        params, step = saved["params"], int(saved["step"])
        print(f"[eval] restored step {step} from {hparams['ckpt_dir']}"
              f"/checkpoints", flush=True)
    else:
        params = (params_from_jax(load_npz(hparams["params"]))
                  if hparams.get("params") else None)
    step = step or 0
    render_fn = system.make_render_image(enable_surf=system.surface)
    save_dir = os.path.join(hparams["out_dir"], f"eval_{step:06d}")

    n = len(val_set)
    if hparams.get("max_images") is not None:
        n = min(n, hparams["max_images"])
    agg: Dict[str, list] = {}
    render_s, num_rays = 0.0, 0
    for i in range(n):
        rays, gt_rgb, gt_depth, gt_normal, gt_albedo = val_set[i]
        if system.device.type == "cuda":
            torch.cuda.synchronize(system.device)
        t0 = time.perf_counter()
        products = val_lib.render_full_pano(render_fn, params, rays,
                                            val_set.h, val_set.w,
                                            system.device)
        render_s += time.perf_counter() - t0   # ends in a device->host copy
        num_rays += val_set.h * val_set.w
        params = None  # loaded into the model by the first call
        for k, v in products.items():
            if not np.all(np.isfinite(v)):
                raise FloatingPointError(f"non-finite {k} in panorama {i}")
        m = val_lib.validation_metrics(products, gt_rgb, gt_depth, gt_normal,
                                       gt_albedo, near, far)
        val_lib.save_validation_products(products, gt_rgb, gt_depth,
                                         gt_normal, save_dir, i, near, far)
        for k, v in m.items():
            agg.setdefault(k, []).append(v)
    means = {k: float(np.mean(v)) for k, v in agg.items()}
    means.update(step=step, kind="eval", num_images=n,
                 device=(torch.cuda.get_device_name(system.device)
                         if system.device.type == "cuda" else "cpu"),
                 render_ms_per_pano=1e3 * render_s / max(n, 1),
                 rays_per_s=num_rays / max(render_s, 1e-9))
    return means


def main(argv=None) -> Dict[str, float]:
    hparams = prepare_hparams(parse_args(build_parser(), argv))
    metrics = evaluate(hparams, device=hparams["device"])
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    main()
