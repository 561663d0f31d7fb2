"""Render a novel-view panorama sequence from a port checkpoint on the H100.

Counterpart of scripts/render_path.py: camera positions on a path through
the training views' poses (`--path interp`: `utils/vis.gen_render_path`)
or on a circle around them (`--path spheric`: `create_spheric_poses`),
each rendered as a full equirect panorama at the training resolution by
the config's system (`nerf.mlp_name`, `build_system`) through its chunked
renderer (on the card one chunk-graph replay per `val.chunk_size` rays:
kernel 4 for `configs/panonerf.yaml`, kernels 2 and 3 for the HDR
presets and for mip-NeRF), and written as `NNNN.exr` (HDR `rgb_fine`)
and `NNNN.png` (tone-mapped).

Usage:
  python -m pano_nerf_tpu_torch.render_path --data_path SCENE \\
      --ckpt_dir EXP [--config configs/panonerf.yaml] [--out frames/] \\
      [--n_views 30] [--path interp|spheric] [--video F.gif] \\
      [--device cuda|cpu] [opts k v ...]

`--ckpt_dir` is a run of `python -m pano_nerf_tpu_torch.train` (its
`<out_dir>/<exp_name>`); the weights of its latest checkpoint are
rendered. `--video` also stitches the PNG frames with
`imageio` where it is installed, and prints a notice and skips it where
it is not.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from pano_nerf_tpu_torch.core.config import parse_args
from pano_nerf_tpu_torch.core.device import set_precision
from pano_nerf_tpu_torch.data.pano_dataset import (PanoDataset,
                                                   pano_rays_for_pose)
from pano_nerf_tpu_torch.engine.checkpoint import Checkpointer
from pano_nerf_tpu_torch.engine.system import build_system
from pano_nerf_tpu_torch.engine.validation import render_full_pano
from pano_nerf_tpu_torch.eval import prepare_hparams
from pano_nerf_tpu_torch.ops.shading import hdr_to_ldr
from pano_nerf_tpu_torch.utils.vis import (create_spheric_poses,
                                           gen_render_path, save_results)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_path", required=True,
                        help="scene directory with transforms_all.json")
    parser.add_argument("--ckpt_dir", required=True,
                        help="a port training run (checkpoints/ inside)")
    parser.add_argument("--config", default="./configs/panonerf.yaml")
    parser.add_argument("--out", default="./frames")
    parser.add_argument("--n_views", type=int, default=30)
    parser.add_argument("--path", choices=["interp", "spheric"],
                        default="interp")
    parser.add_argument("--video", default=None,
                        help="also stitch the PNG frames into this file "
                             "(needs imageio; skipped with a notice "
                             "without it)")
    parser.add_argument("--fps", type=int, default=15)
    parser.add_argument("--range", nargs="+", type=float, default=[0, 10])
    parser.add_argument("--meta_file", default="transforms_all")
    parser.add_argument("--reform_cam", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="dot-key overrides: e.g. val.chunk_size 4096")
    return parser


def path_origins(c2ws: np.ndarray, path: str, n_views: int) -> np.ndarray:
    """Camera positions [M, 3] of the path through the poses c2ws
    [N, 4, 4]."""
    if path == "interp":
        return gen_render_path(c2ws, n_views=n_views)[:, :3, 3]
    radius = float(np.linalg.norm(c2ws[:, :3, 3], axis=-1).mean() + 0.3)
    return create_spheric_poses(max(radius, 0.3),
                                n_poses=n_views)[:, :3, 3]


def render_frame(render_fn: Callable, params: Optional[Mapping],
                 origin: np.ndarray, h: int, w: int, near: float,
                 far: float, device: torch.device) -> Dict[str, np.ndarray]:
    """The products [h, w, C] of the panorama seen from `origin`."""
    rays = pano_rays_for_pose(np.asarray(origin), h, w, near, far)
    return render_full_pano(render_fn, params, rays, h, w, device)


def render_path(hparams: dict, device: Optional[str] = None) -> Dict:
    """Render and write every frame; returns the restored step, the
    frame paths and the host time per frame (ms, the first frame with
    the chunk graph's capture apart)."""
    set_precision(hparams)
    ds = PanoDataset(hparams["data_path"], split="train",
                     factor=hparams["train.factor"],
                     num=hparams["train.sample_num"], range=hparams["range"],
                     meta_file=hparams["meta_file"],
                     reform_cam=bool(hparams["reform_cam"]))
    system = build_system(hparams, device=device)
    if system.surface:
        system.set_env_rays(ds.generate_lit_rays(
            num=hparams["nerf.num_ray_samples"],
            far=float(hparams["range"][1])))
    saved = Checkpointer(os.path.join(hparams["ckpt_dir"],
                                      "checkpoints")).restore(
        None, map_location=system.device)
    step = int(saved["step"])
    print(f"[render_path] restored step {step}", flush=True)

    origins = path_origins(np.stack([np.asarray(m) for m in ds.camtoworlds]),
                           hparams["path"], hparams["n_views"])
    render_fn = system.make_render_image(enable_surf=system.surface)
    near, far = hparams["range"]
    out = hparams["out"]
    os.makedirs(out, exist_ok=True)
    params: Optional[Mapping] = saved["params"]
    frames: List[str] = []
    ms: List[float] = []
    ldr_frames = []
    for i, origin in enumerate(origins):
        if system.device.type == "cuda":
            torch.cuda.synchronize(system.device)
        t0 = time.perf_counter()
        products = render_frame(render_fn, params, origin, ds.h, ds.w, near,
                                far, system.device)
        ms.append(1e3 * (time.perf_counter() - t0))
        params = None   # loaded into the model by the first frame
        hdr = products["rgb_fine"]
        if not np.all(np.isfinite(hdr)):
            raise FloatingPointError(f"non-finite radiance in frame {i}")
        ldr = hdr_to_ldr(hdr)
        stem = os.path.join(out, f"{i:04d}")
        save_results(hdr, stem + ".exr")
        save_results(ldr, stem + ".png")
        frames.append(stem)
        if hparams.get("video"):
            ldr_frames.append((np.clip(ldr, 0, 1) * 255).astype(np.uint8))
        print(f"[render_path] frame {i + 1}/{len(origins)}", flush=True)
    print(f"[render_path] wrote {len(origins)} frames to {out}", flush=True)
    if hparams.get("video"):
        try:
            import imageio
            if hparams["video"].lower().endswith(".gif"):
                imageio.mimsave(hparams["video"], ldr_frames,
                                duration=1000.0 / int(hparams["fps"]))
            else:
                imageio.mimsave(hparams["video"], ldr_frames,
                                fps=int(hparams["fps"]))
            print(f"[render_path] wrote video {hparams['video']}")
        except Exception as e:  # missing package or codec: frames stay
            print(f"[render_path] video export skipped "
                  f"({type(e).__name__}: {e})")
    return dict(step=step, frames=frames, ms_per_frame=ms,
                size=(ds.h, ds.w))


def main(argv=None) -> Dict:
    hparams = prepare_hparams(parse_args(build_parser(), argv))
    return render_path(hparams, device=hparams["device"])


if __name__ == "__main__":
    main()
