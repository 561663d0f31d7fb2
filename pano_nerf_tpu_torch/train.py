"""Train a Pano-NeRF or mip-NeRF radiance field on panoramas on the H100.

Counterpart of the repository's `train.py` (same flags and trailing
dot-key overrides; the experiment goes to `<out_dir>/<exp_name>/`, with
exp_name = `<nerf.mlp_name>_<view ids>`):

  python -m pano_nerf_tpu_torch.train --data_path SCENE --out_dir OUT \\
      --config configs/panonerf.yaml [--init_seed N] [--device cuda|cpu] \\
      [opts k v ...]

The config's `nerf.mlp_name` picks the system (`engine/system.py`
`build_system`): 'panonerf' or 'mipnerf' (`configs/mipnerf.yaml`, the
baseline with one density channel). Every MLP evaluation of a train step
goes through the CUDA kernels 2 and 3 (`kernels/fused_mlp_ipe.py`,
`kernels/fused_mlp_normals.py`, built for 5 or 1 density channels), and
for Pano-NeRF 5 with `nerf.use_train_render_kernel`; validation renders
through kernel 4 (Pano-NeRF) or kernels 2 and 3 (mip-NeRF, and the HDR
presets `configs/panonerf_hdr.yaml` and `panonerf_shadow.yaml`).
A config the kernels are not built for (f32 `train.precision`, another
MLP topology, the emissive or chroma head) takes the plain route: every
MLP query through the general NerfMLP, said once as `[route] plain on
cuda: <reasons>`; with f32 TF32 is off (`core/device.py`).
On the card the steps run as CUDA graphs, `train.steps_per_call` of them
per replay where the cadences allow (`engine/trainer.py`), and each
validation chunk is a graph replay. Re-running the same command resumes
from the latest checkpoint under `<save_dir>/checkpoints/`. `--init_seed`
seeds the weight initialization (default: the config's `seed`). The TPU
knobs `train.scan_unroll` (a graph holds every step's kernels already),
`train.scoped_vmem_kib`, `nerf.fused_batch_threshold` and
`nerf.train_kernel_rows` have no effect.
"""

from __future__ import annotations

import argparse
import os

from pano_nerf_tpu_torch.core.config import parse_args
from pano_nerf_tpu_torch.core.device import set_precision


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_path", type=str, required=True,
                        help="scene directory with transforms_all.json")
    parser.add_argument("--out_dir", type=str, default="./exps/")
    parser.add_argument("--range", nargs="+", type=float, default=[0, 10])
    parser.add_argument("--config", default="./configs/default.yaml")
    parser.add_argument("--meta_file", default="transforms_all")
    parser.add_argument("--reform_cam", type=int, default=0)
    parser.add_argument("--init_seed", type=int, default=None,
                        help="weight-initialization seed (default: seed)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="dot-key overrides: e.g. train.batch_size 1024")
    return parser


def prepare_hparams(hparams: dict) -> dict:
    """Post-parse fixups of the JAX train script: view ids, exp_name, a
    fractional surface start, save_dir (created)."""
    if isinstance(hparams["train.sample_num"], str):
        hparams["train.sample_num"] = [
            int(x) for x in hparams["train.sample_num"][1:].split("_")]
    hparams["exp_name"] = (
        f"{hparams['nerf.mlp_name']}_"
        + "_".join(str(x) for x in hparams["train.sample_num"]))
    sss = hparams["train.surface_start_step"]
    if 0 < sss < 1:
        hparams["train.surface_start_step"] = int(
            sss * hparams["optimizer.max_steps"])
    hparams["save_dir"] = os.path.join(hparams["out_dir"], hparams["exp_name"])
    os.makedirs(hparams["save_dir"], exist_ok=True)
    return hparams


def main(argv=None):
    """Train; returns the Trainer (its hparams, system and datasets)."""
    hparams = prepare_hparams(parse_args(build_parser(), argv))
    set_precision(hparams)
    from pano_nerf_tpu_torch.engine.trainer import Trainer
    trainer = Trainer(hparams, device=hparams["device"],
                      init_seed=hparams.get("init_seed"))
    trainer.fit(resume_path=hparams.get("checkpoint.resume_path"))
    return trainer


if __name__ == "__main__":
    main()
