"""Import a reference (PyTorch Lightning) checkpoint as a port experiment.

Counterpart of scripts/import_reference_ckpt.py. Point it at a Lightning
`.ckpt` (or a bare `state_dict` `.pt`) of a reference training run; it
writes a port checkpoint at `--step` under `<out_dir>/<exp_name>/
checkpoints/` that `python -m pano_nerf_tpu_torch.eval --ckpt_dir
<out_dir>/<exp_name>`, `render_path` and `train` (resume) read:

  python -m pano_nerf_tpu_torch.import_reference_ckpt --torch_ckpt X \\
      --out_dir D --config configs/panonerf.yaml [--step N] [opts k v ...]

All of the reference's trained state is its one MLP, so the import is
exact; the optimizer state is not carried over (a resume starts Adam and
the batch stream fresh, as JAX's import does). The topology resolves in
the JAX script's order: the config, then the checkpoint's embedded
`hyper_parameters` (every `nerf.*` key), then the command line's opts. A
residual mismatch fails with a per-tensor report. The conversion runs on
the CPU; the card serves the result (any trunk width up to 256 and view
branch up to 128 on the kernels, `kernels/shapes.py`).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Tuple

import torch

from pano_nerf_tpu_torch.core.config import merge_from_list, parse_args
from pano_nerf_tpu_torch.engine.checkpoint import Checkpointer
from pano_nerf_tpu_torch.engine.system import build_system
from pano_nerf_tpu_torch.train import prepare_hparams
from pano_nerf_tpu_torch.utils.import_torch import convert_mlp_state_dict


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--torch_ckpt", required=True,
                        help="reference .ckpt / .pt file")
    parser.add_argument("--out_dir", type=str, default="./exps_imported/")
    parser.add_argument("--step", type=int, default=0,
                        help="step of the written checkpoint")
    parser.add_argument("--range", nargs="+", type=float, default=[0, 10])
    parser.add_argument("--config", default="./configs/panonerf.yaml")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="dot-key overrides, e.g. nerf.mlp_name mipnerf")
    return parser


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A Lightning .ckpt or a bare state_dict -> (its tensors by name, its
    embedded hyper-parameters or {})."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    hyper = {}
    if isinstance(obj, dict) and "state_dict" in obj:
        hyper = dict(obj.get("hyper_parameters") or {})
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a dict-like checkpoint, got "
                         f"{type(obj).__name__}")
    return ({k: v for k, v in obj.items() if isinstance(v, torch.Tensor)},
            hyper)


def main(argv=None) -> dict:
    """Import; returns the JSON summary it prints."""
    hparams = parse_args(build_parser(), argv)
    hparams["train.sample_num"] = hparams.get("train.sample_num", "n0")
    sd, hyper = load_torch_checkpoint(hparams["torch_ckpt"])
    topo = {k: v for k, v in hyper.items() if k.startswith("nerf.")}
    if topo:
        hparams.update(topo)
        merge_from_list(hparams, hparams.get("opts") or [])
        print(f"[import] adopted {len(topo)} nerf.* keys from the "
              "checkpoint's hyper-parameters")
    hparams = prepare_hparams(hparams)
    system = build_system(hparams, device="cpu")
    params = convert_mlp_state_dict(sd, system.model.mlp)
    # The reference has no illuminant field: with `nerf.illum_field` on,
    # the port's keeps its fresh initialization.
    params.update({k: v for k, v in system.model.param_state().items()
                   if k.startswith("illum.")})
    system.model.load_params(params)
    ckpt_dir = os.path.join(hparams["save_dir"], "checkpoints")
    step = int(hparams["step"])
    Checkpointer(ckpt_dir).save(step, dict(
        params=system.model.param_state()))
    summary = dict(imported_params=sum(
        p.numel() for _, p in system.model.named_params()),
        source=os.path.abspath(hparams["torch_ckpt"]),
        ckpt_dir=hparams["save_dir"], step=step)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
