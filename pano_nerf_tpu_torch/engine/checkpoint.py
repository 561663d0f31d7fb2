"""Checkpoint and resume with `torch.save`.

Counterpart of pano_nerf_tpu/engine/checkpoint.py (orbax there): one file
per saved step, `ckpt_<step>.pt` under the checkpoint directory, holding
the step, the MLP's parameters, the optimizer state and the state of the
training generator. The latest checkpoint is kept, and every step that is
a multiple of `keep_every_n_steps` (0: only the latest). Files are written
to a temporary name and renamed, so a crash never leaves a torn latest
checkpoint. Orbax checkpoints of the JAX package are not readable here;
JAX-trained weights reach the port through `utils/params.py`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, keep_every_n_steps: int = 0):
        self.directory = os.path.abspath(directory)
        self.keep_every_n_steps = int(keep_every_n_steps or 0)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Write `state` (tensors, numbers, state dicts) as step `step`,
        then drop older checkpoints that are not kept."""
        tmp = self._path(step) + ".tmp"
        torch.save(dict(state, step=int(step)), tmp)
        os.replace(tmp, self._path(step))
        keep = self.keep_every_n_steps
        for old in self.steps():
            if old < step and not (keep and old % keep == 0):
                os.remove(self._path(old))

    def restore(self, step: Optional[int] = None,
                map_location: Optional[torch.device] = None
                ) -> Dict[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)
