"""The launch counters of the port's CUDA kernels, read and moved as one.

Each kernel wrapper counts its launches on an attribute of its own
(`fused_mlp_ipe_apply.launches`, `.backward_launches`, ...). A CUDA graph
calls the wrappers once, while it is captured, and launches their kernels
at every replay; `engine/graphs.py` takes back what a capture counted and
adds it at each replay with these helpers, so that the counters stay the
number of launches that reached the card.
"""

from __future__ import annotations

from typing import Dict

from pano_nerf_tpu_torch.kernels import fused_mlp as k1
from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
from pano_nerf_tpu_torch.kernels import fused_render as k4
from pano_nerf_tpu_torch.kernels import fused_render_train as k5

# Counter name (as `chip_smoke.py` reports it) -> (owner, attribute).
COUNTERS = {
    "fused_mlp_apply_fwd": (k1.fused_mlp_apply, "launches"),
    "fused_mlp_apply_bwd": (k1.fused_mlp_apply, "backward_launches"),
    "fused_mlp_ipe_fwd": (k2.fused_mlp_ipe_apply, "launches"),
    "fused_mlp_ipe_bwd": (k2.fused_mlp_ipe_apply, "backward_launches"),
    "fused_mlp_normals_fwd": (k3.fused_mlp_normals_apply, "launches"),
    "fused_mlp_normals_bwd": (k3.fused_mlp_normals_apply,
                              "backward_launches"),
    "fused_render_train_fwd": (k5.fused_render_train, "launches"),
    "fused_render_train_bwd": (k5.fused_render_train, "backward_launches"),
    "fused_render_level": (k4.fused_render_level, "launches"),
    "fused_mlp_weight_grads": (k2.weight_grads, "launches"),
}


# Of the counted launches, those made by the eager warm-up runs before a
# capture (no step of a run and no panorama): counter name -> launches.
WARMUP: Dict[str, int] = {}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(owner, attr)
            for name, (owner, attr) in COUNTERS.items()}


def add_launch_counts(delta: Dict[str, int], times: int = 1) -> None:
    for name, n in delta.items():
        owner, attr = COUNTERS[name]
        setattr(owner, attr, getattr(owner, attr) + times * n)


def note_warmup(delta: Dict[str, int]) -> None:
    for name, n in delta.items():
        WARMUP[name] = WARMUP.get(name, 0) + n


def reset_launch_counts() -> None:
    """Zero every counter and the warm-up tally."""
    for owner, attr in COUNTERS.values():
        setattr(owner, attr, 0)
    WARMUP.clear()
