"""Ray bundles as NamedTuples of tensors.

Counterpart of pano_nerf_tpu/core/rays.py. Fields (all share leading dims):
  origins [..., 3], directions [..., 3] (un-normalized), viewdirs [..., 3]
  (unit), radii, lossmult, near, far, noise_var: [..., 1].
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class Rays(NamedTuple):
    origins: torch.Tensor
    directions: torch.Tensor
    viewdirs: torch.Tensor
    radii: torch.Tensor
    lossmult: torch.Tensor
    near: torch.Tensor
    far: torch.Tensor
    noise_var: torch.Tensor


RAYS_KEYS = Rays._fields


def rays_map(fn: Callable, rays: Rays) -> Rays:
    """Apply `fn` to every field of a Rays bundle."""
    return Rays(*(fn(getattr(rays, k)) for k in RAYS_KEYS))


def rays_to_tensors(rays, device: torch.device) -> Rays:
    """Host-side (numpy) rays -> contiguous float32 tensors on `device`."""
    return rays_map(lambda x: torch.as_tensor(
        np.ascontiguousarray(x, dtype=np.float32)).to(device), rays)
