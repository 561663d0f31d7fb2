"""Learning-rate schedule: log-lerp decay with a reverse-cosine warm-up.

Counterpart of pano_nerf_tpu/engine/schedule.py (`mip_lr_decay`):
lr(0) = lr_init, lr(max_steps) = lr_final, log-linear in between, scaled
during the first `lr_delay_steps` by lr_delay_mult eased out with
sin(pi/2 * t). Computed in float32, as the JAX schedule is.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def mip_lr_decay(lr_init: float, lr_final: float, max_steps: int,
                 lr_delay_steps: int = 0, lr_delay_mult: float = 1.0
                 ) -> Callable[[int], float]:
    """Returns step -> learning rate."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if lr_delay_steps > 0:
            delay_rate = f32(lr_delay_mult) + f32(1.0 - lr_delay_mult) * np.sin(
                f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps), f32(0),
                                           f32(1)))
        else:
            delay_rate = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                          + np.log(f32(lr_final)) * t)
        return float(f32(delay_rate * log_lerp))

    return schedule
