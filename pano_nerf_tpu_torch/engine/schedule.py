"""Learning-rate schedule: log-lerp decay with a reverse-cosine warm-up.

Counterpart of pano_nerf_tpu/engine/schedule.py (`mip_lr_decay`):
lr(0) = lr_init, lr(max_steps) = lr_final, log-linear in between, scaled
during the first `lr_delay_steps` by lr_delay_mult eased out with
sin(pi/2 * t). Computed in float32, as the JAX schedule is. `lr_table`
holds the schedule of every step 0..max_steps for a train step that reads
its learning rate on the device (a CUDA graph cannot take a Python float
per step).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def _lr_f32(steps: np.ndarray, lr_init: float, lr_final: float,
            max_steps: int, lr_delay_steps: int, lr_delay_mult: float
            ) -> np.ndarray:
    """The schedule at float32 `steps` (an array), in float32."""
    f32 = np.float32
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1.0 - lr_delay_mult) * np.sin(
            f32(0.5 * np.pi) * np.clip(steps / f32(lr_delay_steps), f32(0),
                                       f32(1)))
    else:
        delay_rate = f32(1.0)
    t = np.clip(steps / f32(max_steps), f32(0), f32(1))
    log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                      + np.log(f32(lr_final)) * t)
    return (delay_rate * log_lerp).astype(f32)


def mip_lr_decay(lr_init: float, lr_final: float, max_steps: int,
                 lr_delay_steps: int = 0, lr_delay_mult: float = 1.0
                 ) -> Callable[[int], float]:
    """Returns step -> learning rate."""
    def schedule(step: int) -> float:
        return float(_lr_f32(np.array([step], np.float32), lr_init,
                             lr_final, max_steps, lr_delay_steps,
                             lr_delay_mult)[0])

    return schedule


def lr_table(lr_init: float, lr_final: float, max_steps: int,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0
             ) -> np.ndarray:
    """The schedule of steps 0..max_steps as one float32 array, entry s
    equal to `mip_lr_decay(...)(s)`."""
    return _lr_f32(np.arange(max_steps + 1, dtype=np.float32), lr_init,
                   lr_final, max_steps, lr_delay_steps, lr_delay_mult)
