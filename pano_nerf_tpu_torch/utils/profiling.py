"""Tracing over torch.profiler.

Counterpart of pano_nerf_tpu/utils/profiling.py's `trace` and `annotate`
(jax.profiler there; the trainer's metrics.jsonl already logs rays per
second): `trace(log_dir)` captures host activity, and the card's kernels
where there is one, into a Chrome trace (`trace.json` under `log_dir`,
which chrome://tracing and Perfetto open); `annotate(name)` is a named
range on that timeline.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[profile]]:
    """Profile the block into `<log_dir>/trace.json` (a no-op yielding
    None when `log_dir` is empty); yields the profiler."""
    if not log_dir:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str) -> record_function:
    """A named range on the profiler's timeline (a context manager)."""
    return record_function(name)
