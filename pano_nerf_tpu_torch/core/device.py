"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
(`device="cpu"`, as the tests do). Without a card and without that request
they raise: nothing carries on quietly on the CPU. `set_precision` makes
f32 `train.precision` mean f32 products on the card (no TF32).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_precision(hparams: dict) -> None:
    """With f32 `train.precision`, turn TF32 off for matmuls and cuDNN: a
    TF32 product (10-bit mantissa) would pass for f32 on the card."""
    if str(hparams.get("train.precision", "bf16")) in ("f32", "float32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
