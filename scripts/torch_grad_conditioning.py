"""How well-conditioned the port's train-step gradient is under a config's
keys, on the CPU: whether a card-against-CPU gradient check can hold it.

For each case (overrides of `configs/panonerf.yaml`, full width, weights
from `--init_seed 0`, the kernels' plain versions, one batch of 64 rays
made with numpy, one step's draws from a seeded generator, without the
orientation and surface terms as `chip_smoke.py`'s check (b) takes it)
it prints the rel-norm of (1) the bf16 gradient against the f32 one and
(2) the f32 gradient of the same batch with every ray origin moved by
1e-6 against the unmoved one. Where (2) reaches the 5e-2 of the check,
the gradient is set by f32 rounding of the sample positions, whichever
device computes it. It measures nothing on a device.

    python3 scripts/torch_grad_conditioning.py [--rays 64]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CASES = {
    "default": [],
    "num_levels 3": ["nerf.num_levels", "3"],
    "stop_resample_grad false": ["nerf.stop_resample_grad", "False"],
    "disable_integration": ["nerf.disable_integration", "True"],
    "num_levels 3, stop_resample_grad false": [
        "nerf.num_levels", "3", "nerf.stop_resample_grad", "False"],
    "num_levels 3, stop_resample_grad false, disable_integration": [
        "nerf.num_levels", "3", "nerf.stop_resample_grad", "False",
        "nerf.disable_integration", "True"],
}


def gradient(opts, precision: str, rays: int, shift: float = 0.0):
    """The flat gradient of one train step (clip off, without the
    orientation and surface terms) of the case `opts` in `precision`."""
    import numpy as np
    import torch
    from pano_nerf_tpu_torch.core.config import load_config
    from pano_nerf_tpu_torch.core.rays import Rays
    from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
    from pano_nerf_tpu_torch.engine.system import build_system
    hp = load_config(str(ROOT / "configs" / "panonerf.yaml"), [
        "loss.ort_loss", "0.0", "loss.surface_loss", "0.0",
        "optimizer.grad_clip", "0.0", "train.precision", f"'{precision}'",
        *opts])
    system = build_system(hp, device="cpu", init_seed=0)
    # f32 on the kernel route too (the plain versions take it), so that
    # the two precisions differ in their rounding alone.
    system.model.kernels = True
    system.set_env_rays(generate_lit_rays(10, 0.0, 10.0))
    rng = np.random.default_rng(0)
    d = rng.normal(size=(rays, 3)).astype(np.float32)
    o = rng.uniform(-0.3, 0.3, (rays, 3)).astype(np.float32)
    if shift:
        e = np.random.default_rng(1).normal(size=o.shape)
        o = (o + shift * e / np.linalg.norm(e, axis=-1, keepdims=True)
             ).astype(np.float32)
    ones = np.ones((rays, 1), np.float32)
    T = torch.tensor
    batch = Rays(origins=T(o), directions=T(d),
                 viewdirs=T(d / np.linalg.norm(d, axis=-1, keepdims=True)),
                 radii=T(ones * 0.004), lossmult=T(ones), near=T(ones * 0.0),
                 far=T(ones * 10.0), noise_var=T(ones * 0.0))
    rgbs = T(rng.uniform(0.0, 3.0, (rays, 3)).astype(np.float32))
    draws = system.make_draws(rays, torch.Generator().manual_seed(5))
    system.make_train_step(True)(system.create_state(), batch, rgbs, draws)
    return torch.cat([p.grad.reshape(-1) for p in system.params()])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rays", type=int, default=64)
    args = parser.parse_args()
    rel = lambda a, b: float((a - b).norm() / b.norm())
    for name, opts in CASES.items():
        f32 = gradient(opts, "f32", args.rays)
        bf16 = gradient(opts, "bf16", args.rays)
        moved = gradient(opts, "f32", args.rays, shift=1e-6)
        print(f"[conditioning] {name}: bf16 vs f32 rel-norm "
              f"{rel(bf16, f32):.3e}; f32 with the origins moved by 1e-6 "
              f"{rel(moved, f32):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
