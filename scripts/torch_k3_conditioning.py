"""How far bf16 rounding moves kernel 3's moment gradients, on one card:
at the shipped shape and at trunk 512 / view branch 256 (weights from
seeds 0 and 1), on the fine and coarse calls of a batch-512 train step
(`chip_smoke.train_shapes`), the gradients of `chip_smoke`'s check loss
(`_outs_and_grads`; the density gradient's term at 0.1, at 0.1 over its
rms as phase 19 takes it, and without it, as phase 2y holds D's moment
gradients) from the CUDA kernel, the bf16 plain version and the plain
version in f32 (TF32 off). Prints per case the rel-norm distances
kernel-plain, kernel-f32 and plain-f32 of the parameter, moment,
covariance and density gradients, and the share of the kernel-plain
(plain-f32) moment gradient distance that the 1% of rows farthest apart
carry. Where the kernel lies no further from f32 than the bf16 plain
version, a large kernel-plain distance is rounding, not the kernel.

    python3 scripts/torch_k3_conditioning.py
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    import chip_smoke as cs
    from pano_nerf_tpu_torch.core.config import load_config
    from pano_nerf_tpu_torch.core.rays import rays_to_tensors
    from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    from pano_nerf_tpu_torch.kernels.fused_render import pack_params
    from pano_nerf_tpu_torch.models import build_model
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print("[card]", cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    hp = load_config(cs.CONFIG)
    env = rays_to_tensors(generate_lit_rays(
        hp["nerf.num_ray_samples"], far=10.0, radius=0.0142), dev)
    rel = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    def top_share(a, b, frac=0.01):
        e = ((a - b) ** 2).reshape(a.shape[0], -1).sum(-1)
        return float(e.topk(max(1, int(frac * e.numel()))).values.sum()
                     / e.sum())

    cases = {"shipped, seed 0": ((), 0), "512 / 256, seed 0": (cs.SHAPE_D, 0),
             "512 / 256, seed 1": (cs.SHAPE_D, 1)}
    for name, (opts, seed) in cases.items():
        model = build_model(load_config(cs.CONFIG, list(opts)),
                            torch.Generator().manual_seed(seed)).to(dev)
        calls, _, _ = cs.train_shapes(model, env, dev)
        mlp = model.mlp
        m32 = copy.deepcopy(mlp)
        m32.compute_dtype = torch.float32
        kw = dict(min_deg=model.cfg.min_deg_point,
                  max_deg=model.cfg.max_deg_point)
        packed = pack_params(mlp)
        for call in ("fine", "coarse"):
            normals, means, covs, v = calls[call]
            kern = (k3.fused_mlp_normals_apply if normals
                    else k2.fused_mlp_ipe_apply)
            plain = (k3.fused_mlp_normals_reference if normals
                     else k2.fused_mlp_ipe_reference)
            for how in (("0.1", "rms", "0") if normals else ("0.1",)):
                scale = float(how) if how != "rms" else 0.1 / float(
                    torch.sqrt(torch.mean(plain(mlp, means, covs, v,
                                                **kw)[2].detach() ** 2)))
                K = cs._outs_and_grads(kern, mlp, means, covs, v,
                                       dsig_scale=scale, packed=packed, **kw)
                P = cs._outs_and_grads(plain, mlp, means, covs, v,
                                       dsig_scale=scale, **kw)
                F = cs._outs_and_grads(plain, m32, means, covs, v,
                                       dsig_scale=scale, **kw)
                torch.cuda.synchronize()
                out = {w: (rel(K[i], P[i]), rel(K[i], F[i]), rel(P[i], F[i]))
                       for w, i in (("grad", 1), ("dmc", 2), ("dcov", 4))}
                if normals:
                    out["dsig"] = (rel(K[0][2], P[0][2]),
                                   rel(K[0][2], F[0][2]),
                                   rel(P[0][2], F[0][2]))
                print(f"[k3] {name} {call} dsig_scale={how} ({scale:.3e}): "
                      "(kernel-plain, kernel-f32, plain-f32) "
                      + ", ".join(f"{k}=({a:.2e}, {b:.2e}, {c:.2e})"
                                  for k, (a, b, c) in out.items())
                      + f"; top 1% of rows' share of the moment-gradient "
                      f"distance kernel-plain {top_share(K[2], P[2]):.2f}, "
                      f"plain-f32 {top_share(P[2], F[2]):.2f}", flush=True)
        del model, calls, m32
    return 0


if __name__ == "__main__":
    sys.exit(main())
