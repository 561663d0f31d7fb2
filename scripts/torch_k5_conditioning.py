"""Where kernel 5's moment-gradient distance to its plain version lies, on
one card: for a shape of `tests/test_torch_cuda.py` (`_shape_mlp`: weights
from a seed) on that file's inputs (`_inputs`, R rays of S samples) and
loss (`_render_grads`), the moment gradient of the CUDA kernel (K), the
bf16 plain version (B) and the plain version in f32 (F, TF32 off). Prints
per case the rel-norm distances K-B, K-F and B-F, the share of |K-B|^2
that the 1% of rows farthest apart carry and the farthest row alone, and
how far a 1e-6 shift of the means (a seeded normal draw) moves B and K
themselves. Where one row carries the distance and a 1e-6 shift moves
the gradient as far, the distance is that row's conditioning, not the
kernel.

    python3 scripts/torch_k5_conditioning.py ["P4 131 5 1" ...]

(each case: shape, R, S, weight seed).
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

CASES = ("P4 131 5 1", "P4 1024 5 2", "W1024 131 5 1", "W1024 131 5 3",
         "W1024 37 56 1", "W512 131 5 1", "H1024 37 56 1", "H 131 5 1")


def main(argv) -> int:
    import torch
    import chip_smoke as cs
    import test_torch_cuda as tc
    from pano_nerf_tpu_torch.kernels import build, shapes
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    from pano_nerf_tpu_torch.models.mlp import NerfMLP
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print("[card]", cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cases = [(n, int(R), int(S), int(seed)) for n, R, S, seed in
             (c.split() for c in (argv or CASES))]
    libs = set()
    for n, *_ in cases:
        sh = shapes.build_of(tc._shape_mlp(n, "cpu")[0])
        libs |= {(k2.SOURCE, sh.defines()), (k5.SOURCE, sh.defines(False))}
    for p in [build.start_build(*b) for b in sorted(libs)]:
        build.finish_build(p)
    rel = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    def f32_copy(mlp):
        m = NerfMLP(mlp.xyz_dim, mlp.view_dim, net_width=mlp.net_width,
                    net_width_condition=mlp.net_width_condition,
                    num_density_channels=mlp.num_density_channels,
                    compute_dtype=torch.float32).to(dev)
        m.load_state_dict(mlp.state_dict())
        return m

    def dmeans(fn, mlp, args, kw):
        return tc._render_grads(fn, mlp, args, False, **kw)[2]

    for n, R, S, seed in cases:
        mlp, kw = tc._shape_mlp(n, dev, seed=seed)
        args = tc._inputs(R, S, dev)
        K = dmeans(k5.fused_render_train, mlp, args, kw)
        B = dmeans(k5.fused_render_train_reference, mlp, args, kw)
        F = dmeans(k5.fused_render_train_reference, f32_copy(mlp), args, kw)
        g = torch.Generator(device=dev).manual_seed(7)
        shifted = [args[0] + 1e-6 * torch.randn(
            args[0].shape, generator=g, device=dev)] + args[1:]
        Bs = dmeans(k5.fused_render_train_reference, mlp, shifted, kw)
        Ks = dmeans(k5.fused_render_train, mlp, shifted, kw)
        e = ((K - B) ** 2).reshape(-1, 3).sum(-1)
        top = float(e.topk(max(1, e.numel() // 100)).values.sum() / e.sum())
        print(f"{n} R{R} S{S} seed{seed}: K-B {rel(K, B):.4f} K-F "
              f"{rel(K, F):.4f} B-F {rel(B, F):.4f}; top 1% rows {top:.3f} "
              f"of |K-B|^2, top row {float(e.max() / e.sum()):.3f}; 1e-6 "
              f"shift moves B {rel(Bs, B):.4f}, K {rel(Ks, K):.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
