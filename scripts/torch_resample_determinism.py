"""Whether the resampling gradient (`nerf.stop_resample_grad: false`)
gives the same bits at every run on one card, through torch's gather
backward (a scatter-add, by atomics on CUDA) and through the port's
(`ops/mip.py` `_GatherLast`: a reduction in a fixed order).

1. The op alone: `--reps` runs of `mip.resample_along_rays`'s gradient
   into the coarse weights and fenceposts at a batch-512 step's shape (56
   bins, 56 samples), the PDF peaked (a softmax of 4 x normal draws; draw
   seeds 0 .. `--draws` - 1). Per route and draw: the number of distinct
   gradients among the runs and their largest distance to the first.
2. The step: `chip_smoke.py`'s phase 19 (three levels, the resampling
   gradient, no integration, kernel 5 on) trained 64 steps, then its
   graphed-vs-eager check `--checks` times per route, the routes in
   turns, while `--load` processes at nice 10 multiply f32 matrices on
   the CPU (as `chip_smoke.py`'s CPU pool works beside the card). Per
   check: the eager-vs-eager spread and whether the check passed.

The card's name and power limit first, a JSON summary last.

    python3 scripts/torch_resample_determinism.py [--reps 200] \\
        [--draws 4] [--checks 6] [--load 4]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class _TorchGather:
    """The gather `sorted_piecewise_constant_pdf` used before
    `_GatherLast`: torch's, whose backward is a scatter-add."""

    @staticmethod
    def apply(x, idx):
        return x.gather(-1, idx)


@contextlib.contextmanager
def route(name: str):
    from pano_nerf_tpu_torch.ops import mip
    port = mip._GatherLast
    if name == "torch":
        mip._GatherLast = _TorchGather
    try:
        yield
    finally:
        mip._GatherLast = port


def _burn(_seed: int) -> None:
    import os
    import torch
    os.nice(10)
    torch.set_num_threads(2)
    a = torch.randn(512, 512)
    while True:
        a = torch.tanh(a @ a)


def op_runs(reps: int, draws: int) -> dict:
    import torch
    from pano_nerf_tpu_torch.ops import mip
    dev = torch.device("cuda")
    out = {}
    for seed in range(draws):
        g = torch.Generator().manual_seed(seed)
        B, N = 512, 56
        ins = [torch.randn(B, 3, generator=g), torch.randn(B, 3, generator=g),
               torch.full((B, 1), 0.0142),
               torch.sort(torch.rand(B, N + 1, generator=g) * 10, -1).values,
               torch.softmax(torch.randn(B, N, generator=g) * 4, -1),
               torch.rand(B, N + 1, generator=g),
               torch.randn(B, N, 3, generator=g)]
        o, d, r, t, w, u, coef = [x.to(dev) for x in ins]

        def grads():
            tq, wq = t.clone().requires_grad_(), w.clone().requires_grad_()
            _, (m, _) = mip.resample_along_rays(o, d, r, tq, wq, 0.01,
                                                num_samples=N, u_rand=u,
                                                stop_grad=False)
            torch.sum(coef * torch.sin(m)).backward()
            return torch.cat([tq.grad.reshape(-1), wq.grad.reshape(-1)])
        for name in ("torch", "port"):
            with route(name):
                runs = [grads() for _ in range(reps)]
            distinct = len({x.cpu().numpy().tobytes() for x in runs})
            far = max(float((x - runs[0]).abs().max()) for x in runs)
            out[f"{name}, draw {seed}"] = dict(distinct=distinct, far=far)
            print(f"[op] {name:5s} gather, draw {seed}: {distinct} distinct "
                  f"gradients in {reps} runs, largest distance to the first "
                  f"{far:.3e}", flush=True)
    return out


def step_checks(checks: int, load: int) -> dict:
    import multiprocessing
    import chip_smoke as cs
    from pano_nerf_tpu_torch.kernels import build, fused_mlp_ipe
    from pano_nerf_tpu_torch.kernels import fused_render, fused_render_train
    pending = [build.start_build(src, ()) for src in (
        fused_render.SOURCE, fused_render_train.SOURCE, fused_mlp_ipe.SOURCE)]
    for p in pending:
        build.finish_build(p)
    res = {"torch": [], "port": []}
    burners = []
    with tempfile.TemporaryDirectory() as wd:
        scene = cs.make_scene(wd)
        config, opts, key, _, _, _ = cs.LEVEL_PHASES["19"]
        run = cs.drive_train_path(wd, scene, render_kernel=key, config=config,
                                  opts=opts, steps=64, name="p19")
        ctx = multiprocessing.get_context("spawn")
        burners = [ctx.Process(target=_burn, args=(i,), daemon=True)
                   for i in range(load)]
        try:
            for b in burners:
                b.start()
            for i in range(checks):
                for name in ("torch", "port"):
                    buf = io.StringIO()
                    ok = True
                    with route(name), contextlib.redirect_stdout(buf):
                        try:
                            cs.check_graphed_against_eager(run["trainer"])
                        except AssertionError:
                            ok = False
                    text = buf.getvalue()
                    m = re.search(r"params rel-norm (\S+), per-step loss "
                                  r"(\S+);", text)
                    spread = (float(m.group(1).rstrip(",")),
                              float(m.group(2))) if m else None
                    res[name].append(dict(passed=ok, spread=spread))
                    print(f"[step] {name:5s} gather, check {i}: "
                          f"{'passed' if ok else 'FAILED'}; eager-vs-eager "
                          f"spread (params, loss) {spread}", flush=True)
        finally:
            for b in burners:
                b.terminate()
                b.join()
    return res


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--draws", type=int, default=4)
    ap.add_argument("--checks", type=int, default=6)
    ap.add_argument("--load", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print("[card]", cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    summary = dict(op=op_runs(args.reps, args.draws))
    if args.checks > 0:
        summary["step"] = step_checks(args.checks, args.load)
    cs.close_cpu_pool()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
