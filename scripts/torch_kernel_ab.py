"""This checkout's CUDA kernels against another checkout's, on one card.

Builds the port's CUDA sources of both trees (this one through
`kernels/build.py`, the other with the same nvcc flags into
`build/kernel_ab/`), then, on the same inputs at the main paths' shapes
(full `configs/panonerf.yaml` width, random weights from seed 0):

- kernel 4 (`fused_render_level`) at the eval shapes: coarse 1024 x 56,
  fine with normals 1024 x 56, env 10240 x 5, and the ragged fine
  1023 x 56 and env 10239 x 5;
- kernels 2 and 3 forward and backward row pass (28,672 rows of a
  batch-512 train step) and kernel 5 forward and row pass (coarse
  512 x 56), the kernels whose steps share `csrc/mlp_rows.cuh`.

For each it prints the largest difference between the two trees'
outputs (`bitwise` when they are equal bit for bit) and the ms per launch
of each, from CUDA events over rounds run in the order other, this, this,
other (warm-up excluded), with the card's name and power limit. Both
trees' kernels are launched through this tree's wrapper helpers
(`launch_level`, `launch_forward`, `launch_backward_rows`); the script
stops if the other tree's libraries lack an entry point or disagree on
the packed weight and bias counts or the buffer sizes it hands them. Run from
the repository root on a machine with the card:

    mkdir -p build/kernel_ab/parent
    git archive <commit> pano_nerf_tpu_torch | tar -x -C build/kernel_ab/parent
    python3 scripts/torch_kernel_ab.py --other build/kernel_ab/parent

The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCES = ("fused_render.cu", "fused_mlp.cu", "fused_render_train.cu")


def build_other(other: Path) -> dict:
    """nvcc of the other tree's sources, all started together; returns
    {source: CDLL} with this tree's ctypes signatures."""
    from pano_nerf_tpu_torch.kernels import build
    out_dir = ROOT / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in SOURCES:
        so = out_dir / f"other_{Path(src).stem}.so"
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so),
               str(other / "pano_nerf_tpu_torch" / "csrc" / src)]
        procs[src] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for src, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the other tree's {src}:\n{log}")
        libs[src] = ctypes.CDLL(str(so))
    return libs


def bind_other(mine: ctypes.CDLL, other: ctypes.CDLL, calls: tuple,
               same: dict) -> ctypes.CDLL:
    """Give `other` this tree's ctypes signatures of the entry points
    `calls`, after checking that it exports them and that every query in
    `same` ({name: (args, ...)}) answers as this tree's library does: the
    packed weight and bias counts and the buffer sizes this script hands
    both sides. ctypes cannot see a changed argument list, so a change of
    layout stops the script here instead."""
    for name in calls + tuple(same):
        if not hasattr(other, name):
            raise SystemExit(f"the other tree's library has no {name}")
        getattr(other, name).argtypes = getattr(mine, name).argtypes
        getattr(other, name).restype = getattr(mine, name).restype
    for name, arg_sets in same.items():
        for args in arg_sets:
            a, b = getattr(mine, name)(*args), getattr(other, name)(*args)
            if a != b:
                raise SystemExit(f"{name}{args}: this tree {a}, the other "
                                 f"{b}; the two layouts differ")
    if hasattr(mine, "_pano_shape"):   # the MLP shape both are built for
        other._pano_shape = mine._pano_shape
    return other


def diff(a, b) -> object:
    import torch
    if torch.equal(a, b):
        return "bitwise"
    return float((a.float() - b.float()).abs().max())


def ab_time(fn_other, fn_mine, rounds: int) -> tuple:
    """Median ms per launch of each, in the order other, this, this,
    other, repeated `rounds` times."""
    import statistics
    from chip_smoke import time_ms
    t = {"other": [], "this": []}
    for _ in range(rounds):
        for side in ("other", "this", "this", "other"):
            fn = fn_other if side == "other" else fn_mine
            t[side].append(time_ms(fn, reps=20))
    return statistics.median(t["other"]), statistics.median(t["this"])


def kernel4(model, env, dev, libs, rounds: int, results: dict) -> None:
    import torch
    from chip_smoke import main_path_inputs
    from pano_nerf_tpu_torch.kernels import fused_render as fr
    shapes = main_path_inputs(model, env, dev)
    for name, R in (("fine", 1023), ("env", 10239)):
        args, kw = shapes[name]
        cut = [a[:R].contiguous() for a in args]
        shapes[f"{name}_ragged"] = (cut, kw)
    weights, biases = fr.pack_params(model.mlp)
    mine = fr.kernel_library()
    # The tiling may differ (it is what a kernel-4 change may change);
    # the output slab [R, 17 + S] does not depend on it.
    other = bind_other(mine, libs["fused_render.cu"],
                       ("fused_render_level_launch",
                        "fused_render_error_string"),
                       {"fused_render_weight_count": [()],
                        "fused_render_bias_count": [()]})
    for name, (args, kw) in shapes.items():
        R, S = args[0].shape[:2]
        mc, rayinfo = fr.level_rows(*args)
        kwl = {k: v for k, v in kw.items() if k not in ("max_deg", "deg_view")}

        def run(lib):
            return lambda: fr.launch_level(lib, mc, rayinfo, weights, biases,
                                           R, S, **kwl)
        d = diff(run(other)(), run(mine)())
        torch.cuda.synchronize()
        ms_o, ms_m = ab_time(run(other), run(mine), rounds)
        results[f"k4_{name}"] = dict(R=R, S=S, diff=d, other_ms=ms_o,
                                     this_ms=ms_m)
        # Modelled, not counted: this tree's tiles x the TMA-box bytes one
        # tile loads, over this tree's measured time.
        tiles = fr.plan_tiles(R, S).num_tiles
        wbytes = tiles * fr.weight_bytes_per_tile(kw["need_normals"])
        print(f"[ab] kernel 4 {name:12s} R={R} S={S}: other {ms_o:.4f} ms, "
              f"this {ms_m:.4f} ms ({ms_o / ms_m:.2f}x); outputs differ by "
              f"{d}; modelled weight bytes of this tree: {tiles} tiles, "
              f"{wbytes / 1e9:.3f} GB of TMA boxes / measured ms = "
              f"{wbytes / ms_m / 1e9:.3f} TB/s", flush=True)


def train_calls(model, env, dev, batch: int = 512) -> tuple:
    """The kernel calls and the kernel-5 levels of one train step at
    `batch` rays (`chip_smoke.train_shapes`, whose surface points are not
    timed here)."""
    from chip_smoke import train_shapes
    calls, levels, _ = train_shapes(model, env, dev, batch)
    return calls, levels


def train_kernels(model, env, dev, libs, rounds: int, results: dict) -> None:
    import torch
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    from pano_nerf_tpu_torch.kernels.fused_render import pack_params
    calls, levels = train_calls(model, env, dev)
    weights, biases = pack_params(model.mlp)
    cfg = model.cfg
    mine = k2.kernel_library()
    other = bind_other(mine, libs["fused_mlp.cu"],
                       ("fused_mlp_forward", "fused_mlp_backward_rows",
                        "fused_mlp_bias_workspace", "fused_mlp_error_string"),
                       {"fused_mlp_weight_count": [()],
                        "fused_mlp_bias_count": [()],
                        "fused_mlp_tile_rows": [()],
                        "fused_mlp_ops_width": [(0,), (1,)]})
    for shape in ("coarse", "fine"):
        normals, means, covs, v_enc = calls[shape]
        mc, v = k2.rows_of(means, covs, v_enc, tuple(means.shape[:-1]))
        M = mc.shape[0]
        gen = torch.Generator(device=dev).manual_seed(5)
        g = torch.randn(M, 16, device=dev, generator=gen)
        q = torch.randn(M, 3, device=dev, generator=gen) if normals else None
        res = {}
        for side, lib in (("other", other), ("this", mine)):
            out, dsig, acts = k2.launch_forward(lib, mc, v, weights, biases,
                                                cfg.min_deg_point, normals,
                                                save_acts=normals)
            ops, dw, db = k2.backward_buffers(mine, weights, biases,
                                              k2.tile_rows(mine, M), normals)
            dmc = torch.empty((M, 8), device=dev)
            res[side] = dict(lib=lib, out=out, dsig=dsig, acts=acts, ops=ops,
                             dw=dw, db=db, dmc=dmc)

        def fwd(b):
            return lambda: k2.launch_forward(b["lib"], mc, v, weights, biases,
                                             cfg.min_deg_point, normals,
                                             save_acts=normals)

        def rows(b):
            return lambda: k2.launch_backward_rows(
                b["lib"], mc, v, weights, biases, g, q, b["acts"], b["ops"],
                b["dmc"], b["dw"], b["db"], cfg.min_deg_point, normals)
        o, m = res["other"], res["this"]
        rows(o)()
        rows(m)()
        torch.cuda.synchronize()
        name = "k3" if normals else "k2"
        r = dict(M=M, out=diff(o["out"], m["out"]),
                 dmc=diff(o["dmc"], m["dmc"]), ops=diff(o["ops"], m["ops"]))
        if normals:
            r["dsig"] = diff(o["dsig"], m["dsig"])
            r["acts"] = diff(o["acts"], m["acts"])
        r["fwd_other_ms"], r["fwd_this_ms"] = ab_time(fwd(o), fwd(m), rounds)
        r["rows_other_ms"], r["rows_this_ms"] = ab_time(rows(o), rows(m),
                                                        rounds)
        results[f"{name}_{shape}"] = r
        print(f"[ab] kernel {name[1]} {shape} M={M}: forward other "
              f"{r['fwd_other_ms']:.4f} ms, this {r['fwd_this_ms']:.4f} ms; "
              f"row pass other {r['rows_other_ms']:.4f}, this "
              f"{r['rows_this_ms']:.4f}; outputs "
              + json.dumps({k: r[k] for k in ("out", "dsig", "acts", "dmc",
                                              "ops") if k in r}), flush=True)

    # Kernel 5 on the coarse level: forward, and its backward row pass.
    means, covs, viewdirs, t_samples, dirs = levels["coarse"]
    R, S = means.shape[:2]
    mc, clip, v = k5.level_rows(means, covs, viewdirs, t_samples, dirs,
                                cfg.deg_view)
    mc = mc.contiguous()
    mine5 = k5.kernel_library()
    other5 = bind_other(mine5, libs["fused_render_train.cu"],
                        ("fused_render_train_forward",
                         "fused_render_train_backward_rows",
                         "fused_render_train_bias_workspace"),
                        {"fused_render_train_blocks": [(R, S)]})
    lv = k5.Level(R, S, cfg.min_deg_point, float(cfg.density_bias),
                  float(cfg.rgb_padding), False)
    blocks = mine5.fused_render_train_blocks(R, S)
    gen = torch.Generator(device=dev).manual_seed(7)
    g_out = torch.randn(R, 8, device=dev, generator=gen)
    g_w = torch.randn(R, S, device=dev, generator=gen)
    res = {}
    for side, lib in (("other", other5), ("this", mine5)):
        out, w, _ = k5.launch_forward(mc, clip, v, weights, biases, lv,
                                      False, lib=lib)
        ops, _, db = k2.backward_buffers(mine, weights, biases,
                                         blocks * k5.TILE_ROWS, False)
        res[side] = dict(lib=lib, out=out, w=w, ops=ops, db=db,
                         dmc=torch.empty((R * S, 8), device=dev))

    def fwd5(b):
        return lambda: k5.launch_forward(mc, clip, v, weights, biases, lv,
                                         False, lib=b["lib"])

    def rows5(b):
        return lambda: k5.launch_backward_rows(
            mc, clip, v, weights, biases, None, g_out, g_w, lv, b["ops"],
            b["dmc"], b["db"], lib=b["lib"])
    o, m = res["other"], res["this"]
    rows5(o)()
    rows5(m)()
    torch.cuda.synchronize()
    r = dict(R=R, S=S, out=diff(o["out"], m["out"]), w=diff(o["w"], m["w"]),
             dmc=diff(o["dmc"], m["dmc"]), ops=diff(o["ops"], m["ops"]))
    r["fwd_other_ms"], r["fwd_this_ms"] = ab_time(fwd5(o), fwd5(m), rounds)
    r["rows_other_ms"], r["rows_this_ms"] = ab_time(rows5(o), rows5(m),
                                                    rounds)
    results["k5_coarse"] = r
    print(f"[ab] kernel 5 coarse R={R} S={S}: forward other "
          f"{r['fwd_other_ms']:.4f} ms, this {r['fwd_this_ms']:.4f} ms; row "
          f"pass other {r['rows_other_ms']:.4f}, this "
          f"{r['rows_this_ms']:.4f}; outputs "
          + json.dumps({k: r[k] for k in ("out", "w", "dmc", "ops")}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout (holds "
                         "pano_nerf_tpu_torch/csrc)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", choices=("all", "k4", "train"), default="all")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the card only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import CONFIG, build_kernels, card_line
    from pano_nerf_tpu_torch.core.config import load_config
    from pano_nerf_tpu_torch.core.rays import rays_to_tensors
    from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
    from pano_nerf_tpu_torch.models.pano_mip_nerf import PanoMipNeRF
    card = card_line()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    build_kernels()
    libs = build_other(args.other.resolve())
    print(f"[build] both trees in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device("cuda")
    hp = load_config(str(ROOT / CONFIG))
    model = PanoMipNeRF.from_hparams(
        hp, torch.Generator().manual_seed(0)).to(dev)
    env = rays_to_tensors(generate_lit_rays(hp["nerf.num_ray_samples"],
                                            far=10.0, radius=0.0142), dev)
    results = {}
    with torch.no_grad():
        if args.only in ("all", "k4"):
            kernel4(model, env, dev, libs, args.rounds, results)
        if args.only in ("all", "train"):
            train_kernels(model, env, dev, libs, args.rounds, results)
    print(f"[card] {card}")
    print(json.dumps(dict(card=card, results=results)))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
