"""Drive the PyTorch/CUDA port's render path once on one H100 and check it.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Build every CUDA kernel of the path from `pano_nerf_tpu_torch/csrc/`
   (one nvcc per source, all started together) and print the build time
   and the compiler's register/spill report.
2. Kernel vs plain version on the card at the main path's three shapes
   (full `configs/panonerf.yaml` width, bf16): the coarse level (1024 rays
   x 56 samples), the fine level with normals (1024 x 56) and the env
   rays (10240 x 5). Prints the max errors beside their tolerances and the
   per-launch times of kernel and plain version (CUDA events, warm-up
   excluded).
3. Main path: a 4-view 512x1024 synthetic scene, rendered at `val.factor`
   4 (128x256) by `python -m pano_nerf_tpu_torch.eval` (called in
   process) with weights from `--init_seed`. Launch counts are zeroed just
   before and read just after; every val panorama must take exactly 96
   kernel launches (32 chunks x 3 levels), no plain-version call, all 11
   products written and all metrics finite.
4. Where the time goes: one more render of the first val panorama under
   torch.profiler; prints the device's busy and idle share of the host
   wall time and the kernels that took the most device time.
5. A small render of the same scene on the card is held against the
   plain version on the CPU.

The last lines are the card (nvidia-smi name, power limit), one JSON
object with each kernel's numbers and `{"ok": true, "device": ...}`.
No JAX is imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet, 700 W)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
MLP_MACS = 611_328         # one NerfMLP row at full width
NORMAL_MACS = 507_904      # the fine level's density-gradient chain per row
CONFIG = "configs/panonerf.yaml"
TOL = dict(rgb=2e-2, distance=2e-2, acc=1e-2, weights=1e-2, albedo=2e-2,
           roughness=2e-2)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def build_kernels():
    """Start every source's nvcc together, then wait for all."""
    from pano_nerf_tpu_torch.kernels import build
    from pano_nerf_tpu_torch.kernels import fused_render
    sources = [fused_render.SOURCE]
    t0 = time.perf_counter()
    pending = [build.start_build(s) for s in sources]
    for p in pending:
        build.finish_build(p)
    print(f"[build] {len(sources)} source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, (log, secs) in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _main_path_inputs(model, env, dev, num_rays: int = 1024):
    """The three launch shapes of one chunk, built the way the model
    builds them (coarse march, resampled fine march, env march) from
    random primary rays inside a scene-sized box."""
    import torch
    from pano_nerf_tpu_torch.core.rays import Rays
    from pano_nerf_tpu_torch.kernels.fused_render import (
        fused_render_level_reference)
    from pano_nerf_tpu_torch.ops import mip
    g = torch.Generator().manual_seed(7)
    d = torch.randn(num_rays, 3, generator=g)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    ones = torch.ones(num_rays, 1)
    rays = Rays(origins=(torch.rand(num_rays, 3, generator=g) - 0.5) * 0.6,
                directions=d, viewdirs=d, radii=ones * 0.0142,
                lossmult=ones, near=ones * 0.0, far=ones * 10.0,
                noise_var=ones * 0.0)
    rays = Rays(*(x.to(dev).contiguous() for x in rays))
    cfg = model.cfg
    kw = dict(min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point,
              deg_view=cfg.deg_view, density_bias=cfg.density_bias,
              rgb_padding=cfg.rgb_padding, white_bkgd=False)
    shapes = {}
    t0, (m0, c0) = cfg.sample_level(rays, 0, None, None)
    shapes["coarse"] = ((m0.contiguous(), c0.contiguous(), rays.viewdirs,
                         t0.contiguous(), rays.directions),
                        dict(kw, need_normals=False, need_extras=False))
    r0 = fused_render_level_reference(model.mlp, *shapes["coarse"][0],
                                      **shapes["coarse"][1])
    t1, (m1, c1) = cfg.sample_level(rays, 1, t0, r0["weights"])
    shapes["fine"] = ((m1.contiguous(), c1.contiguous(), rays.viewdirs,
                       t1.contiguous(), rays.directions),
                      dict(kw, need_normals=True, need_extras=True))
    r1 = fused_render_level_reference(model.mlp, *shapes["fine"][0],
                                      **shapes["fine"][1])
    surf = rays.origins + rays.directions * r1["distance"][:, None]
    lt, (lm, lc), ld = mip.sample_env_rays(
        surf, env.directions, cfg.env_samples(), env.near, env.far,
        env.radii)
    B, D, S = lm.shape[:3]
    fd = ld.reshape(B * D, 3).contiguous()
    shapes["env"] = ((lm.reshape(B * D, S, 3).contiguous(),
                      lc.reshape(B * D, S, 3).contiguous(), fd,
                      lt.reshape(B * D, S + 1).contiguous(), fd),
                     dict(kw, need_normals=False, need_extras=False))
    return shapes


def _bound_ms(args, kw, packed) -> float:
    """Least time on the card: max(operations / bf16 peak, bytes / HBM)."""
    means, _, _, _, _ = args
    R, S = means.shape[:2]
    rows = R * S
    macs = MLP_MACS + (NORMAL_MACS if kw["need_normals"] else 0)
    flops = 2.0 * macs * rows
    in_bytes = rows * 8 * 4 + R * 8 * 4 + sum(
        t.numel() * t.element_size() for t in packed)
    out_bytes = R * (17 + S) * 4
    return 1e3 * max(flops / PEAK_BF16_FLOPS,
                     (in_bytes + out_bytes) / PEAK_BYTES)


def check_kernels(model, env, dev) -> dict:
    """Kernel vs plain version at the main path's shapes; raises on a
    disagreement. Returns the kernel's JSON entry."""
    import torch
    from pano_nerf_tpu_torch.kernels import fused_render as fr
    shapes = _main_path_inputs(model, env, dev)
    packed = fr.pack_params(model.mlp)
    entry = dict(name="fused_render_level", route="cuda",
                 source="pano_nerf_tpu_torch/csrc/fused_render.cu",
                 replaces="pano_nerf_tpu/kernels/fused_render.py:248",
                 launches=None, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                 bound_ms=0.0, bound_by="operations", library_ms=None,
                 per_shape={})
    failures = []
    for name, (args, kw) in shapes.items():
        got = fr.fused_render_level(model.mlp, *args, packed=packed, **kw)
        want = fr.fused_render_level_reference(model.mlp, *args, **kw)
        torch.cuda.synchronize()
        errs = {}
        for k, tol in TOL.items():
            if want[k] is None:
                continue
            err = float((got[k] - want[k]).abs().max())
            errs[k] = err
            if not err <= tol:
                failures.append(f"{name}.{k}: {err:.3e} > {tol}")
        if want["normal"] is not None:
            cos = torch.sum(got["normal"] * want["normal"], -1)
            errs["normal_cos_median"] = float(cos.median())
            errs["normal_cos_min"] = float(cos.min())
            if not (errs["normal_cos_median"] > 0.998
                    and errs["normal_cos_min"] > 0.85):
                failures.append(f"{name}.normal cos median "
                                f"{errs['normal_cos_median']:.5f} min "
                                f"{errs['normal_cos_min']:.5f}")
        ms = _time_ms(lambda: fr.fused_render_level(
            model.mlp, *args, packed=packed, **kw), reps=20)
        plain_ms = _time_ms(lambda: fr.fused_render_level_reference(
            model.mlp, *args, **kw), reps=5)
        bound = _bound_ms(args, kw, packed)
        R, S = args[0].shape[:2]
        print(f"[kernel] {name:6s} R={R} S={S}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms; errors "
              + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + "; tolerances " + json.dumps(TOL))
        entry["per_shape"][name] = dict(R=R, S=S, ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound, errors=errs)
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms
        entry["bound_ms"] += bound
        entry["max_abs_err"] = max(entry["max_abs_err"], max(
            v for k, v in errs.items() if not k.startswith("normal")))
    if failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return entry


def drive_main_path(workdir: str) -> dict:
    """Render every val panorama through the eval entry point; returns
    the eval metrics and the launch count of the run."""
    from pano_nerf_tpu_torch import eval as eval_entry
    from pano_nerf_tpu_torch.data.synthetic import generate_scene
    from pano_nerf_tpu_torch.engine.validation import PRODUCTS
    from pano_nerf_tpu_torch.kernels import fused_render as fr
    scene = os.path.join(workdir, "scene")
    t0 = time.perf_counter()
    generate_scene(scene, n_views=4, height=512, width=1024, seed=0)
    print(f"[main] scene 4 x 512x1024 written in "
          f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(workdir, "eval")
    argv = ["--data_path", scene, "--out_dir", out, "--init_seed", "0",
            "--config", CONFIG, "train.sample_num", "'n0_1'"]

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on the main path")

    plain = fr.fused_render_level_reference
    fr.fused_render_level_reference = no_plain
    fr.fused_render_level.launches = 0
    try:
        metrics = eval_entry.main(argv)
    finally:
        launches = fr.fused_render_level.launches
        fr.fused_render_level_reference = plain
    n = metrics["num_images"]
    if n < 1:
        raise AssertionError("no val panorama was rendered")
    if launches != 96 * n:
        raise AssertionError(f"{launches} kernel launches for {n} "
                             f"panoramas, expected {96 * n}")
    for k, v in metrics.items():
        if isinstance(v, float) and v != v:
            raise AssertionError(f"metric {k} is NaN")
    tree = os.path.join(out, "eval_000000")
    for p in PRODUCTS:
        files = os.listdir(os.path.join(tree, p))
        if len(files) != n:
            raise AssertionError(f"{p}: {len(files)} files for {n} images")
    print(f"[main] {n} panoramas of 128x256: {launches} kernel launches, "
          f"{metrics['render_ms_per_pano']:.1f} ms per panorama, "
          f"{metrics['rays_per_s']:.0f} rays/s on {metrics['device']}")
    return dict(metrics=metrics, launches=launches, scene=scene)


def where_the_time_goes(scene: str) -> None:
    """Profile one more render of the first val panorama (torch.profiler,
    CPU + CUDA) and print the device's busy and idle share of the render's
    host wall time and the kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pano_nerf_tpu_torch.core.config import load_config
    from pano_nerf_tpu_torch.data.pano_dataset import PanoDataset
    from pano_nerf_tpu_torch.engine import validation as V
    from pano_nerf_tpu_torch.engine.system import PanoNeRFSystem
    hp = load_config(CONFIG)
    ds = PanoDataset(scene, split="val", factor=hp["val.factor"], num=[0, 1])
    system = PanoNeRFSystem(hp, device="cuda", init_seed=0)
    system.set_env_rays(ds.generate_lit_rays(
        num=hp["nerf.num_ray_samples"], near=0.0, far=10.0))
    render_fn = system.make_render_image()
    dev = torch.device("cuda")
    rays = ds[0][0]
    V.render_full_pano(render_fn, None, rays, ds.h, ds.w, dev)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        V.render_full_pano(render_fn, None, rays, ds.h, ds.w, dev)
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("[time] the profiler recorded no device events: device busy "
              "share not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print(f"[time] one {ds.h}x{ds.w} panorama: host wall {wall_us / 1e3:.3f}"
          f" ms, device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}"
          f"%), idle {100 * (1 - busy / wall_us):.1f}%, {len(kernels)} "
          f"device events")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[time]   {t / 1e3:9.3f} ms  {n:5d} x  {name[:90]}")


def check_against_plain(scene: str) -> None:
    """A 16x32 view of the scene rendered on the card (kernel) and on the
    CPU (plain version) with the same weights must agree."""
    import numpy as np
    import torch
    from pano_nerf_tpu_torch.core.config import load_config
    from pano_nerf_tpu_torch.data.pano_dataset import PanoDataset
    from pano_nerf_tpu_torch.engine import validation as V
    from pano_nerf_tpu_torch.engine.system import PanoNeRFSystem
    hp = load_config(CONFIG)
    ds = PanoDataset(scene, split="val", factor=32, num=[0, 1])
    out = {}
    for dev in ("cuda", "cpu"):
        system = PanoNeRFSystem(hp, device=dev, init_seed=0)
        system.set_env_rays(ds.generate_lit_rays(
            num=hp["nerf.num_ray_samples"], near=0.0, far=10.0))
        out[dev] = V.render_full_pano(system.make_render_image(), None,
                                      ds[0][0], ds.h, ds.w,
                                      torch.device(dev))
    for k in ("rgb_fine", "dep_fine", "rgb_coarse", "dep_coarse",
              "albedo", "roughness"):
        err = float(np.abs(out["cuda"][k] - out["cpu"][k]).max())
        print(f"[check] {k}: kernel vs plain max abs err {err:.3e}")
        if not err <= 5e-2:
            raise AssertionError(f"{k}: kernel render differs from the "
                                 f"plain render by {err}")
    cos = np.sum(out["cuda"]["normal"] * out["cpu"]["normal"], -1)
    print(f"[check] normal cos median {np.median(cos):.5f}")
    if not np.median(cos) > 0.99:
        raise AssertionError("normals of kernel and plain render disagree")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "pano_nerf_tpu_torch", "csrc")):
        print("pano_nerf_tpu_torch not found beside chip_smoke.py: run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}")
    build_kernels()

    from pano_nerf_tpu_torch.core.config import load_config
    from pano_nerf_tpu_torch.core.rays import rays_to_tensors
    from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
    from pano_nerf_tpu_torch.models.pano_mip_nerf import PanoMipNeRF
    dev = torch.device("cuda")
    hp = load_config(CONFIG)
    model = PanoMipNeRF.from_hparams(
        hp, torch.Generator().manual_seed(0)).to(dev)
    env = rays_to_tensors(generate_lit_rays(hp["nerf.num_ray_samples"],
                                            far=10.0, radius=0.0142), dev)
    with torch.no_grad():
        entry = check_kernels(model, env, dev)
    with tempfile.TemporaryDirectory() as workdir:
        run = drive_main_path(workdir)
        where_the_time_goes(run["scene"])
        check_against_plain(run["scene"])
    entry["launches"] = run["launches"]
    print(f"[card] {card}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
