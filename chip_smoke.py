"""Drive the PyTorch/CUDA port's render and train paths on one H100.

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Build every CUDA source of the port from `pano_nerf_tpu_torch/csrc/`
   (one nvcc per source, all started together) and print the build time
   and the compiler's register/spill report.
2. Kernels vs plain versions on the card, full `configs/panonerf.yaml`
   width, bf16: kernel 4 (`fused_render_level`) at the eval path's three
   shapes (coarse 1024 rays x 56, fine with normals 1024 x 56, env
   10240 x 5), and kernels 2 and 3 (`fused_mlp_ipe`, `fused_mlp_normals`),
   forward and backward, at the four calls of one train step at batch 512
   (coarse 28,672 rows, fine 28,672, view consistency 28,672, env 25,600).
   Prints the errors beside their tolerances, per-launch times of kernel
   and plain version (CUDA events, warm-up excluded) and the bound.
3. Eval main path: a 4-view 512x1024 synthetic scene, rendered at
   `val.factor` 4 (128x256) by `python -m pano_nerf_tpu_torch.eval` (in
   process) with weights from `--init_seed`: 96 kernel-4 launches per val
   panorama, no plain-version call, all 11 products, finite metrics; then
   one panorama under torch.profiler (device busy/idle share, top kernels)
   and a small render held against the plain version on the CPU.
4. Train main path: `python -m pano_nerf_tpu_torch.train` (in process),
   200 steps of the shipped config on the same scene (3 train views, 1 val
   view, `train.factor` 4). Launch counts are zeroed just before and read
   just after: 3 + 6 launches of kernel 2 (forward; backward row pass and
   weight-gradient pass) and 1 + 2 of kernel 3 per step, the validations
   through kernel 4, no plain-version call; every loss finite, the mean of
   the last 20 losses below that of the first 20. Prints train rays/s and
   ms per step.
5. One train step on the card against the same step on the CPU (plain
   versions), from the same parameters, batch and numpy-made draws: loss
   parts, and gradients as `check_train_step_against_cpu` says.
6. Where the time goes in training: three steps under torch.profiler.

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
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe, fused_render
    sources = [fused_render.SOURCE, fused_mlp_ipe.SOURCE]
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
    _report_profile(prof, wall_us, f"one {ds.h}x{ds.w} panorama")


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


# ---- kernels 2 and 3 (training) -------------------------------------------

TRAIN_TOL = dict(out_abs=2e-2, dsig_rel=0.08, grad_rel_k2=2e-2,
                 grad_rel_k3=5e-2, dmc_rel=5e-2)
# MACs per row. Kernel 2 backward: recompute + data + weight gradients;
# kernel 3 backward: the MLP's data and weight gradients, the chain's
# recompute, walk and walk weight gradients, and the heads' recompute.
HEADS_MACS = 65_536 + 36_224   # bottleneck + view layer
K2_MACS = dict(fwd=MLP_MACS, bwd=3 * MLP_MACS)
K3_MACS = dict(fwd=MLP_MACS + NORMAL_MACS,
               bwd=2 * MLP_MACS + 3 * NORMAL_MACS + HEADS_MACS)


def _train_shapes(model, env, dev, batch: int = 512):
    """The four kernel calls of one train step at full width, built the
    way the model builds them (random draws, plain version for the
    weights that place the fine samples): name -> (normals?, means, covs,
    v_enc)."""
    import torch
    from pano_nerf_tpu_torch.core.rays import Rays
    from pano_nerf_tpu_torch.kernels.fused_mlp_ipe import (
        fused_mlp_ipe_reference)
    from pano_nerf_tpu_torch.ops import mip
    cfg = model.cfg
    g = torch.Generator().manual_seed(11)
    d = torch.randn(batch, 3, generator=g)
    ones = torch.ones(batch, 1)
    rays = Rays(origins=(torch.rand(batch, 3, generator=g) - 0.5) * 0.6,
                directions=d, viewdirs=d / torch.linalg.norm(d, dim=-1,
                                                             keepdim=True),
                radii=ones * 0.0142, lossmult=ones, near=ones * 0.0,
                far=ones * 10.0, noise_var=ones * 0.0)
    rays = Rays(*(x.to(dev).contiguous() for x in rays))
    gd = torch.Generator(device=dev).manual_seed(12)
    draws = model.make_draws(batch, env.directions.shape[0], gd)

    def venc(x):
        return mip.pos_enc(x, 0, cfg.deg_view, True)[..., None, :]

    kw = dict(min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point)
    with torch.no_grad():
        t0, (m0, c0) = mip.sample_along_rays(
            rays.origins, rays.directions, rays.radii,
            cfg.train_coarse_samples(), rays.near, rays.far,
            t_rand=draws.t_coarse)
        v = venc(rays.viewdirs)
        raw_rgb, raw_den = fused_mlp_ipe_reference(model.mlp, m0, c0, v, **kw)
        _, _, _, w0 = mip.volumetric_rendering(
            model._rgb(raw_rgb), model._density(raw_den[..., :1]), t0,
            rays.directions, False)
        t1, (m1, c1) = mip.resample_along_rays(
            rays.origins, rays.directions, rays.radii, t0, w0,
            cfg.resample_padding, num_samples=cfg.num_samples,
            u_rand=draws.u_fine)
        raw_rgb, raw_den = fused_mlp_ipe_reference(model.mlp, m1, c1, v, **kw)
        _, dist, _, _ = mip.volumetric_rendering(
            model._rgb(raw_rgb), model._density(raw_den[..., :1]), t1,
            rays.directions, False)
        surf = rays.origins + rays.directions * dist[:, None]
        lt, (lm, lc), ld = mip.sample_env_rays(
            surf, env.directions, cfg.num_env_samples, env.near, env.far,
            env.radii, t_rand=draws.t_env)
        d_alt = mip.safe_normalize(draws.d_alt)
    return {"coarse": (False, m0, c0, v), "fine": (True, m1, c1, v),
            "vc": (False, m1, c1, venc(d_alt)),
            "env": (False, lm.contiguous(), lc.contiguous(), venc(ld))}


def _outs_and_grads(fn, mlp, means, covs, v_enc, **kw):
    """Outputs and the gradients of a loss on every output (a mean over
    the rows, so the gradients are O(1)), w.r.t. the parameters (flat) and
    the means."""
    import torch
    mlp.zero_grad(set_to_none=True)
    m = means.detach().clone().requires_grad_(True)
    outs = fn(mlp, m, covs, v_enc, **kw)
    loss = torch.sin(outs[0]).sum() + torch.cos(outs[1]).sum()
    if len(outs) == 3:
        loss = loss + torch.sin(0.1 * outs[2]).sum()
    (loss / outs[0][..., 0].numel()).backward()
    flat = torch.cat([p.grad.reshape(-1) for p in mlp.parameters()])
    mlp.zero_grad(set_to_none=True)
    return [o.detach() for o in outs], flat, m.grad


def _rel(a, b) -> float:
    import torch
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _train_bound_ms(normals: bool, direction: str, rows: int,
                    packed) -> float:
    """max(operations / bf16 peak, bytes / HBM): inputs read once and
    outputs written once."""
    macs = (K3_MACS if normals else K2_MACS)[direction]
    w_bytes = sum(t.numel() * t.element_size() for t in packed)
    acts = 8 * 256 * 2 if normals else 0
    if direction == "fwd":
        row_bytes = 32 + 64 + 64 + (12 + acts if normals else 0)
        bytes_ = rows * row_bytes + w_bytes
    else:   # mc, v, cotangents (+ acts) in; d mc and f32 grads out
        row_bytes = 32 + 64 + 64 + 32 + (12 + acts if normals else 0)
        bytes_ = rows * row_bytes + w_bytes + 4 * sum(
            t.numel() for t in packed)
    return 1e3 * max(2.0 * macs * rows / PEAK_BF16_FLOPS,
                     bytes_ / PEAK_BYTES)


def check_train_kernels(model, env, dev) -> list:
    """Kernels 2 and 3 (forward and backward) vs their plain versions at
    the shapes of one train step; raises on a disagreement. Returns the
    four JSON entries (launches filled in by the train run)."""
    import types
    import torch
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    from pano_nerf_tpu_torch.kernels.fused_render import pack_params
    mlp, cfg = model.mlp, model.cfg
    kw = dict(min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point)
    packed = pack_params(mlp)
    lib = k2.kernel_library()
    entries = {}
    for name, src_line in (
            ("fused_mlp_ipe_fwd", "fused_mlp_ipe.py:211"),
            ("fused_mlp_ipe_bwd", "fused_mlp_ipe.py:237"),
            ("fused_mlp_normals_fwd", "fused_mlp_normals.py:304"),
            ("fused_mlp_normals_bwd", "fused_mlp_normals.py:331")):
        entries[name] = dict(
            name=name, route="cuda",
            source="pano_nerf_tpu_torch/csrc/fused_mlp.cu",
            replaces=f"pano_nerf_tpu/kernels/{src_line}", launches=None,
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            bound_by="operations", library_ms=None, per_shape={})
    failures = []
    for shape, (normals, means, covs, v_enc) in _train_shapes(
            model, env, dev).items():
        kern = k3.fused_mlp_normals_apply if normals else k2.fused_mlp_ipe_apply
        plain = (k3.fused_mlp_normals_reference if normals
                 else k2.fused_mlp_ipe_reference)
        got, g_got, m_got = _outs_and_grads(kern, mlp, means, covs, v_enc,
                                            packed=packed, **kw)
        want, g_want, m_want = _outs_and_grads(plain, mlp, means, covs,
                                               v_enc, **kw)
        torch.cuda.synchronize()
        out_err = max(float((a - b).abs().max())
                      for a, b in zip(got[:2], want[:2]))
        errs = dict(out_abs=out_err, grad_rel=_rel(g_got, g_want),
                    grad_abs=float((g_got - g_want).abs().max()),
                    dmc_rel=_rel(m_got, m_want))
        if normals:
            errs["dsig_rel"] = _rel(got[2], want[2])
        grad_tol = TRAIN_TOL["grad_rel_k3" if normals else "grad_rel_k2"]
        checks = [("out_abs", TRAIN_TOL["out_abs"]), ("grad_rel", grad_tol),
                  ("dmc_rel", TRAIN_TOL["dmc_rel"])]
        if normals:
            checks.append(("dsig_rel", TRAIN_TOL["dsig_rel"]))
        for k, tol in checks:
            if not errs[k] <= tol:
                failures.append(f"{shape}.{k}: {errs[k]:.3e} > {tol}")

        # Timing: forward launches (saving the activations where training
        # does), the backward's two launches on the saved inputs, and the
        # plain version's forward and autograd backward.
        lead = tuple(means.shape[:-1])
        mc, v = k2.rows_of(means, covs, v_enc, lead)
        M = mc.shape[0]
        out = torch.empty((M, 16), device=dev)
        dsig = torch.empty((M, 3), device=dev)
        acts = (torch.empty((M, 2048), dtype=torch.bfloat16, device=dev)
                if normals else None)
        stream = torch.cuda.current_stream().cuda_stream

        def fwd():
            k2.check_launch(lib, "forward", lib.fused_mlp_forward(
                mc.data_ptr(), v.data_ptr(), packed[0].data_ptr(),
                packed[1].data_ptr(), out.data_ptr(),
                dsig.data_ptr() if normals else None,
                acts.data_ptr() if normals else None, M, cfg.min_deg_point,
                int(normals), stream))

        g = torch.randn(M, 16, device=dev)
        q = torch.randn(M, 3, device=dev) if normals else None
        dummy = types.SimpleNamespace(backward_launches=0)

        def bwd():
            k2.run_backward(lib, dummy, mlp, mc, v, packed[0], packed[1], g,
                            q, acts, cfg.min_deg_point, normals)

        ms_f = _time_ms(fwd, reps=20)
        ms_b = _time_ms(bwd, reps=10)
        with torch.no_grad():
            plain_f = _time_ms(lambda: plain(mlp, means, covs, v_enc, **kw),
                               reps=3)
        m_req = means.detach().clone().requires_grad_(True)
        p_outs = plain(mlp, m_req, covs, v_enc, **kw)
        cot = [torch.randn_like(o) for o in p_outs]
        params = list(mlp.parameters()) + [m_req]
        plain_b = _time_ms(lambda: torch.autograd.grad(
            p_outs, params, cot, retain_graph=True), reps=3)
        del p_outs
        base = "fused_mlp_normals" if normals else "fused_mlp_ipe"
        for direction, ms, pms in (("fwd", ms_f, plain_f),
                                   ("bwd", ms_b, plain_b)):
            e = entries[f"{base}_{direction}"]
            bound = _train_bound_ms(normals, direction, M, packed)
            e["per_shape"][shape] = dict(rows=M, ms=ms, plain_ms=pms,
                                         bound_ms=bound, errors=errs)
            e["ms"] += ms
            e["plain_ms"] += pms
            e["bound_ms"] += bound
            e["max_abs_err"] = max(e["max_abs_err"], errs[
                "out_abs" if direction == "fwd" else "grad_abs"])
        print(f"[kernel] {shape:6s} M={M} {'k3' if normals else 'k2'}: fwd "
              f"{ms_f:.3f} ms (plain {plain_f:.3f}, bound "
              f"{_train_bound_ms(normals, 'fwd', M, packed):.4f}), bwd "
              f"{ms_b:.3f} ms (plain {plain_b:.3f}, bound "
              f"{_train_bound_ms(normals, 'bwd', M, packed):.4f}); errors "
              + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + "; tolerances " + json.dumps(TRAIN_TOL), flush=True)
    if failures:
        raise AssertionError("training kernel disagrees with its plain "
                             "version: " + "; ".join(failures))
    return list(entries.values())


TRAIN_STEPS = 200


def drive_train_path(workdir: str, scene: str) -> dict:
    """Train 200 steps of the shipped config through the train entry point
    (3 train views, 1 val view at train.factor 4); launch counts zeroed
    just before and read just after, plain versions forbidden."""
    import torch
    from pano_nerf_tpu_torch import train as train_entry
    from pano_nerf_tpu_torch.engine.system import PanoNeRFSystem
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    from pano_nerf_tpu_torch.kernels import fused_render as fr
    out = os.path.join(workdir, "train")
    argv = ["--data_path", scene, "--out_dir", out, "--config", CONFIG,
            "--init_seed", "0", "train.sample_num", "'n0_1_2'",
            "optimizer.max_steps", str(TRAIN_STEPS), "log_every_n_step", "50"]
    losses = []
    make = PanoNeRFSystem.make_train_step

    def recording(self, enable_surf):
        step = make(self, enable_surf)

        def wrapped(*a):
            parts = step(*a)
            losses.append(parts["loss"])
            return parts
        return wrapped

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on the main path")

    saved = [(m, n, getattr(m, n)) for m, n in (
        (k2, "fused_mlp_ipe_reference"), (k3, "fused_mlp_normals_reference"),
        (fr, "fused_render_level_reference"))]
    counters = (k2.fused_mlp_ipe_apply, k3.fused_mlp_normals_apply)
    for m, n, _ in saved:
        setattr(m, n, no_plain)
    PanoNeRFSystem.make_train_step = recording
    for c in counters:
        c.launches = c.backward_launches = 0
    fr.fused_render_level.launches = 0
    t0 = time.perf_counter()
    try:
        trainer = train_entry.main(argv)
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        launches = dict(
            fused_mlp_ipe_fwd=k2.fused_mlp_ipe_apply.launches,
            fused_mlp_ipe_bwd=k2.fused_mlp_ipe_apply.backward_launches,
            fused_mlp_normals_fwd=k3.fused_mlp_normals_apply.launches,
            fused_mlp_normals_bwd=k3.fused_mlp_normals_apply.backward_launches,
            fused_render_level=fr.fused_render_level.launches)
        PanoNeRFSystem.make_train_step = make
        for m, n, f in saved:
            setattr(m, n, f)
    vals = [float(x) for x in torch.stack(losses).cpu()]
    if len(vals) != TRAIN_STEPS:
        raise AssertionError(f"{len(vals)} steps ran, expected {TRAIN_STEPS}")
    bad = [i for i, x in enumerate(vals) if not x == x or abs(x) == float("inf")]
    if bad:
        raise AssertionError(f"non-finite loss at steps {bad[:10]}")
    first, last = sum(vals[:20]) / 20, sum(vals[-20:]) / 20
    print(f"[train] mean loss of steps 1-20 {first:.6f}, of steps "
          f"{TRAIN_STEPS - 19}-{TRAIN_STEPS} {last:.6f}")
    if not last < first:
        raise AssertionError("the loss did not fall over 200 steps")
    want = dict(fused_mlp_ipe_fwd=3 * TRAIN_STEPS,
                fused_mlp_ipe_bwd=6 * TRAIN_STEPS,
                fused_mlp_normals_fwd=TRAIN_STEPS,
                fused_mlp_normals_bwd=2 * TRAIN_STEPS)
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{k}: {launches[k]} launches in "
                                 f"{TRAIN_STEPS} steps, expected {n}")
    if launches["fused_render_level"] < 96:
        raise AssertionError("the final validation did not run through "
                             "fused_render_level")
    save_dir = trainer.hparams["save_dir"]
    with open(os.path.join(save_dir, "metrics.jsonl")) as fp:
        recs = [json.loads(line) for line in fp]
    train_recs = [r for r in recs if r["kind"] == "train"]
    vals_recs = [r for r in recs if r["kind"] == "val"]
    if [r["step"] for r in vals_recs] != [0, TRAIN_STEPS]:
        raise AssertionError(f"validations at {[r['step'] for r in vals_recs]}")
    rps = [r["rays_per_sec"] for r in train_recs]
    batch = int(trainer.hparams["train.batch_size"])
    # The first window includes the kernels' first launches; report the
    # later ones.
    steady = rps[1:] if len(rps) > 1 else rps
    mean_rps = sum(steady) / len(steady)
    print(f"[train] {TRAIN_STEPS} steps of batch {batch} on "
          f"{trainer.train_dataset.num_rays:,} rays ({wall:.1f} s with "
          f"validation): train rays/s per 50-step window "
          + ", ".join(f"{x:.1f}" for x in rps)
          + f"; steady {mean_rps:.1f} rays/s = {1e3 * batch / mean_rps:.3f} "
          f"ms per step; launches " + json.dumps(launches)
          + f"; final val psnr_ldr_vol {vals_recs[-1]['psnr_ldr_vol']:.3f}",
          flush=True)
    return dict(launches=launches, trainer=trainer, rays_per_s=mean_rps)


def _one_step(hp, dev, state_dict, ds, idx, draws_np) -> tuple:
    """One train step (clip off) on `dev`; returns (loss parts, flat
    gradient on the CPU)."""
    import numpy as np
    import torch
    from pano_nerf_tpu_torch.core.rays import Rays
    from pano_nerf_tpu_torch.engine.system import PanoNeRFSystem
    from pano_nerf_tpu_torch.models.pano_mip_nerf import TrainDraws
    system = PanoNeRFSystem(dict(hp, **{"optimizer.grad_clip": 0.0}),
                            device=dev)
    system.model.mlp.load_state_dict(state_dict)
    D = int(hp["nerf.num_ray_samples"])
    system.set_env_rays(ds.generate_lit_rays(num=D, near=0.0, far=10.0))
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    rays = Rays(*(T(getattr(ds.rays, k)[idx]) for k in Rays._fields))
    parts = system.make_train_step(True)(
        system.create_state(), rays, T(ds.images[idx]),
        TrainDraws(*(T(x) for x in draws_np)))
    grads = torch.cat([p.grad.reshape(-1).cpu() for p in
                       system.model.mlp.parameters()])
    return {k: float(v) for k, v in parts.items()}, grads


def check_train_step_against_cpu(trainer, num_rays: int = 64) -> None:
    """One train step on the card (kernels) and on the CPU (plain
    versions) from the same parameters, batch and numpy-made draws.

    Loss parts must agree within 5e-2. The gradient of the shipped loss is
    ill-conditioned in bf16: the orientation and surface terms normalize
    per-sample density gradients, some of them tiny, so rounding moves it
    by tens of percent whichever device computes it (the plain bf16
    version on the CPU differs from the f32 one as much). So it is held
    two ways: (a) the card's gradient of the shipped loss must track the
    f32 gradient at least as well as the CPU's bf16 gradient does (within
    1.5x, as the JAX kernel tests hold their kernels), and (b) without the
    two normal-dependent terms the card's and the CPU's bf16 gradients
    must agree at rel-norm 5e-2."""
    import numpy as np
    from pano_nerf_tpu_torch.models.pano_mip_nerf import TrainDraws
    hp = trainer.hparams
    cfg = trainer.system.model.cfg
    ds = trainer.train_dataset
    rng = np.random.default_rng(5)
    idx = rng.integers(0, ds.num_rays, num_rays)
    D = int(hp["nerf.num_ray_samples"])
    draws_np = TrainDraws(
        t_coarse=rng.random((num_rays, cfg.train_coarse_samples() + 1)),
        u_fine=rng.random((num_rays, cfg.num_samples + 1)),
        t_env=rng.random((num_rays, D, cfg.num_env_samples + 1)),
        d_alt=rng.normal(size=(num_rays, 3)))
    sd = {k: v.detach().cpu().clone() for k, v in
          trainer.system.model.mlp.state_dict().items()}
    args = (sd, ds, idx, draws_np)
    card = _one_step(hp, "cuda", *args)
    cpu = _one_step(hp, "cpu", *args)
    f32 = _one_step(dict(hp, **{"train.precision": "f32"}), "cpu", *args)
    failures = []
    for k, want in cpu[0].items():
        got = card[0][k]
        err = abs(got - want) / max(abs(want), 1e-12)
        print(f"[check] train step {k}: card {got:.6e} cpu {want:.6e} "
              f"(f32 {f32[0][k]:.6e}) rel {err:.3e}")
        if not (err <= 5e-2 or abs(got - want) <= 1e-9):
            failures.append(k)
    e_card, e_cpu = _rel(card[1], f32[1]), _rel(cpu[1], f32[1])
    print(f"[check] train step gradients vs f32: card {e_card:.3e}, cpu "
          f"bf16 {e_cpu:.3e} (card must be <= 1.5x cpu); card vs cpu "
          f"{_rel(card[1], cpu[1]):.3e}")
    if not e_card <= 1.5 * e_cpu:
        failures.append("grads vs f32")
    hp_plain = dict(hp, **{"loss.ort_loss": 0.0, "loss.surface_loss": 0.0})
    card_p, cpu_p = (_one_step(hp_plain, dev, *args) for dev in ("cuda",
                                                                 "cpu"))
    e = _rel(card_p[1], cpu_p[1])
    print(f"[check] train step gradients without the orientation and "
          f"surface terms: card vs cpu rel-norm {e:.3e} (tolerance 5e-2)")
    if not e <= 5e-2:
        failures.append("grads without normal terms")
    if failures:
        raise AssertionError(f"train step on the card differs from the CPU "
                             f"in {failures}")


def profile_train_step(trainer, steps: int = 3) -> None:
    """torch.profiler over `steps` train steps of the trained system: the
    device's busy and idle share of the host wall time and the top device
    ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pano_nerf_tpu_torch.core.rays import rays_map, rays_to_tensors
    system = trainer.system
    hp = trainer.hparams
    dev = system.device
    ds = trainer.train_dataset
    rays_all = rays_to_tensors(ds.rays, dev)
    rgbs_all = torch.as_tensor(ds.images).to(dev)
    batch, D = int(hp["train.batch_size"]), int(hp["nerf.num_ray_samples"])
    gen = torch.Generator(device=dev).manual_seed(3)
    state = system.create_state()
    step_fn = system.make_train_step(True)

    def one():
        idx = torch.randint(0, ds.num_rays, (batch,), generator=gen,
                            device=dev)
        step_fn(state, rays_map(lambda x: x[idx], rays_all), rgbs_all[idx],
                system.model.make_draws(batch, D, gen))

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    _report_profile(prof, wall_us, f"{steps} train steps")


def _report_profile(prof, wall_us: float, what: str) -> None:
    import torch
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
    print(f"[time] {what}: host wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), idle "
          f"{100 * (1 - busy / wall_us):.1f}%, {len(kernels)} device events")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"[time]   {t / 1e3:9.3f} ms  {n:5d} x  {name[:90]}")



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
    print(f"[card] {card}", flush=True)
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
    train_entries = check_train_kernels(model, env, dev)
    with tempfile.TemporaryDirectory() as workdir:
        run = drive_main_path(workdir)
        where_the_time_goes(run["scene"])
        check_against_plain(run["scene"])
        train = drive_train_path(workdir, run["scene"])
        check_train_step_against_cpu(train["trainer"])
        profile_train_step(train["trainer"])
    entry["launches"] = run["launches"]
    for e in train_entries:
        e["launches"] = train["launches"][e["name"]]
    print(f"[card] {card}")
    print(json.dumps({"kernels": [entry] + train_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
