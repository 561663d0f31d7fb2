"""Drive the PyTorch/CUDA port's render and train paths on one H100:
Pano-NeRF (`configs/panonerf.yaml`), its HDR presets
(`configs/panonerf_hdr.yaml`, `configs/panonerf_shadow.yaml`), the
mip-NeRF baseline (`configs/mipnerf.yaml`), the novel-view path, the
plain route (f32, another MLP topology, the heads), the last loss
terms, the level loop with the last model and system keys, the kernel route
at other MLP widths and encodings, every trunk width up to 256 and view
width up to 128 padded into those builds, the library modules
(reference checkpoints, the native EXR decoder, perspective datasets,
the 360 ops), the 512 / 256 builds (trunk 257..512, view branch
129..256) and the 1,024 builds (trunk 513..1,024, view branch 257..512,
each tile on a cluster of two CTAs).

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over;
before a non-zero exit one line `[fail] <phase>: <check> <value> >
<bound>`, or the failure's message where a check gives no value):

1. Build every CUDA library of the port from `pano_nerf_tpu_torch/csrc/`
   (one nvcc per source at the shipped shape, `fused_mlp.cu` also at one
   density channel, and each source a model of `OTHER_SHAPES`, D / Dm
   of `WIDE_SHAPES` or E / Em of `PAIR_SHAPES` runs at that shape: 25
   libraries, all started together and all awaited) and print each
   build's seconds and the compiler's register/spill report.
2. Kernels vs plain versions on the card, full `configs/panonerf.yaml`
   width, bf16: kernel 4 (`fused_render_level`) at the eval path's three
   shapes (coarse 1024 rays x 56, fine with normals 1024 x 56, env
   10240 x 5); kernels 2 and 3 (`fused_mlp_ipe`, `fused_mlp_normals`),
   forward and backward, at the four calls of one train step at batch 512
   (coarse 28,672 rows, fine 28,672, view consistency 28,672, env 25,600);
   kernel 5 (`fused_render_train`), forward and backward with `save_acts`
   off and on, at the levels it renders with the key on (coarse 512 x 56,
   env 5,120 x 5), the spilled and recomputed runs equal; and kernel 1
   (`fused_mlp_apply`) on the coarse level's 28,672 encoded rows. Every
   backward is also timed as its two passes: the row pass alone, then the
   weight-gradient pass on the operand rows that row pass wrote, held
   against `weight_grads_reference` on the same rows (rel-norm 1e-4 per
   weight) and timed beside torch.matmul on the same products (the
   yardstick, `library_ms`; the port never calls it), each pass beside
   its own bound. The gradients of kernels 2, 3 and 5 are held w.r.t.
   the parameters, the means and the covariances (`dcov_rel`: they carry
   one with `nerf.stop_resample_grad: false`), kernel 5's under a loss
   on its weights too. Prints the errors beside their tolerances, per-launch
   times of kernel and plain version (CUDA events, warm-up excluded) and
   the bounds.
3. Eval main path: a 4-view 512x1024 synthetic scene, rendered at
   `val.factor` 4 (128x256) by `python -m pano_nerf_tpu_torch.eval` (in
   process) with weights from `--init_seed`: each 1,024-ray chunk one
   replay of the chunk's CUDA graph, 96 kernel-4 launches per val
   panorama (plus the capture's eager warm-up chunks, counted apart), no
   plain-version call, all 11 products, finite metrics; then the first
   panorama through the graph held against the eager chunks (f32 atol
   1e-4), ms per panorama of both in turns, one of each under
   torch.profiler (device busy/idle share, top kernels), and a small
   render held against the plain version on the CPU.
4. Train main path: `python -m pano_nerf_tpu_torch.train` (in process),
   200 steps of the shipped config on the same scene (3 train views, 1 val
   view, `train.factor` 4), `train.steps_per_call` 8: groups of 8 steps
   and single steps at the log edges, each dispatch one CUDA graph
   replay. Launch counts are zeroed just before and read just after: 3 +
   6 launches of kernel 2 (forward; backward row pass and weight-gradient
   pass) and 1 + 2 of kernel 3 per step (4 of them the weight-gradient
   pass, counted also on its own), plus the captures' eager warm-up
   steps, the validations through kernel 4, no plain-version call; every
   step's loss finite, the mean of the last 20 losses below that of the
   first 20. Prints train rays/s and ms per step.
4b. The same with `nerf.use_train_render_kernel true`: per step 2 + 4
   launches of kernel 5 (coarse and env), 1 + 2 of kernel 2 (view
   consistency) and 1 + 2 of kernel 3; rays/s beside phase 4's.
3b. The 200-step checkpoint of phase 4 rendered as in phase 3, through
   `--ckpt_dir`, graph against eager on the trained weights.
5. For phases 4 and 4b each (5b: key on): one train step on the card
   against the same step on the CPU (plain versions), from the same
   parameters, batches (sixteen of 64 rays) and numpy-made draws: loss
   parts pooled over the batches, and gradients by the median of the
   per-batch ratios, as `check_train_step_against_cpu` says (the same
   statistic in every phase that calls it); 16 steps from one state as two
   replays of the 8-step graph against four eager runs, held to twice
   the eager-vs-eager spread (`check_graphed_against_eager`); ms per step
   and train rays/s of the 8-step graph, the one-step graph and eager
   steps, in turns.
6. Where the time goes in training: 8 steps under torch.profiler,
   graphed and eager, with the launch counters held against the kernels
   the profiler saw by name; 6b the same with the key on.
2m. Kernels 2 and 3 built for one density channel (mip-NeRF) vs their
   plain versions, full `configs/mipnerf.yaml` width: a train step at
   batch 2048 (2048 x 64 = 131,072 rows per level: coarse and fine on
   kernel 2, fine on kernel 3 as with the orientation loss), forward and
   backward, outputs and every gradient, the density head's apart; an
   eval chunk of 4,096 rays (262,144 rows: coarse on kernel 2, fine on
   kernel 3's forward), forward. Times, bounds and the weight-gradient
   pass as in phase 2. (Run right after phase 2.)
7. mip-NeRF eval: `python -m pano_nerf_tpu_torch.eval --config
   configs/mipnerf.yaml` (in process) on the phase-3 scene: each
   4,096-ray chunk one replay, 8 launches of kernel 2 and 8 of kernel 3
   per val panorama (plus the capture's warm-up, counted apart), no
   plain-version call, the 8-product tree, finite metrics; graph vs
   eager chunks (f32 atol 1e-4), ms per panorama, profile, and a small
   render against the plain version on the CPU.
8. mip-NeRF train: `python -m pano_nerf_tpu_torch.train --config
   configs/mipnerf.yaml`, 200 steps at batch 2048, `train.steps_per_call`
   8: per step 2 forward and 4 backward launches of kernel 2 (2 of them
   the weight-gradient pass), no kernel 3; every loss finite and falling;
   8b the 200-step checkpoint served through `eval --ckpt_dir`; then one
   step on the card against the CPU, graphed against eager, ms per step
   in turns and the profile, as phases 5 and 6. 8c: 24 steps with
   `loss.ort_loss 0.1` (kernel 3 forward and backward on the fine level).
2p. The presets' kernel shapes vs the plain versions (run after phase 2,
   entries `*_presets`): kernel 2 forward and backward on the tight
   re-read of a batch-512 env march (25,600 rows at covariances x 0.01,
   where the in-kernel IPE's high degrees are damped least), kernel 2
   forward on the env-distill march (512 x 16 = 8,192 rows) and kernel
   3's forward without the saved trunk on an eval chunk's fine level
   (1,024 x 56 = 57,344 rows); phase 2's tolerances.
9. `configs/panonerf_hdr.yaml`, 200 steps as in phase 4: per step 4
   forward and 8 backward launches of kernel 2 (coarse, view
   consistency, env, tight re-read) and 1 + 2 of kernel 3, 5 of them
   the weight-gradient pass; losses finite and falling, exact counts, no
   plain-version call. 10: `configs/panonerf_shadow.yaml`, the same plus
   one kernel-2 forward per step (the distill march; its tie falls over
   steps 140-170). 9b/10b: each checkpoint served through `eval
   --ckpt_dir` (per 1,024-ray chunk 3 kernel-2 forwards and one of
   kernel 3's; 96 + 32 per panorama), the chunk graph against eager
   chunks (f32 atol 1e-4), ms per panorama in turns, profile; the HDR
   preset's render on the card against the CPU. 9c/10c: one step on the
   card against the CPU, 16 graphed steps against eager ones (the shadow
   preset's from step 136, so that the tie's weight moves inside both
   8-step graphs), ms per step in turns, the profile, as phases 5 and 6.
11. `python -m pano_nerf_tpu_torch.render_path` (in process) on the
   200-step checkpoints of phases 4 (kernel 4), 9 (kernels 2 and 3) and
   8 (mip-NeRF): 3 frames each on the interpolated path, 128x256 through
   the chunk graph, exact launch counts, EXR and PNG frames, finite.
2s. The study switches' kernel shapes vs the plain versions (run after
   phase 2p, entries `*_study`), phase 2's tolerances: kernel 2 forward
   on the importance probe (512 x 16 cells x 4 = 32,768 rows), forward
   and backward on the env_resample march (25,600 rows) and on the fine
   level under point normals (28,672); kernel 3 forward and backward on
   the point query (512 x 1); kernel 5 on the env level with stratified
   per-ray directions (5,120 x 5); kernel 4 on an eval chunk's resampled
   env level (10,240 x 5).
12. `configs/panonerf.yaml` with `nerf.env_sampling importance`,
   `nerf.env_resample`, `nerf.illum_field`, `loss.illum_distill 0.05`
   rising over 0.5-0.75 of the run and `train.illum_freeze 0.5`: 208
   steps as in phase 4 (the freeze and the rise start at step 104,
   inside an 8-step graph): per step 5 forward and 6 backward launches
   of kernel 2 (coarse, view consistency, the resampled env march; the
   probe and the placing env march forward only) and 1 + 2 of kernel 3;
   losses finite and falling, exact counts; one step against the CPU;
   16 graphed steps from step 100 against eager ones (the rise moving
   inside both graphs); a graphed step from a fresh Adam just before the
   freeze moves the field, one at the freeze leaves it bit-equal; then
   12b: the checkpoint through `eval --ckpt_dir` (4 kernel-4 launches
   per 1,024-ray chunk, 128 per panorama), the chunk graph bit-equal to
   eager chunks, ms per panorama in turns.
13. `nerf.env_sampling stratified`, `nerf.point_normals` and the key on:
   kernel 5 on coarse and on the per-ray env directions (2 + 4), kernel
   2 on the fine level and view consistency (2 + 4), kernel 3 on the
   point query (1 + 2); 200 steps with phase 12's checks, ms per step
   beside phase 4b's of this call.
14. `nerf.env_rotation` with `nerf.density_noise 1.0` and the key on:
   density noise keeps kernel 5 off (0 launches; kernel 2 3 + 6, kernel
   3 1 + 2 per step); the same checks.
2d. Kernel 2 forward and backward on the scale-distill re-march of a
   batch-512 train step (512 x 5 = 2,560 rows) vs its plain version,
   phase 2's tolerances (entries `*_sd`, with phase 18's launches).
15. f32 Pano-NeRF on the plain route (`train.precision f32`, batch 512,
   TF32 off): 48 graphed steps through the train entry point, every loss
   finite, the mean of the last 16 below that of the first 16, every
   kernel counter 0 (`[route] plain on cuda` said); the 48-step
   weights' first val panorama through the chunk graph against eager
   chunks (`PLAIN_CHUNK_TOL`), ms per panorama; one f32 step on the card
   against the f32 step on the CPU over sixteen 64-ray batches, pooled
   (`check_f32_step_against_cpu`: the loss parts that do not depend on
   normals at rel 1e-4, the gradient without the orientation and surface
   terms at rel-norm 1e-3, the normal-dependent parts and the whole
   gradient at the measured bounds `F32_NORMAL_PART_TOL`,
   `F32_GRAD_TOL`); 16 graphed steps against eager ones (the 1e-6 floor
   of every phase); ms per step graphed, one-step graph and eager in
   turns of 8 steps (as every phase) beside phase 4's; the
   profile (device busy of the f32 step).
16. mip-NeRF at `nerf.mlp.net_depth 4`, `net_width 128`,
   `use_viewdirs false`, bf16, on the plain route: 48 steps, counters 0,
   the panorama, the step against the CPU bf16 under phase 5's rule,
   graphed against eager, ms per step.
17. Both heads on Pano-NeRF (`nerf.emissive_head`, `nerf.chroma_head`,
   11 density channels), bf16, on the plain route: as phase 16, the
   panorama and the val tree with the `emission` product.
18. `loss.scale_distill` and `_dist`, `loss.vc_chroma` with
   `vc_chroma_sg` and `loss.vc_sat_mask` on the shipped topology: 48
   steps with one more kernel-2 forward and one more kernel-2 backward
   (row pass and weight-gradient pass: two launches) per step than
   phase 4 (the re-march), exact counts; the step against the CPU under
   phase 5's rule, graphed against eager, ms per step.
19. `nerf.num_levels 3`, `nerf.stop_resample_grad false`,
   `nerf.disable_integration true` (zero covariances into kernels 2-5)
   and the key on: 200 steps with 3 + 6 launches of kernel 5 per step
   (levels 0 and 1 and the env march), 1 + 2 of kernel 2 and 1 + 2 of
   kernel 3, exact counts, the loss falling; the checkpoint served
   through `eval --ckpt_dir` (4 kernel-4 launches per 1,024-ray chunk,
   128 per panorama), the chunk graph bit-equal to eager chunks, ms per
   panorama; a 16x32 view of the checkpoint on the card against the CPU
   (phase 3's check, each product within twice the CPU's own change
   under 1e-6 shifts of the origins, the normals printed, not held); the
   step against the CPU under phase 5's rule, its normal-dependent parts
   and normal-free gradient printed, not held (set by f32 rounding of
   the positions there: `LEVEL_PHASES`), kernels 2-5
   held to their plain versions on zero covariances at phase 2's shapes
   and tolerances on the trained weights, 16 graphed steps against eager
   ones, ms per graphed step beside phase 4b's.
20. `train.randomized false`: 200 steps with 2 + 4 launches of kernel 2
   (no view-consistency query) and 1 + 2 of kernel 3 per step, no draws;
   served with `val.randomized true` (every chunk randomized by the same
   numbers, drawn once from a generator seeded with 0): two graphed
   renders bit-equal, graph bit-equal to eager chunks; the view on the
   card against the CPU with the same draws; the step against the CPU,
   graphed against eager, ms per step beside phase 4's. 20m: mip-NeRF at
   `nerf.num_levels 1` with `nerf.density_noise 1.0` and
   `loss.ort_loss 0.1` (kernel 3 forward and backward on the one level),
   64 steps, served randomized (8 kernel-3 forwards per panorama), the
   same checks.
2w. Each build at another MLP shape (`OTHER_SHAPES`: A trunk 128 and
   view branch 64; B IPE degrees 0..10 and deg_view 2; C mip-NeRF at
   A's widths without identity; H the shipped widths at 20 IPE degrees
   and deg_view 6; H2 trunk 512 / view branch 256 at 21 IPE degrees and
   deg_view 5) against its plain versions at phase 2's tolerances,
   forward and backward (parameters, means, covariances), each backward
   also as its two passes: at A, B, H and H2 kernel 4 at the three eval
   shapes, kernels 2 and 3 at a batch-512 step's four calls (28,672 /
   25,600 rows), kernel 5 (`save_acts` off) at coarse 512 x 56 and env
   5,120 x 5, at A, H and H2 also kernel 1 at 28,672 rows; at C kernels
   2 and 3 at 131,072 rows. Each timed beside the bound of the shape's
   own MACs and bytes (entries `_wA`, `_wB`, `_wC`, `_wH`, `_wH2`, with
   the launches of phases 21, 22 and 22m; no phase trains H or H2).
   (Run after phase 2m.)
21. Shape A with the key on, 22 shape B with the key off, 22m shape C
   (mip-NeRF) with `loss.ort_loss 0.1`: 64 steps each through the train
   entry point with the shipped shape's exact launch counts, losses
   finite; the checkpoint served through `eval --ckpt_dir` (21, 22: 96
   kernel-4 launches per panorama; 22m: 8 + 8 of kernels 2 and 3), the
   chunk graph against eager chunks, ms per panorama, a 16x32 view on
   the card against the CPU (`check_against_plain`); the step against
   the CPU under phase 5's rule, graphed against eager, ms per step
   (`SHAPE_PHASES`, run as phase 19's).
2x. Narrower models zero-padded into the builds (`PADDED_SHAPES`: P1
   trunk 64 / view branch 32 in shape A's 128 / 64 build, P2 200 / 100 in
   the shipped one): every kernel against its plain version at the
   model's own width (the unpadded NerfMLP) at phase 2's tolerances,
   forward and backward: at P1 kernel 4 at the three eval shapes,
   kernels 2 and 3 at a batch-512 step's four calls, kernel 5 at its two
   levels, kernel 1 at 28,672 rows; at P2 kernels 4, 5 and 1 likewise and
   kernels 2 and 3 at mip-NeRF's one density channel (131,072 rows, the
   build of phase 23m). The packed weight and bias gradients in the
   padded slots read exactly 0 over every backward. Each time beside the
   bound of the model's own MACs and bytes, with the build's MACs per
   row printed beside the model's (entries `_pP1`, `_pP2`, their
   `padded` field). (Run after phase 2w.)
23. P1 Pano-NeRF with kernel 5's key on, 23m P2 mip-NeRF with
   `loss.ort_loss 0.1` (kernels 2 and 3 at one density channel): as phase
   21 and 22m (64 steps through the train entry point with the shipped
   shape's exact launch counts, the checkpoint served, a 16x32 view on
   the card against the CPU, the step against the CPU under phase 5's
   rule, graphed against eager, ms per step). After 2x and each of
   phases 21-23m, `[libs]` prints the preprocessor definitions of every
   library the phase loaded; a library phase 1 did not build, or any
   build after phase 1, fails the run.
24. The library modules: a synthesized reference Lightning checkpoint at
   P1's widths imported through `python -m
   pano_nerf_tpu_torch.import_reference_ckpt` (in process), served
   through `eval --ckpt_dir` (96 kernel-4 launches per panorama) and its
   16x32 view held to the CPU's; the scene's EXR files read by the native
   decoder (`csrc/exr_decode.cc`) and the pure-Python codec, bitwise
   equal, the decoder printed; a 2-view Blender scene written by the
   port's PNG writer read through `Blender`, its rays on the card; the
   mip-NeRF 360 ops on the card against the CPU (`OPS360_TOL`).
2y. The 512 / 256 builds (`WIDE_SHAPES`: D Pano-NeRF at trunk 512 / view
   branch 256, built `-DNERF_W=512 -DNERF_VW=256`; Dm mip-NeRF at D's
   widths, `-DNERF_NDC=1` too; P3 384 / 192 zero-padded into D's build):
   every kernel against its plain version at phase 2's tolerances,
   forward and backward, each backward also as its two passes: at D
   kernel 4 at the three eval shapes, kernels 2 and 3 at a batch-512
   step's four calls, kernel 5 (`save_acts` off and on) at its two
   levels, kernel 1 at 28,672 rows; at Dm kernels 2 and 3 at 131,072
   train rows and 262,144 eval rows; at P3 kernels 4, 2, 3, 5 and 1 as
   at D, the padded gradient slots exactly 0. At D kernel 3's moment and
   covariance gradients are held at phase 2's 5e-2 on the check loss
   without its density-gradient term (the whole loss's printed: there
   bf16 rounding moves the plain version's own by 26% from f32); P3 and
   Dm hold them on the whole loss (`check_train_kernels`). Each timed
   beside the bound of the model's own MACs and bytes (entries `_wD`,
   `_wDm`, `_pP3`).
   (Run after phase 2x.)
25. D Pano-NeRF with kernel 5's key on, 25m Dm mip-NeRF with
   `loss.ort_loss 0.1`: as phases 21 and 22m (64 steps through the train
   entry point with the shipped shape's exact launch counts, every loss
   finite and the mean of the last 20 below that of the first 20, the
   checkpoint served, a 16x32 view on the card against the CPU, the step
   against the CPU under phase 5's rule, graphed against eager, ms per
   step beside phase 4b's and ms per panorama graph vs eager in turns),
   each phase's libraries printed and checked. (Run right after phase
   5, with 26 and 26m.)
2z. The 1,024 builds (`PAIR_SHAPES`: E Pano-NeRF at trunk 1,024 / view
   branch 512, built `-DNERF_W=1024 -DNERF_VW=512`; Em mip-NeRF at
   mip-NeRF 360's NeRF-MLP widths 1,024 / 128, `-DNERF_NDC=1
   -DNERF_W=1024`; P4 768 / 384 zero-padded into E's build): kernels 1-5
   against their plain versions at phase 2's tolerances, forward and
   backward, each backward also as its two passes, as 2y holds D, Dm and
   P3 (kernel 5 at E and P4 with `save_acts` off and on). E's and Em's kernel-3
   moment and covariance gradients on the check loss without its
   density-gradient term (`scripts/torch_k3_conditioning.py`), P4 on the
   whole loss. Entries `_wE`, `_wEm`, `_pP4`. (Run after phase 2y.)
26. E Pano-NeRF with kernel 5's key on (kernels 2, 3 and 5 on CTA
   pairs), 26m Em mip-NeRF with `loss.ort_loss 0.1`: as phases 25 and
   25m, ms per step beside phases 4b's and 25's (25m's). 26k: E with the
   key off, 16 steps through the train entry point (exact launch
   counts), 16 graphed steps against eager ones, ms per step beside
   26's. (Run right after phase 25m.) The level and shape phases (19-26m)
   time their served panorama graph vs eager without a profile of it.

`[clock] phase X at T s` marks each phase's start and `[clock] <function>
took T s` each call of the slow helpers (step checks, renders, trains).
The CPU steps of the card-vs-CPU step checks and the CPU renders of
`check_against_plain` run in four worker processes of two threads each,
at a lower priority (`cpu_pool`, spawned at first use and stopped at
exit), while the card's steps and renders run here at once; each check's
comparison is queued and run before the report (`finish_step_checks`,
under its phase's name), so the CPU's work overlaps the later phases'.

Kernel 1 is a library function that no model path calls: its launches are
counted in phases 3, 3b, 4 and 4b like the others' and must be 0. The
weight-gradient pass (`fused_mlp_weight_grads`), shared by the backward
of kernels 1, 2, 3 and 5, has its own entry; kernels 2 and 3 at one
density channel have entries of their own (`_c1`), with the launches of
the mip-NeRF runs, and so have the presets' shapes (`_presets`), with
the launches of phases 9-11's preset runs, and so have the study shapes
(`_study`), with the launches of phases 12-14 and 12b, and so has kernel
2 on the scale-distill re-march (`_sd`), with phase 18's launches, and
so has every build at another shape (`_wA`, `_wB`, `_wC`), with the
launches of phases 21, 22 and 22m (kernel 1 at A and kernel 5 at B are
on no main path: 0), and so has every kernel at the padded widths
(`_pP1` with the launches of phases 23 and 24, `_pP2` with phase 23m's;
kernel 1 at either and kernels 4 and 5 at P2 are on no main path: 0), and
so has every kernel of the 512 / 256 builds (`_wD` with phase 25's
launches, `_wDm` with phase 25m's; kernel 1 at D and every kernel at P3,
which no phase trains, are on no main path: 0), and so has every kernel
of the 1,024 builds (`_wE` with the launches of phases 26 and 26k,
`_wEm` with 26m's; kernel 1 at E and every kernel at P4 are on no main
path: 0); every kernel at H and H2 is on no main path either: 0. The
last lines are the card
(nvidia-smi name, power limit), one JSON object with each kernel's
numbers and `{"ok": true, "device": ...}`. No JAX is imported.
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
CONFIG = "configs/panonerf.yaml"
MIP_CONFIG = "configs/mipnerf.yaml"
HDR_CONFIG = "configs/panonerf_hdr.yaml"
SHADOW_CONFIG = "configs/panonerf_shadow.yaml"
PRESETS = (HDR_CONFIG, SHADOW_CONFIG)
TOL = dict(rgb=2e-2, distance=2e-2, acc=1e-2, weights=1e-2, albedo=2e-2,
           roughness=2e-2)


# The phase `main` is in, for the `[fail]` line.
PHASE = "1"
START = time.perf_counter()


def enter_phase(name: str) -> None:
    """Mark the start of phase `name` (what a failure names) and print the
    seconds since the script started, so a call's log shows where its
    wall time went."""
    global PHASE
    PHASE = name
    print(f"[clock] phase {name} at {time.perf_counter() - START:.1f} s",
          flush=True)


class CheckFailed(AssertionError):
    """A check whose value passed its bound."""

    def __init__(self, check: str, value: float, bound: float):
        super().__init__(f"{check} {value:.3e} > {bound:.3e}")


def hold(check: str, value: float, bound: float) -> None:
    """Raise CheckFailed unless value <= bound."""
    if not value <= bound:
        raise CheckFailed(check, value, bound)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


# Phase 2w and phases 21-22m: the MLP shapes the kernels are built for
# beside the shipped one (pano_nerf_tpu_torch/kernels/shapes.py), as
# config overrides. A: trunk 128, view branch 64; B: IPE degrees 0..10,
# deg_view 2; C: mip-NeRF at A's widths without identity in the viewdir
# encoding (kernels 2 and 3 only); H: the shipped widths at 20 IPE
# degrees (120 features) and deg_view 6; H2: trunk 512 / view branch 256
# at that build's most IPE degrees (21: 126 of the 128 columns of the g_x
# and d x products) and deg_view 5 (no phase trains H or H2).
SHAPE_A = ("nerf.mlp.net_width", "128", "nerf.mlp.net_width_condition",
           "64")
SHAPE_B = ("nerf.max_deg_point", "10", "nerf.deg_view", "2")
SHAPE_C = SHAPE_A + ("nerf.append_identity", "False")
SHAPE_H = ("nerf.max_deg_point", "20", "nerf.deg_view", "6")
SHAPE_H2 = ("nerf.mlp.net_width", "512", "nerf.mlp.net_width_condition",
            "256", "nerf.max_deg_point", "21", "nerf.deg_view", "5")
OTHER_SHAPES = {"A": (CONFIG, SHAPE_A), "B": (CONFIG, SHAPE_B),
                "C": (MIP_CONFIG, SHAPE_C), "H": (CONFIG, SHAPE_H),
                "H2": (CONFIG, SHAPE_H2)}


# Phase 2x and phases 23-24: models narrower than a build, run zero-padded
# in it (kernels/shapes.py `build_shape`). P1: trunk 64, view branch 32,
# in shape A's 128 / 64 build; P2: trunk 200, view branch 100, in the
# shipped 256 / 128 build (P2m: mip-NeRF, in the one-channel build).
SHAPE_P1 = ("nerf.mlp.net_width", "64", "nerf.mlp.net_width_condition",
            "32")
SHAPE_P2 = ("nerf.mlp.net_width", "200", "nerf.mlp.net_width_condition",
            "100")
PADDED_SHAPES = {"P1": (CONFIG, SHAPE_P1), "P2": (CONFIG, SHAPE_P2),
                 "P2m": (MIP_CONFIG, SHAPE_P2)}


# Phase 2y and phases 25-25m: the 512 / 256 builds, whose trunk products
# split at 512 columns (csrc/mlp_rows.cuh `mm`). D: Pano-NeRF at trunk
# 512, view branch 256 (kernels 1-5); Dm: mip-NeRF at D's widths (kernels
# 2 and 3 at one density channel, `-DNERF_NDC=1`); P3: Pano-NeRF at trunk
# 384, view branch 192, zero-padded into D's build.
SHAPE_D = ("nerf.mlp.net_width", "512", "nerf.mlp.net_width_condition",
           "256")
SHAPE_P3 = ("nerf.mlp.net_width", "384", "nerf.mlp.net_width_condition",
            "192")
WIDE_SHAPES = {"D": (CONFIG, SHAPE_D), "Dm": (MIP_CONFIG, SHAPE_D),
               "P3": (CONFIG, SHAPE_P3)}


# Phase 2z and phases 26-26m: the 1,024 builds, whose tiles run on a
# cluster of two CTAs (csrc/mlp_rows.cuh `PAIR`). E: Pano-NeRF at trunk
# 1,024, view branch 512 (kernels 1-5); Em:
# mip-NeRF at mip-NeRF 360's NeRF-MLP widths, trunk 1,024 / view branch
# 128 (`configs/360.gin` of google-research/multinerf; kernels 2 and 3 at
# one density channel); P4: Pano-NeRF at 768 / 384, zero-padded into E's
# build.
SHAPE_E = ("nerf.mlp.net_width", "1024", "nerf.mlp.net_width_condition",
           "512")
SHAPE_EM = ("nerf.mlp.net_width", "1024", "nerf.mlp.net_width_condition",
            "128")
SHAPE_P4 = ("nerf.mlp.net_width", "768", "nerf.mlp.net_width_condition",
            "384")
PAIR_SHAPES = {"E": (CONFIG, SHAPE_E), "Em": (MIP_CONFIG, SHAPE_EM),
               "P4": (CONFIG, SHAPE_P4)}


def shape_model(name: str, dev=None):
    """The model of `OTHER_SHAPES[name]` (or `PADDED_SHAPES[name]`,
    `WIDE_SHAPES[name]`, `PAIR_SHAPES[name]`) with weights from seed 0."""
    import torch
    from pano_nerf_tpu_torch.core.config import load_config
    from pano_nerf_tpu_torch.models import build_model
    config, opts = {**OTHER_SHAPES, **PADDED_SHAPES, **WIDE_SHAPES,
                    **PAIR_SHAPES}[name]
    model = build_model(load_config(config, list(opts)),
                        torch.Generator().manual_seed(0))
    return model if dev is None else model.to(dev)


# The libraries phase 1 builds ((source, defines)) and their build logs:
# no later phase may load or build another (`check_libraries`).
BUILT: set = set()
BUILT_LOGS: dict = {}


def check_libraries(phase: str) -> None:
    """Print the preprocessor definitions of every kernel library loaded
    since the last call (`kernels/build.py` `LOADED`), and fail if one of
    them is not a library phase 1 built or if anything was built since."""
    from pano_nerf_tpu_torch.kernels import build
    used = sorted(build.LOADED)
    build.LOADED.clear()
    flags = lambda d: " ".join("-D" + x for x in d) or "no defines"
    print(f"[libs] phase {phase} loaded " + "; ".join(
        f"{build.build_name(src, d)} ({flags(d)})" for src, d in used),
        flush=True)
    extra = [k for k in used if k not in BUILT]
    built = sorted(set(build.BUILD_LOGS) - set(BUILT_LOGS))
    if extra or built:
        raise AssertionError(f"phase {phase} loaded libraries phase 1 did "
                             f"not build: {extra}; built {built}")


def clocked(fn):
    """Print the seconds each call of `fn` takes (`[clock] <fn> took`), so
    a call's log shows where its wall time went inside a phase."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            print(f"[clock] {fn.__name__} took "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return run


def build_kernels():
    """Start every library's nvcc together (each source at the shipped
    shape, `fused_mlp.cu` also at one density channel, and every source
    a model of `OTHER_SHAPES`, D and Dm of `WIDE_SHAPES` or E and Em of
    `PAIR_SHAPES` runs at its shape: 25 libraries), then wait for all."""
    from pano_nerf_tpu_torch.kernels import build, shapes
    from pano_nerf_tpu_torch.kernels import (fused_mlp_ipe, fused_render,
                                             fused_render_train)
    builds = [(fused_render.SOURCE, ()), (fused_render_train.SOURCE, ()),
              (fused_mlp_ipe.SOURCE, ()),
              (fused_mlp_ipe.SOURCE, shapes.MlpShape(C=1).defines())]
    for name in list(OTHER_SHAPES) + ["D", "Dm", "E", "Em"]:
        model = shape_model(name)
        sh = shapes.build_of(model.mlp)
        builds.append((fused_mlp_ipe.SOURCE, sh.defines()))
        if sh.C == 5 and model.cfg.append_identity:   # kernels 4 and 5
            builds.append((fused_render.SOURCE, sh.defines(False)))
            builds.append((fused_render_train.SOURCE, sh.defines(False)))
    t0 = time.perf_counter()
    pending = [build.start_build(*b) for b in builds]
    for p in pending:
        build.finish_build(p)
    BUILT.update((src, tuple(d)) for src, d in builds)
    print(f"[build] {len(builds)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _report_builds()


def _report_builds() -> None:
    """Print each newly built library's seconds and compiler report
    (registers, spills, warnings) and record it as phase 1's."""
    from pano_nerf_tpu_torch.kernels import build
    for src, (log, secs) in build.BUILD_LOGS.items():
        if src in BUILT_LOGS:
            continue
        BUILT_LOGS[src] = (log, secs)
        print(f"[build] {src}: {secs:.1f} s")
        injected = 0
        for line in log.splitlines():
            if "C7519" in line:   # wgmma register-use hint, one per site
                injected += 1
            elif ("registers" in line or "spill" in line
                  or "setmaxnreg" in line or "warning" in line):
                print(f"[build] {src}: {line.strip()}")
        if injected:
            print(f"[build] {src}: {injected} warpgroup.arrive insertions "
                  f"(ptxas C7519)")


def time_ms(fn, reps: int) -> float:
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


def main_path_inputs(model, env, dev, num_rays: int = 1024,
                     with_surf: bool = False):
    """The three launch shapes of one chunk, built the way the model
    builds them (coarse march, resampled fine march, env march) from
    random primary rays inside a scene-sized box; `with_surf`: and the
    chunk's surface points [num_rays, 3] the env march starts from."""
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
    return (shapes, surf) if with_surf else shapes


def row_macs(mlp) -> dict:
    """MACs per sample row of `mlp`, unpadded: `mlp` the whole forward,
    `trunk` its 8 trunk layers (also the density chain's count), `heads`
    the bottleneck and the view layer (what kernel 3's backward
    recomputes). The shipped model: 611,328, 507,904 and 101,760."""
    W, VW = mlp.net_width, mlp.net_width_condition
    X, V = mlp.xyz_dim, mlp.view_dim
    trunk = W * X + 4 * W * W + W * (W + X) + 2 * W * W
    heads = W * W + VW * (W + V)
    return dict(mlp=trunk + mlp.num_density_channels * W + heads + 3 * VW,
                trunk=trunk, heads=heads)


def _bound_ms(args, kw, mlp) -> float:
    """Kernel 4's least time on the card: inputs read and outputs written
    once, operations at the bf16 peak."""
    R, S = args[0].shape[:2]
    m = row_macs(mlp)
    macs = m["mlp"] + (m["trunk"] if kw["need_normals"] else 0)
    return _bound(macs * R * S, R * S * 8 * 4 + R * 8 * 4 + R * (17 + S) * 4
                  + _weight_bytes(mlp, False))


def _entry(name: str, source: str, replaces: str) -> dict:
    return dict(name=name, route="cuda",
                source=f"pano_nerf_tpu_torch/csrc/{source}",
                replaces=f"pano_nerf_tpu/kernels/{replaces}", launches=None,
                max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                bound_by="operations", library_ms=None, per_shape={})


def _add(e: dict, shape: str, ms: float, plain_ms: float, bound: float,
         err: float, total: bool = True, **extra) -> None:
    """Record one shape; `total` adds its times into the entry's sums (a
    shape the main path does not launch, such as a ragged twin, stays
    out of them but not out of max_abs_err)."""
    e["per_shape"][shape] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 **extra)
    e["max_abs_err"] = max(e["max_abs_err"], err)
    if not total:
        return
    e["ms"] += ms
    e["plain_ms"] += plain_ms
    e["bound_ms"] += bound


def _bound(macs: float, bytes_: float) -> float:
    return 1e3 * max(2.0 * macs / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES)


def _weight_bytes(mlp, grads: bool) -> int:
    """The MLP's own parameters read once (bf16 weights, f32 biases); with
    `grads`, their f32 gradients written: the bound of the model's own
    work (a model padded into a wider build moves the build's bytes)."""
    return sum(p.numel() * ((2 if n.endswith("weight") else 4)
                            + (4 if grads else 0))
               for n, p in mlp.named_parameters())


def _own_ops_width(mlp, normals: bool) -> int:
    """Columns of the operand rows a backward of `mlp`'s own shape would
    write (the padded build writes its own, wider rows)."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    lay = k2.layout(k2.shape_of(mlp))
    return lay.OPW_NRM if normals else lay.OPW_IPE


# The weight-gradient pass against its plain version on the same operand
# rows: only the order of the f32 sums differs.
# rel-norm per weight parameter, against `weight_grads_reference` in
# float64, so the distance is the pass's own f32 rounding and not the sum
# of it and an f32 reference's. The reference was f32 until P3's kernel-5
# coarse level tripped the bound against it (1.03e-4; 5.3e-5 and 5.1e-5
# in other calls, whose cotangents were then unseeded); the distance to
# the f32 reference is still printed (`rel_f32`), not held.
WGRAD_TOL = 1e-4


def _cotangent(shape: tuple, seed: int, dev):
    """Standard-normal cotangents from a generator of their own: the
    backward timings' inputs, whose operand rows the weight-gradient check
    holds, so that every call holds the same rows."""
    import torch
    return torch.randn(shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))


def _wgrad_library(ops, normals: bool, shape):
    """The yardstick of the weight-gradient pass: its products as
    torch.matmul (cuBLAS, bf16 in, f32 accumulate, bf16 out) on bf16
    slices of the same operand rows, one call per product (an addmm_ for
    a NORMALS trunk weight's second pair) of `shape`'s job table. The
    port never calls it."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    jobs = k2.wgrad_jobs(normals, shape)

    def call():
        for b1, a1, b2, a2, n, k, _, _ in jobs:
            r = ops[:, b1:b1 + n].t() @ ops[:, a1:a1 + k]
            if b2 >= 0:
                r.addmm_(ops[:, b2:b2 + n].t(), ops[:, a2:a2 + k])
    return call


def check_weight_grads(mlp, ops, normals: bool, rows: int, entry: dict,
                       shape: str, failures: list,
                       total: bool = True) -> dict:
    """The weight-gradient kernel on the operand rows `ops` that a row
    pass just wrote: held against `weight_grads_reference` in float64 per
    weight parameter, timed beside its plain version (f32), its bound (the
    `rows` real
    operand rows read once, not the buffer's idle tile rows; f32 dw
    written once) and the
    torch.matmul yardstick, launched from the library built for `mlp`'s
    shape. Adds the shape to `entry` (into its sums with `total`: the
    shapes of the entry's earlier rows); returns the numbers."""
    import torch
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels.fused_render import unpack_params
    sh = k2.build_of(mlp)
    lib = k2.kernel_library(sh)
    dw = torch.zeros(k2.layout(sh).W_TOTAL, device=ops.device)
    k2.launch_weight_grads(lib, ops, dw, normals)
    want = k2.weight_grads_reference(ops, normals, sh, torch.float64)
    want32 = k2.weight_grads_reference(ops, normals, sh)
    torch.cuda.synchronize()
    db = torch.zeros(lib.fused_mlp_bias_count(), device=ops.device)
    got_p = unpack_params(mlp, dw, db)

    def distance(ref):
        rel = 0.0
        for name, w in unpack_params(mlp, ref, db).items():
            if name.endswith("weight"):
                if float(torch.linalg.norm(w)) == 0.0:
                    rel = max(rel, float(got_p[name].abs().max()))
                else:
                    rel = max(rel, _rel(got_p[name], w))
        return rel
    rel, rel_f32 = distance(want), distance(want32)
    err = float((dw - want).abs().max())
    del want32
    if not rel <= WGRAD_TOL:
        failures.append(f"{shape}.wgrad_rel: {rel:.3e} > {WGRAD_TOL}")
    ms = time_ms(lambda: k2.launch_weight_grads(lib, ops, dw, normals),
                  reps=20)
    plain_ms = time_ms(lambda: k2.weight_grads_reference(ops, normals, sh),
                        reps=3)
    library_ms = time_ms(_wgrad_library(ops, normals, sh), reps=20)
    m = row_macs(mlp)
    macs = (m["mlp"] + (m["trunk"] if normals else 0)) * rows
    own = k2.layout(k2.shape_of(mlp))
    bound = _bound(macs, rows * _own_ops_width(mlp, normals) * 2
                   + own.W_TOTAL * 4)
    _add(entry, shape, ms, plain_ms, bound, err, total=total, rows=rows,
         buffer_rows=ops.shape[0], library_ms=library_ms, rel=rel,
         rel_f32=rel_f32)
    if total:
        entry["library_ms"] = (entry["library_ms"] or 0.0) + library_ms
    return dict(ms=ms, bound=bound, library_ms=library_ms, rel=rel,
                rel_f32=rel_f32)


def _wgrad_entry() -> dict:
    e = _entry("fused_mlp_weight_grads", "fused_mlp.cu",
               "fused_mlp_ipe.py:237")
    e["bound_by"] = "bytes"
    e["shared_by"] = ("the backward of kernels 1, 2, 3 and 5 (TPU: the "
                      "dW accumulation inside fused_mlp.py:328, "
                      "fused_mlp_ipe.py:237, fused_mlp_normals.py:331, "
                      "fused_render_train.py:399)")
    return e


def check_kernels(model, env, dev, shapes=None, sfx: str = "",
                  tag: str = "[kernel]") -> dict:
    """Kernel vs plain version at the main path's shapes (or at `shapes`:
    name -> (args, kwargs)); raises on a disagreement. Returns the
    kernel's JSON entry, named with `sfx`."""
    import torch
    from pano_nerf_tpu_torch.kernels import fused_render as fr
    from pano_nerf_tpu_torch.kernels.shapes import build_of
    if shapes is None:
        shapes = main_path_inputs(model, env, dev)
        # A ragged last tile: 1023 rays of the fine level (2 rays per
        # tile).
        args, kw = shapes["fine"]
        shapes["fine_ragged"] = ([a[:1023].contiguous() for a in args], kw)
    packed = fr.pack_params(model.mlp)
    entry = _entry("fused_render_level" + sfx, "fused_render.cu",
                   "fused_render.py:248")
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
        ms = time_ms(lambda: fr.fused_render_level(
            model.mlp, *args, packed=packed, **kw), reps=20)
        plain_ms = time_ms(lambda: fr.fused_render_level_reference(
            model.mlp, *args, **kw), reps=5)
        bound = _bound_ms(args, kw, model.mlp)
        R, S = args[0].shape[:2]
        # Weights crossing L2 -> shared memory, modelled (no counter of L2
        # traffic is read): tiles x the bytes of the TMA boxes one tile
        # loads, over the measured time.
        tiles = fr.plan_tiles(R, S, build_of(model.mlp)).num_tiles
        tile_bytes = fr.weight_bytes_per_tile(kw["need_normals"],
                                              build_of(model.mlp))
        wbytes = tiles * tile_bytes
        print(f"{tag} {name:11s} R={R} S={S}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms; modelled weight "
              f"bytes {tiles} tiles x "
              f"{tile_bytes} B of TMA "
              f"boxes = {wbytes / 1e9:.3f} GB / measured ms = "
              f"{wbytes / ms / 1e9:.3f} TB/s; errors "
              + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + "; tolerances " + json.dumps(TOL))
        _add(entry, name, ms, plain_ms, bound, max(
            v for k, v in errs.items() if not k.startswith("normal")),
            total=not name.endswith("_ragged"), R=R, S=S, errors=errs)
    if failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return entry


# Kernel launches per 128x256 val panorama (32,768 rays) of each system:
# Pano-NeRF 3 of kernel 4 per 1,024-ray chunk; mip-NeRF one of kernel 2
# (coarse) and one of kernel 3's forward (fine) per 4,096-ray chunk.
# The presets, per 1,024-ray chunk: kernel 2 on the coarse level, the env
# march and its tight re-read, kernel 3's forward on the fine level.
EVAL_LAUNCHES = {CONFIG: {"fused_render_level": 96},
                 MIP_CONFIG: {"fused_mlp_ipe_fwd": 8,
                              "fused_mlp_normals_fwd": 8},
                 HDR_CONFIG: {"fused_mlp_ipe_fwd": 96,
                              "fused_mlp_normals_fwd": 32},
                 SHADOW_CONFIG: {"fused_mlp_ipe_fwd": 96,
                                 "fused_mlp_normals_fwd": 32}}


def eval_launches(config: str, env_resample: bool = False,
                  levels: int = 2) -> dict:
    """Kernel launches per 128x256 val panorama of `config`:
    `EVAL_LAUNCHES`, with `nerf.env_resample` on kernel 4's route a
    further launch per 1,024-ray chunk (the resampled env march), and one
    more or fewer per chunk for each level above or below two (kernel 4;
    mip-NeRF's kernel 2)."""
    want = dict(EVAL_LAUNCHES[config])
    if "fused_render_level" in want:
        want["fused_render_level"] += 32 * (env_resample + levels - 2)
    elif config == MIP_CONFIG:
        want["fused_mlp_ipe_fwd"] += 8 * (levels - 2)
    return want


def _stem(config: str) -> str:
    """A run directory's prefix for `config`: none for the shipped one."""
    name = os.path.splitext(os.path.basename(config))[0]
    return "" if config == CONFIG else name + "_"


def forbid_plain_versions():
    """Make every kernel's plain version raise (a main path must not
    reach one); returns the function that puts them back."""
    from pano_nerf_tpu_torch.kernels import fused_mlp as k1
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    from pano_nerf_tpu_torch.kernels import fused_render as fr
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5

    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on the main path")

    saved = [(m, n, getattr(m, n)) for m, n in (
        (k2, "fused_mlp_ipe_reference"), (k3, "fused_mlp_normals_reference"),
        (k5, "fused_render_train_reference"),
        (k1, "fused_mlp_apply_reference"),
        (fr, "fused_render_level_reference"))]
    for m, n, _ in saved:
        setattr(m, n, no_plain)

    def restore():
        for m, n, f in saved:
            setattr(m, n, f)
    return restore


@clocked
def drive_main_path(workdir: str, scene: str, weights: list,
                    step: int = 0, config: str = CONFIG, opts=(),
                    name: str = "") -> dict:
    """Render every val panorama through the eval entry point (graphed:
    one chunk-graph replay per `val.chunk_size` rays) with the system of
    `config` and the overrides `opts` into `workdir`/`name` (by default
    named after them); returns the eval metrics and the launch counts of
    the run. `weights` are the entry's weight arguments (`--init_seed
    0`, or `--ckpt_dir` of a training run)."""
    from pano_nerf_tpu_torch import eval as eval_entry
    from pano_nerf_tpu_torch.engine.validation import PRODUCTS
    from pano_nerf_tpu_torch.kernels import counters
    mip = config == MIP_CONFIG
    out = os.path.join(workdir, name or (
        _stem(config) + "eval_" + "_".join(weights[:1]).strip("-")
        + ("_study" if opts else "")))
    argv = (["--data_path", scene, "--out_dir", out] + weights
            + ["--config", config, "train.sample_num", "'n0_1'", *opts])
    restore = forbid_plain_versions()
    counters.reset_launch_counts()
    try:
        metrics = eval_entry.main(argv)
    finally:
        launches = counters.launch_counts()
        warmup = dict(counters.WARMUP)
        restore()
    n = metrics["num_images"]
    if n < 1:
        raise AssertionError("no val panorama was rendered")
    if metrics["step"] != step:
        raise AssertionError(f"rendered step {metrics['step']}, expected "
                             f"{step}")
    # Per panorama; the chunk graph's capture first ran eager warm-up
    # chunks (counted apart).
    from pano_nerf_tpu_torch.core.config import load_config
    hp = load_config(config, list(opts))
    per_pano = eval_launches(config, bool(hp.get("nerf.env_resample",
                                                 False)),
                             int(hp["nerf.num_levels"]))
    for k in launches:
        want = per_pano.get(k, 0) * n + warmup.get(k, 0)
        if launches[k] != want:
            raise AssertionError(f"{k}: {launches[k]} launches for {n} "
                                 f"panoramas, expected {want} (warm-up "
                                 f"{warmup})")
    for k, v in metrics.items():
        if isinstance(v, float) and v != v:
            raise AssertionError(f"metric {k} is NaN")
    tree = os.path.join(out, f"eval_{step:06d}")
    products = [p for p in PRODUCTS if not (mip and p in (
        "pred_hdr_surf", "pred_ldr_surf", "pred_albedo"))]
    if sorted(os.listdir(tree)) != sorted(products):
        raise AssertionError(f"product tree {sorted(os.listdir(tree))}")
    for p in products:
        files = os.listdir(os.path.join(tree, p))
        if len(files) != n:
            raise AssertionError(f"{p}: {len(files)} files for {n} images")
    counted = {k: launches[k] for k in per_pano}
    print(f"[main-{_stem(config) or 'panonerf_'}] {config} "
          f"{' '.join(weights)}: "
          f"{n} panoramas of 128x256 through the chunk graph: launches "
          f"{json.dumps(counted)} ({json.dumps(per_pano)} per panorama + "
          f"the capture's warm-up {json.dumps(warmup)}), "
          f"{len(products)} products, {metrics['render_ms_per_pano']:.1f} "
          f"ms per panorama, {metrics['rays_per_s']:.0f} rays/s on "
          f"{metrics['device']}; other kernels' launches "
          + json.dumps({k: v for k, v in launches.items()
                        if k not in per_pano}), flush=True)
    return dict(metrics=metrics, launches=launches)


def make_scene(workdir: str) -> str:
    from pano_nerf_tpu_torch.data.synthetic import generate_scene
    scene = os.path.join(workdir, "scene")
    t0 = time.perf_counter()
    generate_scene(scene, n_views=4, height=512, width=1024, seed=0)
    print(f"[main] scene 4 x 512x1024 written in "
          f"{time.perf_counter() - t0:.1f} s")
    return scene


def eager_render(system, rays, enable_surf: bool = True) -> dict:
    """The eval render op by op (the reference of the chunk graph): each
    chunk through `render_chunk` on the current weights, then one copy to
    the host."""
    import torch
    from pano_nerf_tpu_torch.core.rays import rays_map
    chunk = system.val_chunk_size
    n = rays.origins.shape[0]
    pad = (-n) % chunk
    rays = rays_map(lambda x: torch.cat(
        [x, x[-1:].expand(pad, x.shape[-1])], 0), rays)
    names = system.render_products(enable_surf)
    with torch.no_grad():
        packed = system.packed()
        draws = system.eval_draws()   # None unless val.randomized
        outs = [system.render_chunk(rays_map(
            lambda x: x[i:i + chunk].contiguous(), rays), packed,
            enable_surf, draws) for i in range(0, n + pad, chunk)]
        host = torch.cat(outs, 0)[:n].cpu()
    parts, col = {}, 0
    for name, width in names:
        parts[name] = host[:, col:col + width]
        col += width
    return parts


def _eval_system(scene: str, config: str, dev: str, factor=None, opts=()):
    """The system of `config` with the overrides `opts` on `dev` with
    weights from seed 0 (env rays set where it has them) and the scene's
    val split at `factor` (default `val.factor`)."""
    from pano_nerf_tpu_torch.core.config import load_config
    from pano_nerf_tpu_torch.data.pano_dataset import PanoDataset
    from pano_nerf_tpu_torch.engine.system import build_system
    hp = load_config(config, list(opts))
    ds = PanoDataset(scene, split="val", num=[0, 1],
                     factor=hp["val.factor"] if factor is None else factor)
    system = build_system(hp, device=dev, init_seed=0)
    if system.surface:
        system.set_env_rays(ds.generate_lit_rays(
            num=hp["nerf.num_ray_samples"], near=0.0, far=10.0))
    return system, ds


@clocked
def where_the_time_goes(scene: str, params=None, tag: str = "[eval]",
                        config: str = CONFIG, opts=(), tol=None,
                        profiled: bool = True) -> None:
    """The first val panorama rendered by the system of `config` (with
    the overrides `opts`) through the chunk graph and op by op, on the
    same weights (from `--init_seed 0`, or a checkpoint's "params"): the
    graph's products held against the eager ones (f32 atol 1e-4, and
    bit-equal where `opts` are given; `tol` where given); ms per panorama
    of each, in
    turns (graph, eager, eager, graph), one render a turn; then, where
    `profiled`, one of each under torch.profiler (device busy and idle
    share of the host wall time, top kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pano_nerf_tpu_torch.core.rays import rays_map, rays_to_tensors
    system, ds = _eval_system(scene, config, "cuda", opts=opts)
    if params is not None:
        system.model.load_params(params)
    dev = torch.device("cuda")
    flat = rays_to_tensors(rays_map(lambda x: x.reshape(-1, x.shape[-1]),
                                    ds[0][0]), dev)
    render_fn = system.make_render_image(system.surface)
    graphed = render_fn(None, flat)
    if system.val_randomized:
        # A randomized render replays the same draws: two renders agree.
        again = render_fn(None, flat)
        same = all(torch.equal(graphed[k], again[k]) for k in graphed)
        print(f"{tag} val.randomized: two graphed renders bit-equal: "
              f"{same}", flush=True)
        if not same:
            raise AssertionError("two randomized renders of the same "
                                 "weights differ")
    eager = eager_render(system, flat, system.surface)
    errs = {k: float((graphed[k] - eager[k]).abs().max()) for k in eager}
    limit = tol if tol is not None else 0.0 if opts else 1e-4
    print(f"{tag} chunk graph vs eager chunks, max abs err per product "
          f"(f32 tolerance {limit:g}): " + json.dumps(errs), flush=True)
    bad = {k: v for k, v in errs.items() if not v <= limit}
    if bad:
        raise AssertionError(f"the chunk graph's render differs from the "
                             f"eager render: {bad}")
    modes = {"graph": lambda: render_fn(None, flat),
             "eager": lambda: eager_render(system, flat, system.surface)}
    times = {m: [] for m in modes}
    for m in ("graph", "eager", "eager", "graph"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        modes[m]()   # ends in the device-to-host copy
        times[m].append(1e3 * (time.perf_counter() - t0))
    rays = ds.h * ds.w
    for m, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f"{tag} {m}: {ms:.3f} ms per {ds.h}x{ds.w} panorama "
              f"({min(ts):.3f}-{max(ts):.3f} over {len(ts)} renders) = "
              f"{1e3 * rays / ms:.1f} eval rays/s", flush=True)
    for m, fn in modes.items() if profiled else ():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall_us = 1e6 * (time.perf_counter() - t0)
        _report_profile(prof, wall_us, f"one {ds.h}x{ds.w} panorama, {m}")


@clocked
def check_against_plain(scene: str, config: str = CONFIG,
                        tag: str = "[check]", opts=(), params=None,
                        shifts: int = 0) -> None:
    """A 16x32 view of the scene rendered by the system of `config` (with
    the overrides `opts`; weights from seed 0, or a checkpoint's
    `params`) on the card (kernels) and on the CPU (plain versions) must
    agree: each product within 5e-2, the normals' median cosine above
    0.99. Under `val.randomized` both renders take the same draws, made
    on the CPU from a generator seeded with 0. With `shifts` the CPU
    also renders the view with its ray origins moved by 1e-6 (numpy
    seeds 0..shifts-1), each product's bound becomes the larger of 5e-2
    and twice the CPU's own largest change, and the normals are printed,
    not held: where f32 rounding of the positions sets the render
    (`nerf.disable_integration`), the card is held to the CPU no tighter
    than the CPU holds itself. The card renders now; the CPU's
    renders run in `cpu_pool` and the comparison is queued
    (`defer_check`), as the step checks'."""
    import torch
    from pano_nerf_tpu_torch.engine import validation as V
    system, ds = _eval_system(scene, config, "cuda", factor=32, opts=opts)
    if params is not None:
        system.model.load_params({k: v.to("cuda") for k, v in
                                  params.items()})
    draws = None
    if system.val_randomized:
        cpu_system, _ = _eval_system(scene, config, "cpu", factor=32,
                                     opts=opts)
        draws = cpu_system.make_draws(cpu_system.val_chunk_size,
                                      torch.Generator().manual_seed(0),
                                      eval_counts=True)
    on_dev = None if draws is None else type(draws)(
        *(None if x is None else x.to("cuda") for x in draws))
    render = system.make_render_image(system.surface, draws=on_dev)
    card = V.render_full_pano(render, None, ds[0][0], ds.h, ds.w,
                              torch.device("cuda"))
    np_of = lambda t: None if t is None else t.detach().cpu().numpy()
    fut = cpu_pool().submit(
        _plain_renders, scene, config, tuple(opts),
        None if params is None else {k: np_of(v) for k, v in params.items()},
        None if draws is None else type(draws)(*(np_of(x) for x in draws)),
        shifts)
    defer_check(lambda: _hold_renders(tag, card, fut.result(), shifts))


def _plain_renders(scene: str, config: str, opts, params_np, draws_np,
                   shifts: int) -> dict:
    """`check_against_plain`'s CPU side (in a `cpu_pool` worker): the view
    rendered by the plain versions from the parameters `params_np` (numpy;
    None: seed 0) with the draws `draws_np` (numpy, or None), as "cpu",
    and with the ray origins moved by 1e-6 (numpy seeds 0..shifts-1) as
    "shift<seed>"."""
    import numpy as np
    import torch
    from pano_nerf_tpu_torch.engine import validation as V
    system, ds = _eval_system(scene, config, "cpu", factor=32, opts=opts)
    if params_np is not None:
        system.model.load_params({k: torch.from_numpy(v)
                                  for k, v in params_np.items()})
    draws = None if draws_np is None else type(draws_np)(
        *(None if x is None else torch.as_tensor(x) for x in draws_np))
    render = system.make_render_image(system.surface, draws=draws)
    rays = ds[0][0]
    cpu = torch.device("cpu")
    out = {"cpu": V.render_full_pano(render, None, rays, ds.h, ds.w, cpu)}
    for seed in range(shifts):
        d = np.random.default_rng(seed).normal(size=rays.origins.shape)
        d *= 1e-6 / np.linalg.norm(d, axis=-1, keepdims=True)
        moved = rays._replace(origins=(rays.origins + d).astype(
            rays.origins.dtype))
        out[f"shift{seed}"] = V.render_full_pano(render, None, moved, ds.h,
                                                 ds.w, cpu)
    return out


def _hold_renders(tag: str, card: dict, out: dict, shifts: int) -> None:
    """`check_against_plain`'s comparison of the card's render `card` with
    the CPU's (`_plain_renders`)."""
    import numpy as np
    out = dict(out, cuda=card)
    moved = [out[f"shift{seed}"] for seed in range(shifts)]
    for k in ("rgb_fine", "dep_fine", "rgb_coarse", "dep_coarse",
              "albedo", "roughness"):
        if k not in out["cpu"]:
            continue
        err = float(np.abs(out["cuda"][k] - out["cpu"][k]).max())
        own = max((float(np.abs(m[k] - out["cpu"][k]).max())
                   for m in moved), default=0.0)
        tol = max(5e-2, 2 * own)
        print(f"{tag} {k}: kernel vs plain max abs err {err:.3e} (bound "
              f"{tol:.3e}" + (f"; the CPU's own change {own:.3e}"
                              if shifts else "") + ")")
        if not err <= tol:
            raise AssertionError(f"{k}: kernel render differs from the "
                                 f"plain render by {err}")
    cos = lambda a: float(np.median(np.sum(a["normal"]
                                           * out["cpu"]["normal"], -1)))
    card = cos(out["cuda"])
    if shifts:
        print(f"{tag} normal cos median {card:.5f} (not held; the CPU's "
              f"own under the shifts " + ", ".join(f"{cos(m):.5f}"
                                                   for m in moved) + ")")
        return
    print(f"{tag} normal cos median {card:.5f}")
    if not card > 0.99:
        raise AssertionError("normals of kernel and plain render disagree")


# ---- kernels 2 and 3 (training) -------------------------------------------

TRAIN_TOL = dict(out_abs=2e-2, dsig_rel=0.08, grad_rel_k2=2e-2,
                 grad_rel_k3=5e-2, dmc_rel=5e-2)
# MACs per row. Kernel 2 backward: recompute + data + weight gradients;
# kernel 3 backward: the MLP's data and weight gradients, the chain's
# recompute, walk and walk weight gradients, and the heads' recompute.
def train_macs(mlp, normals: bool, direction: str) -> int:
    """MACs per row of kernel 2 (3) of `mlp`: `fwd`; `bwd`, recompute, data
    and weight gradients (kernel 3: the MLP's data and weight gradients,
    the chain's recompute, walk and walk weight gradients, the heads'
    recompute); `rows`, the backward's row pass alone (the weight-gradient
    pass does the rest: kernel 2 recomputes the forward and runs the data
    gradients; kernel 3 recomputes the heads, runs the data gradients, the
    chain and the walk)."""
    m = row_macs(mlp)
    mlp_m, chain, heads = m["mlp"], m["trunk"], m["heads"]
    if not normals:
        return dict(fwd=mlp_m, bwd=3 * mlp_m, rows=2 * mlp_m)[direction]
    return dict(fwd=mlp_m + chain, bwd=2 * mlp_m + 3 * chain + heads,
                rows=mlp_m + 2 * chain + heads)[direction]


def _train_batch(model, env, dev, batch: int = 512) -> dict:
    """One train step's batch at full width, built the way the model
    builds it from random primary rays and draws (seeds 11 and 12; the
    plain version for the weights that place the fine samples): its rays,
    levels, surface points and env march, by name."""
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
    kw = dict(min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point)
    with torch.no_grad():
        t0, (m0, c0) = mip.sample_along_rays(
            rays.origins, rays.directions, rays.radii,
            cfg.coarse_samples(False), rays.near, rays.far,
            t_rand=draws.t_coarse)
        v = model._venc(rays.viewdirs)
        raw_rgb, raw_den = fused_mlp_ipe_reference(model.mlp, m0, c0, v, **kw)
        _, _, _, w0 = mip.volumetric_rendering(
            model._rgb(raw_rgb), model._density(raw_den[..., :1]), t0,
            rays.directions, False)
        t1, (m1, c1) = mip.resample_along_rays(
            rays.origins, rays.directions, rays.radii, t0, w0,
            cfg.resample_padding, num_samples=cfg.num_samples,
            u_rand=draws.u_fine)
        raw_rgb, raw_den = fused_mlp_ipe_reference(model.mlp, m1, c1, v, **kw)
        _, dist, _, w1 = mip.volumetric_rendering(
            model._rgb(raw_rgb), model._density(raw_den[..., :1]), t1,
            rays.directions, False)
        surf = rays.origins + rays.directions * dist[:, None]
        lt, (lm, lc), ld = mip.sample_env_rays(
            surf, env.directions, cfg.num_env_samples, env.near, env.far,
            env.radii, t_rand=draws.t_env)
    return dict(rays=rays, draws=draws, v=v, t0=t0, m0=m0, c0=c0, m1=m1,
                c1=c1, w1=w1, surf=surf, lt=lt, lm=lm, lc=lc, ld=ld)


def train_shapes(model, env, dev, batch: int = 512):
    """The four kernel calls of one train step at full width
    (`_train_batch`): name -> (normals?, means, covs, v_enc); the two
    levels kernel 5 renders with the key on: name -> (means, covs,
    viewdirs, t_samples, dirs); and the surface points [batch, 3] the env
    march starts from."""
    import torch
    from pano_nerf_tpu_torch.ops import mip
    b = _train_batch(model, env, dev, batch)
    rays, v, lm, lc, ld = b["rays"], b["v"], b["lm"], b["lc"], b["ld"]
    with torch.no_grad():
        d_alt = mip.safe_normalize(b["draws"].d_alt)
    B, D, S = lm.shape[:3]
    flat_dirs = ld.reshape(B * D, 3).contiguous()
    levels = {"coarse": (b["m0"].contiguous(), b["c0"].contiguous(),
                         rays.viewdirs, b["t0"].contiguous(),
                         rays.directions),
              "env": (lm.reshape(B * D, S, 3).contiguous(),
                      lc.reshape(B * D, S, 3).contiguous(), flat_dirs,
                      b["lt"].reshape(B * D, S + 1).contiguous(), flat_dirs)}
    return {"coarse": (False, b["m0"], b["c0"], v),
            "fine": (True, b["m1"], b["c1"], v),
            "vc": (False, b["m1"], b["c1"], model._venc(d_alt)),
            "env": (False, lm.contiguous(), lc.contiguous(),
                    model._venc(ld))}, levels, b["surf"]


# The presets' env read: configs/panonerf_hdr.yaml `nerf.env_tight_rgb`
# and configs/panonerf_shadow.yaml `nerf.env_distill_samples`.
PRESET_TIGHT = 0.01
PRESET_DISTILL = 16
PRESET_FWD_ONLY = ("distill", "eval_fine")


def preset_shapes(model, env, dev, calls, surf) -> dict:
    """The kernel calls the presets add, at full width, built the way
    `models/pano_mip_nerf.py` builds them: the tight re-read of a train
    step's env march (`calls["env"]`, 25,600 rows at covs x 0.01; kernel
    2 forward and backward), the env-distill march of one random env
    direction per surface point of `surf` (512 x 16 = 8,192 rows; kernel
    2 forward only) and the fine level of an eval chunk (1,024 x 56 =
    57,344 rows; kernel 3's forward, no saved trunk). name -> (normals?,
    means, covs, v_enc)."""
    import torch
    from pano_nerf_tpu_torch.ops import mip
    _, lm, lc, v_env = calls["env"]
    B, D = surf.shape[0], env.directions.shape[0]
    g = torch.Generator(device=dev).manual_seed(13)
    idx = torch.randint(0, D, (B, 1), generator=g, device=dev)
    t, (m, c), d = mip.sample_env_rays_hemisphere(
        surf, env.directions[idx[:, 0]][:, None, :], PRESET_DISTILL,
        env.near[:1, :1], env.far[:1, :1], env.radii[:1, :1],
        t_rand=torch.rand((B, 1, PRESET_DISTILL + 1), generator=g,
                          device=dev))
    args = main_path_inputs(model, env, dev)["fine"][0]
    return {"tight": (False, lm, (lc * PRESET_TIGHT).contiguous(), v_env),
            "distill": (False, m.contiguous(), c.contiguous(),
                        model._venc(d)),
            "eval_fine": (True, args[0], args[1], model._venc(args[2]))}


def study_shapes(model, env, dev):
    """The kernel calls the study switches add, at full width, built the
    way `models/pano_mip_nerf.py` builds them from a train step's batch
    (`_train_batch`) and an eval chunk (`main_path_inputs`), plain
    versions for the weights that place samples. Kernels 2 and 3: the
    importance probe (512 x 16 cells x 4 = 32,768 rows, forward only),
    the env_resample march (512 x 10 x 5 = 25,600 rows, placed by the
    env march's weights), the fine level under point normals (kernel 2
    at 28,672 rows) and the point query (kernel 3 at 512 x 1), as
    name -> (normals?, means, covs, v_enc). Kernel 5: the env level with
    stratified per-ray directions (5,120 x 5), as name -> (means, covs,
    viewdirs, t_samples, dirs). Kernel 4: the resampled env level of an
    eval chunk (10,240 x 5), as name -> (args, kwargs)."""
    import torch
    from pano_nerf_tpu_torch.kernels.fused_mlp_ipe import (
        fused_mlp_ipe_reference)
    from pano_nerf_tpu_torch.kernels.fused_render import (
        fused_render_level_reference)
    from pano_nerf_tpu_torch.ops import mip
    from pano_nerf_tpu_torch.utils import rotation
    from pano_nerf_tpu_torch.utils.spherical import sample_dir_by_uniform
    cfg = model.cfg
    kw = dict(min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point)
    b = _train_batch(model, env, dev)
    surf, v, m1, c1 = b["surf"], b["v"], b["m1"], b["c1"]
    B, D = surf.shape[0], env.directions.shape[0]
    g = torch.Generator(device=dev).manual_seed(14)
    rand = lambda *sh: torch.rand(sh, generator=g, device=dev)
    with torch.no_grad():
        R = rotation.random_rotations(torch.randn((B, 4), generator=g,
                                                  device=dev))
        cells = rotation.rotate(R, torch.tensor(sample_dir_by_uniform(
            cfg.env_probe_dirs), device=dev))
        first = lambda x: x[:1].expand(cfg.env_probe_dirs, 1)
        _, (pm, pc), pd = mip.sample_env_rays_hemisphere(
            surf, cells, cfg.env_probe_samples, first(env.near),
            first(env.far), first(env.radii),
            t_rand=rand(B, cfg.env_probe_dirs, cfg.env_probe_samples + 1))
        lt, lm, lc, ld = b["lt"], b["lm"], b["lc"], b["ld"]
        v_lit = model._venc(ld)
        raw_rgb, raw_den = fused_mlp_ipe_reference(model.mlp, lm, lc, v_lit,
                                                   **kw)
        ew = mip.volumetric_rendering(
            model._rgb(raw_rgb), model._density(raw_den[..., :1]), lt, ld,
            False)[3]
        t2, (m2, c2) = model._resample_env(
            surf, ld, env.radii, lt, ew,
            rand(B * D, cfg.num_env_fine_samples + 1))
        # The point query at the fine level's expected Gaussian.
        w = b["w1"] / torch.clamp(b["w1"].sum(-1, keepdim=True), min=1e-8)
        mean_pt = torch.sum(w[..., None] * m1, -2, keepdim=True)
        cov_pt = torch.sum(w[..., None] * c1, -2, keepdim=True)
        # Kernel 5 on stratified per-ray directions.
        sdirs, _ = mip.stratified_env_directions(
            rotation.rotate(R, env.directions), rand(B, D, 1),
            rand(B, D, 1))
        st, (sm, sc), sd = mip.sample_env_rays_hemisphere(
            surf, sdirs, cfg.num_env_samples, env.near, env.far, env.radii,
            t_rand=rand(B, D, cfg.num_env_samples + 1))
        # Kernel 4: an eval chunk's env level, then the resampled one.
        shapes, esurf = main_path_inputs(model, env, dev, with_surf=True)
        args, k4kw = shapes["env"]
        n, S = esurf.shape[0], args[0].shape[1]
        ew4 = fused_render_level_reference(model.mlp, *args, **k4kw)[
            "weights"]
        et, (em, ec) = model._resample_env(
            esurf, args[2].reshape(n, D, 3), env.radii,
            args[3].reshape(n, D, S + 1), ew4.reshape(n, D, S), None)
    Sf, Se = t2.shape[-1] - 1, et.shape[-1] - 1
    flat = sd.reshape(B * D, 3).contiguous()
    k2k3 = {"probe": (False, pm.contiguous(), pc.contiguous(),
                      model._venc(pd)),
            "env_resampled": (False, m2.contiguous(), c2.contiguous(),
                              v_lit),
            "fine_point": (False, m1, c1, v),
            "point_query": (True, mean_pt.contiguous(), cov_pt.contiguous(),
                            v)}
    k5 = {"env_stratified": (sm.reshape(B * D, -1, 3).contiguous(),
                             sc.reshape(B * D, -1, 3).contiguous(), flat,
                             st.reshape(B * D, -1).contiguous(), flat)}
    k4 = {"env_resampled": ((em.reshape(n * D, Se, 3).contiguous(),
                             ec.reshape(n * D, Se, 3).contiguous(), args[2],
                             et.reshape(n * D, Se + 1).contiguous(),
                             args[4]), k4kw)}
    if Sf != cfg.num_env_fine_samples or Se != cfg.num_env_fine_samples:
        raise AssertionError(f"resampled {Sf} / {Se} samples")
    return k2k3, k5, k4


MIP_BATCH = 2048    # configs/mipnerf.yaml train.batch_size
MIP_CHUNK = 4096    # configs/mipnerf.yaml val.chunk_size
MIP_EVAL = ("eval_coarse", "eval_fine")


def _random_rays(n: int, seed: int, dev):
    """`n` random primary rays from inside a scene-sized box."""
    import torch
    from pano_nerf_tpu_torch.core.rays import Rays
    g = torch.Generator().manual_seed(seed)
    d = torch.randn(n, 3, generator=g)
    ones = torch.ones(n, 1)
    rays = Rays(origins=(torch.rand(n, 3, generator=g) - 0.5) * 0.6,
                directions=d, viewdirs=d / torch.linalg.norm(d, dim=-1,
                                                             keepdim=True),
                radii=ones * 0.0142, lossmult=ones, near=ones * 0.0,
                far=ones * 10.0, noise_var=ones * 0.0)
    return Rays(*(x.to(dev).contiguous() for x in rays))


def mip_shapes(model, dev) -> dict:
    """The kernel calls of the mip-NeRF paths at full width, built the way
    `models/mip_nerf.py` builds them (plain version for the weights that
    place the fine samples): a train step at batch 2048, 2048 x 64 =
    131,072 rows per level (coarse and fine on kernel 2; the fine level on
    kernel 3 with the orientation loss on), and an eval chunk of 4,096
    rays, 262,144 rows per level (coarse on kernel 2, fine on kernel 3's
    forward). name -> (normals?, means, covs, v_enc)."""
    import torch
    from pano_nerf_tpu_torch.kernels.fused_mlp_ipe import (
        fused_mlp_ipe_reference)
    from pano_nerf_tpu_torch.ops import mip
    cfg = model.cfg
    kw = dict(min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point)

    def weights(rays, t, m, c, v):
        raw_rgb, raw_den = fused_mlp_ipe_reference(model.mlp, m, c, v, **kw)
        return mip.volumetric_rendering(
            model._rgb(raw_rgb), model._density(raw_den[..., :1]), t,
            rays.directions, False)[3]

    calls = {}
    with torch.no_grad():
        rays = _random_rays(MIP_BATCH, 11, dev)
        draws = model.make_draws(
            MIP_BATCH, torch.Generator(device=dev).manual_seed(12))
        v = model._venc(rays.viewdirs)
        t0, (m0, c0) = mip.sample_along_rays(
            rays.origins, rays.directions, rays.radii,
            cfg.coarse_samples(False), rays.near, rays.far, cfg.disparity,
            t_rand=draws.t_coarse)
        t1, (m1, c1) = mip.resample_along_rays(
            rays.origins, rays.directions, rays.radii, t0,
            weights(rays, t0, m0, c0, v), cfg.resample_padding,
            num_samples=cfg.num_samples, u_rand=draws.u_fine)
        calls.update(train_coarse=(False, m0, c0, v),
                     train_fine=(False, m1, c1, v),
                     train_fine_ort=(True, m1, c1, v))
        rays = _random_rays(MIP_CHUNK, 7, dev)
        v = model._venc(rays.viewdirs)
        t0, (m0, c0) = cfg.sample_level(rays, 0, None, None)
        _, (m1, c1) = cfg.sample_level(rays, 1, t0,
                                       weights(rays, t0, m0, c0, v))
        calls.update(eval_coarse=(False, m0, c0, v),
                     eval_fine=(True, m1, c1, v))
    return {k: (n, m.contiguous(), c.contiguous(), v)
            for k, (n, m, c, v) in calls.items()}


def _outs_and_grads(fn, mlp, means, covs, v_enc, dsig_scale=0.1, **kw):
    """Outputs and the gradients of a loss on every output (a mean over
    the rows, so the gradients are O(1); the density gradient enters as
    sin(dsig_scale x d raw_sigma / d means)), w.r.t. the parameters
    (flat), the means, the density head (weight and bias, flat) and the
    covariances (which carry a gradient where the fenceposts do:
    `nerf.stop_resample_grad: false`)."""
    import torch
    mlp.zero_grad(set_to_none=True)
    m = means.detach().clone().requires_grad_(True)
    c = covs.detach().clone().requires_grad_(True)
    outs = fn(mlp, m, c, v_enc, **kw)
    loss = torch.sin(outs[0]).sum() + torch.cos(outs[1]).sum()
    if len(outs) == 3:
        loss = loss + torch.sin(dsig_scale * outs[2]).sum()
    (loss / outs[0][..., 0].numel()).backward()
    flat = torch.cat([p.grad.reshape(-1) for p in mlp.parameters()])
    head = torch.cat([mlp.density_layer.weight.grad.reshape(-1),
                      mlp.density_layer.bias.grad])
    mlp.zero_grad(set_to_none=True)
    return [o.detach() for o in outs], flat, m.grad, head, c.grad


def _rel(a, b) -> float:
    import torch
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _train_bound_ms(mlp, normals: bool, direction: str, rows: int,
                    save_acts: bool = True) -> float:
    """Kernels 2 and 3 of `mlp`: inputs read once and outputs written once
    (kernel 3's forward writes its trunk for the backward only with
    `save_acts`, as in training; the eval render saves nothing)."""
    W, v = mlp.net_width, _v_bytes(mlp)
    acts = (12 + (8 * W * 2 if save_acts else 0)) if normals else 0
    if direction == "fwd":
        bytes_ = rows * (32 + v + 64 + acts) + _weight_bytes(mlp, False)
    else:   # mc, v, cotangents (+ acts) in; d mc and f32 grads out
        bytes_ = (rows * (32 + v + 64 + 32 + acts)
                  + _weight_bytes(mlp, True))
    return _bound(train_macs(mlp, normals, direction) * rows, bytes_)


def _v_bytes(mlp) -> int:
    """Bytes of one row's bf16 viewdir codes (VP columns: 32 for the
    shipped encoding's 27)."""
    return 2 * (-(-mlp.view_dim // 16) * 16)


# `dsig_free_moments`: on the whole check loss, kernel 3's moment and
# covariance gradients lie at most this times as far from the f32 plain
# version's as the bf16 plain version's do (`scripts/torch_k3_conditioning.py`
# on an H100 reads 0.77-1.004 at D's weights from seed 0 and E's and Em's
# from seeds 0 and 1).
WHOLE_F32_RATIO = 1.1


def check_train_kernels(model, dev, calls, wentry: dict, ndc: int = 5,
                        forward_only=(), tag: str = "[kernel]",
                        sfx: str = "", dsig_rms: bool = False,
                        dsig_free_moments: bool = False) -> list:
    """Kernels 2 and 3 (forward and backward) vs their plain versions at
    the shapes `calls` (name -> (normals?, means, covs, v_enc)) of the
    model's main path, built for its MLP's shape (`ndc` density channels
    among it), and the weight-gradient pass on each backward's own
    operand rows (into `wentry`); the shapes in `forward_only` are run forward only and
    without saved activations (as the eval render and the env-distill
    march run them). With `dsig_rms` the loss takes kernel 3's density
    gradient at 0.1 over its rms instead of at 0.1 (on zero covariances
    it is ~2^15 times larger, and sin(0.1 x) of it would turn its
    rounding into other cotangents). With `dsig_free_moments` (phase 2y
    at D, 2z at E and Em) kernel 3's moment and covariance gradients are
    held on the same loss without the density-gradient term, the rest on
    the whole loss: at D's fine call the bf16 plain version's own moment
    gradient there lies 2.6e-1 from its f32 run, the kernel's 2.1e-1, all
    of the kernel-plain distance in 1% of the rows (PERF.md section 6; E
    and Em alike); on the whole loss they are held against the plain
    version's in f32 (`WHOLE_F32_RATIO`); the term's path through the
    same code is held whole at P3, Dm and P4. Raises on a
    disagreement. Returns the JSON entries that got a shape (launches filled
    in by the main path's runs; names carry `sfx`, and only the unsuffixed
    shapes add into the weight-gradient entry's sums)."""
    import types
    import torch
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    from pano_nerf_tpu_torch.kernels.fused_render import pack_params
    mlp, cfg = model.mlp, model.cfg
    kw = dict(min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point)
    packed = pack_params(mlp)
    if mlp.num_density_channels != ndc:
        raise AssertionError(f"the model has {mlp.num_density_channels} "
                             f"density channels, not {ndc}")
    lib = k2.kernel_library(k2.build_of(mlp))
    entries = {name: _entry(name + sfx, "fused_mlp.cu", src_line)
               for name, src_line in (
                   ("fused_mlp_ipe_fwd", "fused_mlp_ipe.py:211"),
                   ("fused_mlp_ipe_bwd", "fused_mlp_ipe.py:237"),
                   ("fused_mlp_normals_fwd", "fused_mlp_normals.py:304"),
                   ("fused_mlp_normals_bwd", "fused_mlp_normals.py:331"))}
    failures = []
    for shape, (normals, means, covs, v_enc) in calls.items():
        kern = k3.fused_mlp_normals_apply if normals else k2.fused_mlp_ipe_apply
        plain = (k3.fused_mlp_normals_reference if normals
                 else k2.fused_mlp_ipe_reference)
        train = shape not in forward_only
        scale = 0.1
        if train and normals and dsig_rms:
            with torch.no_grad():
                dsig = plain(mlp, means, covs, v_enc, **kw)[2]
            scale = 0.1 / float(torch.sqrt(torch.mean(dsig * dsig)))
        if train:
            got, g_got, m_got, h_got, c_got = _outs_and_grads(
                kern, mlp, means, covs, v_enc, dsig_scale=scale,
                packed=packed, **kw)
            want, g_want, m_want, h_want, c_want = _outs_and_grads(
                plain, mlp, means, covs, v_enc, dsig_scale=scale, **kw)
        else:
            with torch.no_grad():
                got = kern(mlp, means, covs, v_enc, packed=packed, **kw)
                want = plain(mlp, means, covs, v_enc, **kw)
        torch.cuda.synchronize()
        if got[1].shape[-1] != ndc:
            raise AssertionError(f"{shape}: {got[1].shape[-1]} density "
                                 f"channels, expected {ndc}")
        out_err = max(float((a - b).abs().max())
                      for a, b in zip(got[:2], want[:2]))
        errs = dict(out_abs=out_err)
        grad_tol = TRAIN_TOL["grad_rel_k3" if normals else "grad_rel_k2"]
        checks = [("out_abs", TRAIN_TOL["out_abs"])]
        if train:
            errs.update(grad_rel=_rel(g_got, g_want),
                        grad_abs=float((g_got - g_want).abs().max()),
                        head_rel=_rel(h_got, h_want),
                        dmc_rel=_rel(m_got, m_want),
                        dcov_rel=_rel(c_got, c_want))
            checks += [("grad_rel", grad_tol), ("head_rel", grad_tol),
                       ("dmc_rel", TRAIN_TOL["dmc_rel"]),
                       ("dcov_rel", TRAIN_TOL["dmc_rel"])]
        if normals:
            errs["dsig_rel"] = _rel(got[2], want[2])
            checks.append(("dsig_rel", TRAIN_TOL["dsig_rel"]))
        if train and normals and dsig_free_moments:
            # On the whole loss the moment gradients are held against the
            # plain version's in f32: the kernel no further from them than
            # the bf16 plain version (WHOLE_F32_RATIO).
            import copy
            m32 = copy.deepcopy(mlp)
            m32.compute_dtype = torch.float32
            _, _, mf, _, cf = _outs_and_grads(plain, m32, means, covs, v_enc,
                                              dsig_scale=scale, **kw)
            errs.update(dmc_rel_whole=errs["dmc_rel"],
                        dcov_rel_whole=errs["dcov_rel"],
                        dmc_f32_ratio_whole=_rel(m_got, mf) / _rel(m_want, mf),
                        dcov_f32_ratio_whole=_rel(c_got, cf) / _rel(c_want,
                                                                    cf))
            checks += [(k, WHOLE_F32_RATIO) for k in (
                "dmc_f32_ratio_whole", "dcov_f32_ratio_whole")]
            del m32, mf, cf
            _, _, m0, _, c0 = _outs_and_grads(
                kern, mlp, means, covs, v_enc, dsig_scale=0.0,
                packed=packed, **kw)
            _, _, m1, _, c1 = _outs_and_grads(
                plain, mlp, means, covs, v_enc, dsig_scale=0.0, **kw)
            errs.update(dmc_rel=_rel(m0, m1), dcov_rel=_rel(c0, c1))
            del m0, c0, m1, c1
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
        acts = (torch.empty((M, 8 * lib._pano_shape.W),
                            dtype=torch.bfloat16, device=dev)
                if normals and train else None)
        stream = torch.cuda.current_stream().cuda_stream

        def fwd():
            k2.check_launch(lib, "forward", lib.fused_mlp_forward(
                mc.data_ptr(), v.data_ptr(), packed[0].data_ptr(),
                packed[1].data_ptr(), out.data_ptr(),
                dsig.data_ptr() if normals else None,
                acts.data_ptr() if acts is not None else None, M,
                cfg.min_deg_point, int(normals), stream))

        if not train:
            ms_f = time_ms(fwd, reps=20)
            with torch.no_grad():
                plain_f = time_ms(lambda: plain(mlp, means, covs, v_enc,
                                                **kw), reps=3)
            bound_f = _train_bound_ms(mlp, normals, "fwd", M,
                                      save_acts=False)
            base = "fused_mlp_normals" if normals else "fused_mlp_ipe"
            _add(entries[f"{base}_fwd"], shape, ms_f, plain_f, bound_f,
                 errs["out_abs"], rows=M, errors=errs)
            print(f"{tag} {shape:12s} M={M} {'k3' if normals else 'k2'} "
                  f"C={ndc}: fwd {ms_f:.3f} ms (plain {plain_f:.3f}, bound "
                  f"{bound_f:.4f}); errors "
                  + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
                  + "; tolerances " + json.dumps(TRAIN_TOL), flush=True)
            del out, dsig
            continue

        g = _cotangent((M, 16), 17, dev)
        q = _cotangent((M, 3), 18, dev) if normals else None
        dummy = types.SimpleNamespace(backward_launches=0)

        def bwd():
            k2.run_backward(lib, dummy, mlp, mc, v, packed[0], packed[1], g,
                            q, acts, cfg.min_deg_point, normals)

        ms_f = time_ms(fwd, reps=20)
        ms_b = time_ms(bwd, reps=10)
        # The two passes alone: the row pass, then the weight-gradient
        # pass on the operand rows it wrote.
        ops, dw_r, db_r = k2.backward_buffers(lib, *packed,
                                              k2.tile_rows(lib, M), normals)
        dmc_r = torch.empty((M, 8), device=dev)
        ms_r = time_ms(lambda: k2.launch_backward_rows(
            lib, mc, v, *packed, g, q, acts, ops, dmc_r, dw_r, db_r,
            cfg.min_deg_point, normals), reps=10)
        bound_r = _bound(train_macs(mlp, normals, "rows") * M, M * (
            32 + _v_bytes(mlp) + 64 + 32
            + (12 + 8 * mlp.net_width * 2 if normals else 0))
            + M * _own_ops_width(mlp, normals) * 2
            + _weight_bytes(mlp, False))
        wg = check_weight_grads(mlp, ops, normals, M, wentry,
                                f"k{3 if normals else 2}{sfx}_{shape}",
                                failures, total=sfx == "")
        del ops, dw_r, db_r, dmc_r
        with torch.no_grad():
            plain_f = time_ms(lambda: plain(mlp, means, covs, v_enc, **kw),
                               reps=3)
        m_req = means.detach().clone().requires_grad_(True)
        p_outs = plain(mlp, m_req, covs, v_enc, **kw)
        cot = [torch.randn_like(o) for o in p_outs]
        params = list(mlp.parameters()) + [m_req]
        plain_b = time_ms(lambda: torch.autograd.grad(
            p_outs, params, cot, retain_graph=True), reps=3)
        del p_outs
        base = "fused_mlp_normals" if normals else "fused_mlp_ipe"
        passes = dict(row_ms=ms_r, row_bound_ms=bound_r, wgrad_ms=wg["ms"],
                      wgrad_bound_ms=wg["bound"],
                      wgrad_library_ms=wg["library_ms"])
        for direction, ms, pms in (("fwd", ms_f, plain_f),
                                   ("bwd", ms_b, plain_b)):
            _add(entries[f"{base}_{direction}"], shape, ms, pms,
                 _train_bound_ms(mlp, normals, direction, M),
                 errs["out_abs" if direction == "fwd" else "grad_abs"],
                 rows=M, errors=errs,
                 **(passes if direction == "bwd" else {}))
        print(f"{tag} {shape:6s} M={M} {'k3' if normals else 'k2'} "
              f"C={ndc}: fwd {ms_f:.3f} ms (plain {plain_f:.3f}, bound "
              f"{_train_bound_ms(mlp, normals, 'fwd', M):.4f}), bwd "
              f"{ms_b:.3f} ms (plain {plain_b:.3f}, bound "
              f"{_train_bound_ms(mlp, normals, 'bwd', M):.4f}) = row "
              f"pass {ms_r:.4f} ms (its bound {bound_r:.4f}) + weight "
              f"gradients {wg['ms']:.4f} ms (its bound {wg['bound']:.4f}, "
              f"torch.matmul {wg['library_ms']:.4f}, rel vs plain "
              f"{wg['rel']:.2e}, vs f32 {wg['rel_f32']:.2e}); errors "
              + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + "; tolerances " + json.dumps(TRAIN_TOL)
              + f", wgrad_rel {WGRAD_TOL}", flush=True)
    if failures:
        raise AssertionError("training kernel disagrees with its plain "
                             "version: " + "; ".join(failures))
    return [e for e in entries.values() if e["per_shape"]]


# Kernel 5's weights are held tighter than the eval render's: at S = 56 a
# typical weight is at most acc / 56 (about 0.018), and the backward
# recomputes the weights inside the kernel, so only this check sees the
# written ones. 2e-3 is a tenth of that; bf16 rounding of the density head
# moves a weight by far less (under 3e-4 on an H100 at both shapes).
K5_TOL = dict(rgb=2e-2, distance=2e-2, acc=1e-2, weights=2e-3,
              grad_rel=2e-2, dmc_rel=5e-2, dcov_rel=5e-2, dt_rel=5e-2)
K5_OUTS = ("rgb", "distance", "acc", "weights")


def _level_grads(fn, mlp, args, coef, **kw):
    """A train level's outputs and the gradients of a random-coefficient
    loss on all four, the weights included (a mean over the rays), w.r.t.
    the parameters (flat), the means, the t_samples and the covariances."""
    import torch
    mlp.zero_grad(set_to_none=True)
    m = args[0].detach().clone().requires_grad_(True)
    cv = args[1].detach().clone().requires_grad_(True)
    t = args[3].detach().clone().requires_grad_(True)
    out = fn(mlp, m, cv, args[2], t, args[4], **kw)
    loss = sum(torch.sum(out[k] * c) for k, c in coef.items())
    (loss / m.shape[0]).backward()
    flat = torch.cat([p.grad.reshape(-1) for p in mlp.parameters()])
    mlp.zero_grad(set_to_none=True)
    return ({k: v.detach() for k, v in out.items()}, flat, m.grad, t.grad,
            cv.grad)


def check_train_render_kernel(model, dev, levels, wentry: dict,
                              sfx: str = "", tag: str = "[kernel]",
                              spills=(False, True)) -> list:
    """Kernel 5 (forward and backward, `save_acts` off and on, or as
    `spills` says) vs its plain version at the coarse (512 x 56) and env
    (5,120 x 5) levels of one key-on train step, and the weight-gradient
    pass on its operand rows (into `wentry`; into its sums only without
    `sfx`); raises on a disagreement or when the spilled and recomputed
    runs differ. Returns the two JSON entries, named with `sfx`."""
    import types
    import torch
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    from pano_nerf_tpu_torch.kernels.fused_render import pack_params
    mlp, cfg = model.mlp, model.cfg
    kw = dict(min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point,
              deg_view=cfg.deg_view, density_bias=cfg.density_bias,
              rgb_padding=cfg.rgb_padding, white_bkgd=False)
    packed = pack_params(mlp)
    mshape = k2.build_of(mlp)
    fwd = _entry("fused_render_train_fwd" + sfx, "fused_render_train.cu",
                 "fused_render_train.py:358")
    bwd = _entry("fused_render_train_bwd" + sfx, "fused_render_train.cu",
                 "fused_render_train.py:399")
    failures = []
    g = torch.Generator(device=dev).manual_seed(13)
    for shape, args in levels.items():
        R, S = args[0].shape[:2]
        coef = {k: torch.randn(sh, generator=g, device=dev) for k, sh in (
            ("rgb", (R, 3)), ("acc", (R,)), ("distance", (R,)),
            ("weights", (R, S)))}
        want, gp_want, gm_want, gt_want, gc_want = _level_grads(
            k5.fused_render_train_reference, mlp, args, coef, **kw)
        runs = {}
        for save_acts in spills:
            runs[save_acts] = _level_grads(k5.fused_render_train, mlp, args,
                                           coef, save_acts=save_acts,
                                           packed=packed, **kw)
        torch.cuda.synchronize()
        errs = {}
        for save_acts, (got, gp, gm, gt, gc) in runs.items():
            run = "_spill" if save_acts else ""
            for k in K5_OUTS:
                errs[k + run] = float((got[k] - want[k]).abs().max())
                if not errs[k + run] <= K5_TOL[k]:
                    failures.append(f"{shape}.{k}{run}: "
                                    f"{errs[k + run]:.3e} > {K5_TOL[k]}")
            for k, (a, b) in dict(grad_rel=(gp, gp_want),
                                  dmc_rel=(gm, gm_want),
                                  dcov_rel=(gc, gc_want),
                                  dt_rel=(gt, gt_want)).items():
                errs[k + run] = _rel(a, b)
                if not errs[k + run] <= K5_TOL[k]:
                    failures.append(f"{shape}.{k}{run}: "
                                    f"{errs[k + run]:.3e} > {K5_TOL[k]}")
            errs["grad_abs" + run] = float((gp - gp_want).abs().max())
        same = len(runs) < 2 or all(
            torch.equal(runs[False][0][k], runs[True][0][k]) for k in want
        ) and torch.equal(runs[False][2], runs[True][2])
        if not same:
            failures.append(f"{shape}: save_acts changed the outputs or "
                            "the moment gradients")

        # Timing: the launches alone on the wrapper's inputs, then the
        # plain version's forward and autograd backward.
        lv = k5.Level(R, S, cfg.min_deg_point, cfg.density_bias,
                      cfg.rgb_padding, False, mshape)
        with torch.no_grad():
            mc, clip, v = k5.level_rows(*args, cfg.deg_view)
        g_out = _cotangent((R, k5.OUT8), 19, dev)
        g_w = _cotangent((R, S), 20, dev)
        dummy = types.SimpleNamespace(backward_launches=0)
        ms = {}
        tiles = k5.kernel_library(mshape).fused_render_train_blocks(R, S)
        for save_acts in spills:
            ms["fwd", save_acts] = time_ms(lambda: k5.launch_forward(
                mc, clip, v, *packed, lv, save_acts), reps=20)
            acts = k5.launch_forward(mc, clip, v, *packed, lv, save_acts)[2]
            ms["bwd", save_acts] = time_ms(lambda: k5.run_backward(
                dummy, mlp, mc, clip, v, *packed, acts, g_out, g_w, lv),
                reps=10)
            # The row pass alone, then (once) the weight-gradient pass on
            # the operand rows it wrote.
            ops, _, db_r = k2.backward_buffers(k2.kernel_library(mshape),
                                               *packed, tiles * k5.TILE_ROWS,
                                               False)
            dmc_r = torch.empty((R * S, 8), device=dev)
            ms["rows", save_acts] = time_ms(lambda: k5.launch_backward_rows(
                mc, clip, v, *packed, acts, g_out, g_w, lv, ops, dmc_r, db_r),
                reps=10)
            if not save_acts:
                wg = check_weight_grads(mlp, ops, False, R * S, wentry,
                                        f"k5{sfx}_{shape}", failures,
                                        total=sfx == "")
            del acts, ops, db_r, dmc_r
        with torch.no_grad():
            plain_f = time_ms(lambda: k5.fused_render_train_reference(
                mlp, *args, **kw), reps=3)
        m_req = args[0].detach().clone().requires_grad_(True)
        outs = list(k5.fused_render_train_reference(
            mlp, m_req, *args[1:], **kw).values())
        cot = [torch.randn_like(o) for o in outs]
        plain_b = time_ms(lambda: torch.autograd.grad(
            outs, list(mlp.parameters()) + [m_req], cot, retain_graph=True),
            reps=3)
        del outs
        rows = R * S
        per_ray = R * (2 + k5.OUT8 + S) * 4   # clip in; out, weights out
        w_bytes = _weight_bytes(mlp, False)
        m = row_macs(mlp)
        mlp_m, trunk = m["mlp"], m["trunk"]
        spill = 8 * mlp.net_width * 2
        row_in = 32 + _v_bytes(mlp)   # moments and viewdir codes
        bounds = {("fwd", False): _bound(mlp_m * rows,
                                         rows * row_in + per_ray + w_bytes),
                  ("bwd", False): _bound(3 * mlp_m * rows,
                                         rows * (row_in + 32) + per_ray
                                         + _weight_bytes(mlp, True))}
        bounds["fwd", True] = _bound(mlp_m * rows, rows * (row_in + spill)
                                     + per_ray + w_bytes)
        bounds["bwd", True] = _bound((3 * mlp_m - trunk) * rows,
                                     rows * (row_in + 32 + spill) + per_ray
                                     + _weight_bytes(mlp, True))
        # Real rows, not idle tile rows.
        ops_bytes = rows * _own_ops_width(mlp, False) * 2
        for save_acts in (False, True):
            bounds["rows", save_acts] = _bound(
                (2 * mlp_m - (trunk if save_acts else 0)) * rows,
                rows * (row_in + 32 + (spill if save_acts else 0)) + per_ray
                + ops_bytes + w_bytes)
        spilled = {k: v for k, v in (
            ("ms_save_acts", ms.get(("fwd", True))),
            ("bound_ms_save_acts", bounds["fwd", True])) if True in spills}
        spill_ms = lambda k: (f"{ms[k, True]:.3f}" if True in spills
                              else "not run")
        spilled_b = {} if True not in spills else dict(
            ms_save_acts=ms["bwd", True],
            bound_ms_save_acts=bounds["bwd", True],
            row_ms_save_acts=ms["rows", True],
            row_bound_ms_save_acts=bounds["rows", True])
        _add(fwd, shape, ms["fwd", False], plain_f, bounds["fwd", False],
             max(v for k, v in errs.items() if k in K5_OUTS), R=R, S=S,
             errors=errs, **spilled)
        _add(bwd, shape, ms["bwd", False], plain_b, bounds["bwd", False],
             max(v for k, v in errs.items() if k.startswith("grad_abs")),
             R=R, S=S, row_ms=ms["rows", False],
             row_bound_ms=bounds["rows", False], wgrad_ms=wg["ms"],
             wgrad_bound_ms=wg["bound"], wgrad_library_ms=wg["library_ms"],
             **spilled_b)
        print(f"{tag} {shape:6s} R={R} S={S} k5: fwd {ms['fwd', False]:.3f}"
              f" ms (save_acts {spill_ms('fwd')}; plain {plain_f:.3f}, "
              f"bound {bounds['fwd', False]:.4f}), bwd "
              f"{ms['bwd', False]:.3f} ms (save_acts {spill_ms('bwd')}; "
              f"plain {plain_b:.3f}, bound {bounds['bwd', False]:.4f}) = "
              f"row pass {ms['rows', False]:.4f} ms (save_acts "
              f"{spill_ms('rows')}; its bound "
              f"{bounds['rows', False]:.4f} / {bounds['rows', True]:.4f}) + "
              f"weight gradients {wg['ms']:.4f} ms (its bound "
              f"{wg['bound']:.4f}, torch.matmul {wg['library_ms']:.4f}, "
              f"rel vs plain {wg['rel']:.2e}, vs f32 {wg['rel_f32']:.2e}); "
              f"spilled == recomputed: {same}; errors "
              + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + "; tolerances " + json.dumps(K5_TOL),
              flush=True)
    if failures:
        raise AssertionError("fused_render_train disagrees with its plain "
                             "version: " + "; ".join(failures))
    return [fwd, bwd]


K1_TOL = dict(out_abs=2e-2, grad_rel=2e-2, dx_rel=5e-2)


def check_fused_mlp_kernel(model, dev, levels, wentry: dict,
                           sfx: str = "", tag: str = "[kernel]") -> list:
    """Kernel 1 (forward and backward) vs its plain version on the IPE
    features of the coarse level's 28,672 rows, and the weight-gradient
    pass on its operand rows (into `wentry`; into its sums only without
    `sfx`); raises on a disagreement. Returns the two JSON entries, named
    with `sfx` (no model path launches kernel 1)."""
    import types
    import torch
    from pano_nerf_tpu_torch.kernels import fused_mlp as k1
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels.fused_render import pack_params
    from pano_nerf_tpu_torch.ops import mip
    mlp, cfg = model.mlp, model.cfg
    shape = k2.build_of(mlp)
    X, V = mlp.xyz_dim, mlp.view_dim
    means, covs, viewdirs = levels["coarse"][:3]
    with torch.no_grad():
        x = mip.integrated_pos_enc(means, covs, cfg.min_deg_point,
                                   cfg.max_deg_point).reshape(-1, X)
        v_enc = model._venc(viewdirs)
        v_enc = v_enc.expand(*means.shape[:2], V).reshape(-1, V)
    x, v_enc = x.contiguous(), v_enc.contiguous()
    M = x.shape[0]
    packed = pack_params(mlp)
    res = []
    for fn in (k1.fused_mlp_apply, k1.fused_mlp_apply_reference):
        mlp.zero_grad(set_to_none=True)
        xr = x.clone().requires_grad_(True)
        outs = fn(mlp, xr, v_enc)
        ((torch.sin(outs[0]).sum() + torch.cos(outs[1]).sum()) / M
         ).backward()
        res.append(([o.detach() for o in outs], torch.cat(
            [p.grad.reshape(-1) for p in mlp.parameters()]), xr.grad))
    mlp.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    (got, gp, gx), (want, gp_want, gx_want) = res
    errs = dict(out_abs=max(float((a - b).abs().max())
                            for a, b in zip(got, want)),
                grad_rel=_rel(gp, gp_want), dx_rel=_rel(gx, gx_want),
                grad_abs=float((gp - gp_want).abs().max()))
    failures = [f"{k}: {errs[k]:.3e} > {tol}" for k, tol in K1_TOL.items()
                if not errs[k] <= tol]

    XF = shape.XF
    xb = torch.nn.functional.pad(x, (0, XF - X)).to(torch.bfloat16)
    v = k2.viewdir_rows(v_enc, (M,))
    g = _cotangent((M, k2.OUT_W), 22, dev)
    dummy = types.SimpleNamespace(backward_launches=0)
    ms_f = time_ms(lambda: k1.launch_forward(xb, v, *packed, shape),
                   reps=20)
    ms_b = time_ms(lambda: k1.run_backward(dummy, mlp, xb, v, *packed, g),
                    reps=10)
    lib = k2.kernel_library(shape)
    ops, _, db_r = k2.backward_buffers(lib, *packed, k2.tile_rows(lib, M),
                                       False)
    dx_r = torch.empty((M, XF), device=dev)
    ms_r = time_ms(lambda: k1.launch_backward_rows(xb, v, *packed, g, ops,
                                                    dx_r, db_r, shape),
                   reps=10)
    mlp_m = row_macs(mlp)["mlp"]
    # bf16 x and viewdir codes, f32 outputs (64 B) in; f32 d x out.
    io = 2 * XF + _v_bytes(mlp) + 64
    bound_r = _bound(2 * mlp_m * M, M * (io + 4 * XF)
                     + M * _own_ops_width(mlp, False) * 2
                     + _weight_bytes(mlp, False))
    wg = check_weight_grads(mlp, ops, False, M, wentry, f"k1{sfx}_coarse",
                            failures, total=sfx == "")
    del ops, db_r, dx_r
    with torch.no_grad():
        plain_f = time_ms(lambda: k1.fused_mlp_apply_reference(
            mlp, x, v_enc), reps=3)
    x_req = x.clone().requires_grad_(True)
    outs = k1.fused_mlp_apply_reference(mlp, x_req, v_enc)
    cot = [torch.randn_like(o) for o in outs]
    plain_b = time_ms(lambda: torch.autograd.grad(
        outs, list(mlp.parameters()) + [x_req], cot, retain_graph=True),
        reps=3)
    del outs
    bound_f = _bound(mlp_m * M, M * io + _weight_bytes(mlp, False))
    bound_b = _bound(3 * mlp_m * M, M * (io + 4 * XF)
                     + _weight_bytes(mlp, True))
    fwd = _entry("fused_mlp_apply_fwd" + sfx, "fused_mlp.cu",
                 "fused_mlp.py:223")
    bwd = _entry("fused_mlp_apply_bwd" + sfx, "fused_mlp.cu",
                 "fused_mlp.py:328")
    _add(fwd, "coarse", ms_f, plain_f, bound_f, errs["out_abs"], rows=M,
         errors=errs)
    _add(bwd, "coarse", ms_b, plain_b, bound_b, errs["grad_abs"], rows=M,
         row_ms=ms_r, row_bound_ms=bound_r, wgrad_ms=wg["ms"],
         wgrad_bound_ms=wg["bound"], wgrad_library_ms=wg["library_ms"])
    print(f"{tag} coarse M={M} k1: fwd {ms_f:.3f} ms (plain "
          f"{plain_f:.3f}, bound {bound_f:.4f}), bwd {ms_b:.3f} ms (plain "
          f"{plain_b:.3f}, bound {bound_b:.4f}) = row pass {ms_r:.4f} ms "
          f"(its bound {bound_r:.4f}) + weight gradients {wg['ms']:.4f} ms "
          f"(its bound {wg['bound']:.4f}, torch.matmul "
          f"{wg['library_ms']:.4f}, rel vs plain {wg['rel']:.2e}, vs f32 "
          f"{wg['rel_f32']:.2e}); errors "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + "; tolerances " + json.dumps(K1_TOL), flush=True)
    if failures:
        raise AssertionError("fused_mlp_apply disagrees with its plain "
                             "version: " + "; ".join(failures))
    return [fwd, bwd]


def check_other_shape_kernels(env, dev, wentry: dict) -> dict:
    """Phase 2w: each build of `OTHER_SHAPES` against its plain versions
    on the card at phase 2's tolerances, weights from seed 0: at A, B, H
    and H2 kernel 4 at the eval path's three shapes, kernels 2 and 3
    (forward and backward: parameters, means, covariances) at a
    batch-512 train step's four calls, kernel 5 (`save_acts` off) at its
    coarse and env levels, and at A, H and H2 kernel 1 at 28,672 rows; at
    C (mip-NeRF) kernels 2 and 3 at a batch-2048 train step's 131,072
    rows. As at D, H2's kernel-3 moment and covariance gradients are held
    on the check loss without its density-gradient term
    (`check_train_kernels` `dsig_free_moments`: the 512-wide fine level's
    bf16 moment gradient moves far from f32 on the whole loss). Each with
    its ms per launch beside the bound from the shape's own MACs and bytes
    (the weight-gradient pass into `wentry`, out of its sums). Returns the
    JSON entries by shape, named with `_w<shape>`."""
    import torch
    entries = {}
    for name in OTHER_SHAPES:
        sfx, tag = f"_w{name}", f"[kernel-w{name}]"
        model = shape_model(name, dev)
        if name == "C":
            calls = {k: v for k, v in mip_shapes(model, dev).items()
                     if k.startswith("train")}
            entries[name] = check_train_kernels(model, dev, calls, wentry,
                                                ndc=1, tag=tag, sfx=sfx)
            continue
        with torch.no_grad():
            got = [check_kernels(model, env, dev,
                                 shapes=main_path_inputs(model, env, dev),
                                 sfx=sfx, tag=tag)]
        calls, levels, _ = train_shapes(model, env, dev)
        got += check_train_kernels(model, dev, calls, wentry, tag=tag,
                                   sfx=sfx, dsig_free_moments=name == "H2")
        got += check_train_render_kernel(model, dev, levels, wentry,
                                         sfx=sfx, tag=tag, spills=(False,))
        if name in ("A", "H", "H2"):
            got += check_fused_mlp_kernel(model, dev, levels, wentry,
                                          sfx=sfx, tag=tag)
        entries[name] = got
        del model, calls, levels
    return entries


def padded_macs(mlp) -> dict:
    """MACs per sample row of `mlp` (`row_macs`) and of the build it runs
    in, with the model's share of the build's."""
    import types
    from pano_nerf_tpu_torch.kernels import shapes
    b = shapes.build_of(mlp)
    built = types.SimpleNamespace(
        net_width=b.W, net_width_condition=b.VW, xyz_dim=mlp.xyz_dim,
        view_dim=mlp.view_dim, num_density_channels=mlp.num_density_channels)
    own, wide = row_macs(mlp)["mlp"], row_macs(built)["mlp"]
    return dict(model_macs_per_row=own, build_macs_per_row=wide,
                build=f"W={b.W} VW={b.VW} C={b.C}", share=own / wide)


def check_padded_slots(model, calls, levels, k1: bool, tag: str,
                       with_k5: bool = True) -> None:
    """Every backward of the wrappers (kernels 2 and 3 at `calls`, kernel
    5 at `levels` with `with_k5`, kernel 1 with `k1` on the coarse level's
    rows) on a model padded into a wider
    build: the packed weight gradients (rounded to bf16, as the step
    takes them) and bias gradients in the slots the build pads
    (`fused_render.padded_slots`) must be exactly 0."""
    import torch
    from pano_nerf_tpu_torch.kernels import fused_mlp as k1m
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    from pano_nerf_tpu_torch.kernels.fused_render import (pack_params,
                                                          padded_slots)
    from pano_nerf_tpu_torch.ops import mip
    mlp, cfg = model.mlp, model.cfg
    w_pad, b_pad = padded_slots(mlp)
    packed = pack_params(mlp)
    kw = dict(min_deg=cfg.min_deg_point, max_deg=cfg.max_deg_point)
    seen, unpack = [], k2.unpack_params

    def spy(m, weights, biases):
        if m is mlp:
            seen.append(torch.stack([weights[w_pad].abs().max(),
                                     biases[b_pad].abs().max()]))
        return unpack(m, weights, biases)

    k2.unpack_params = spy
    try:
        for normals, means, covs, v_enc in calls.values():
            fn = (k3.fused_mlp_normals_apply if normals
                  else k2.fused_mlp_ipe_apply)
            _outs_and_grads(fn, mlp, means, covs, v_enc, packed=packed, **kw)
        g = torch.Generator(device="cuda").manual_seed(23)
        for args in levels.values() if with_k5 else ():
            R, S = args[0].shape[:2]
            coef = {k: torch.randn(sh, generator=g, device=args[0].device)
                    for k, sh in (("rgb", (R, 3)), ("acc", (R,)),
                                  ("distance", (R,)), ("weights", (R, S)))}
            _level_grads(k5.fused_render_train, mlp, args, coef,
                         deg_view=cfg.deg_view,
                         density_bias=cfg.density_bias,
                         rgb_padding=cfg.rgb_padding, white_bkgd=False,
                         packed=packed, **kw)
        if k1:
            means, covs, viewdirs = levels["coarse"][:3]
            with torch.no_grad():
                x = mip.integrated_pos_enc(means, covs, **kw).reshape(
                    -1, mlp.xyz_dim).contiguous()
                v = model._venc(viewdirs).expand(
                    *means.shape[:2], mlp.view_dim).reshape(
                        -1, mlp.view_dim).contiguous()
            mlp.zero_grad(set_to_none=True)
            out = k1m.fused_mlp_apply(mlp, x.requires_grad_(True), v,
                                      packed=packed)
            (out[0].sum() + out[1].sum()).backward()
            mlp.zero_grad(set_to_none=True)
    finally:
        k2.unpack_params = unpack
    worst = float(torch.stack(seen).max()) if seen else float("nan")
    print(f"{tag} padded gradient slots ({int(w_pad.sum())} weights, "
          f"{int(b_pad.sum())} biases of the packed layout) over "
          f"{len(seen)} backwards: largest |value| {worst:.3e} (must be "
          f"exactly 0)", flush=True)
    want = len(calls) + len(levels) * with_k5 + int(k1)
    if len(seen) != want:
        raise AssertionError(f"{len(seen)} backwards seen, expected {want}")
    hold(f"{tag} padded gradient slots", worst, 0.0)


def check_padded_kernels(env, dev, wentry: dict) -> dict:
    """Phase 2x: every kernel at P1 and P2 against its plain version at
    the model's own width (the unpadded NerfMLP) at phase 2's tolerances,
    forward and backward (parameters, means, covariances), weights from
    seed 0: at P1 kernel 4 at the eval path's three shapes, kernels 2 and
    3 at a batch-512 step's four calls, kernel 5 (`save_acts` off) at its
    coarse and env levels and kernel 1 at 28,672 rows; at P2 kernels 4,
    5 and 1 likewise and kernels 2 and 3 at mip-NeRF's one density
    channel (P2m, phase 23m's build) on a batch-2048 step's 131,072 rows.
    The padded gradient slots read exactly 0 (`check_padded_slots`).
    Each time beside the bound of the model's own MACs and bytes, the
    build's MACs beside them (the entries' `padded`). Returns the JSON
    entries by shape, named with `_pP1`, `_pP2`."""
    import torch
    entries = {}
    for name in ("P1", "P2"):
        sfx, tag = f"_p{name}", f"[kernel-p{name}]"
        model = shape_model(name, dev)
        macs = padded_macs(model.mlp)
        print(f"{tag} MACs per row: model {macs['model_macs_per_row']:,}, "
              f"build ({macs['build']}) {macs['build_macs_per_row']:,}: "
              f"{100 * macs['share']:.1f}% of the build's", flush=True)
        with torch.no_grad():
            got = [check_kernels(model, env, dev,
                                 shapes=main_path_inputs(model, env, dev),
                                 sfx=sfx, tag=tag)]
        calls, levels, _ = train_shapes(model, env, dev)
        if name == "P1":
            got += check_train_kernels(model, dev, calls, wentry, tag=tag,
                                       sfx=sfx)
        got += check_train_render_kernel(model, dev, levels, wentry,
                                         sfx=sfx, tag=tag, spills=(False,))
        got += check_fused_mlp_kernel(model, dev, levels, wentry, sfx=sfx,
                                      tag=tag)
        check_padded_slots(model, calls if name == "P1" else {}, levels,
                           True, tag)
        for e in got:
            e["padded"] = macs
        if name == "P2":
            mip_model = shape_model("P2m", dev)
            mcalls = {k: v for k, v in mip_shapes(mip_model, dev).items()
                      if k.startswith("train")}
            mmacs = padded_macs(mip_model.mlp)
            print(f"{tag} mip-NeRF MACs per row: model "
                  f"{mmacs['model_macs_per_row']:,}, build "
                  f"({mmacs['build']}) {mmacs['build_macs_per_row']:,}: "
                  f"{100 * mmacs['share']:.1f}%", flush=True)
            mip_entries = check_train_kernels(mip_model, dev, mcalls, wentry,
                                              ndc=1, tag=tag, sfx=sfx)
            check_padded_slots(mip_model, mcalls, {}, False, tag + "[mip]")
            for e in mip_entries:
                e["padded"] = mmacs
            got += mip_entries
            del mip_model, mcalls
        entries[name] = got
        del model, calls, levels
    return entries


def check_wide_kernels(env, dev, wentry: dict) -> dict:
    """Phase 2y: every kernel of the 512 / 256 builds against its plain
    version on the card at phase 2's tolerances, forward and backward
    (each backward also as its two passes; the weight-gradient pass
    against `weight_grads_reference` at WGRAD_TOL, torch.matmul beside
    it), weights from seed 0: at D kernel 4 at the eval path's three
    shapes, kernels 2 and 3 at a batch-512 train step's four calls,
    kernel 5 (`save_acts` off and on) at its coarse and env levels and
    kernel 1 at 28,672 rows; at Dm (mip-NeRF, one density channel)
    kernels 2 and 3 at a batch-2048 step's 131,072 rows and an eval
    chunk's 262,144; at P3 (384 / 192, zero-padded into D's build) kernels
    4, 2, 3, 5 and 1 likewise at the model's own width, the padded
    gradient slots exactly 0 (`check_padded_slots`). At D kernel 3's
    moment and covariance gradients are held on the loss without its
    density-gradient term (`check_train_kernels` `dsig_free_moments`).
    Each time beside the bound of the model's own MACs and bytes. Returns
    the JSON entries by shape, named with `_wD`, `_wDm`, `_pP3`."""
    import torch
    entries = {}
    for name in ("D", "P3"):
        sfx = f"_w{name}" if name == "D" else f"_p{name}"
        tag = f"[kernel{sfx[1:]}]"
        model = shape_model(name, dev)
        macs = padded_macs(model.mlp)
        print(f"{tag} MACs per row: model {macs['model_macs_per_row']:,}, "
              f"build ({macs['build']}) {macs['build_macs_per_row']:,}",
              flush=True)
        with torch.no_grad():
            got = [check_kernels(model, env, dev,
                                 shapes=main_path_inputs(model, env, dev),
                                 sfx=sfx, tag=tag)]
        calls, levels, _ = train_shapes(model, env, dev)
        got += check_train_kernels(model, dev, calls, wentry, tag=tag,
                                   sfx=sfx, dsig_free_moments=name == "D")
        got += check_train_render_kernel(
            model, dev, levels, wentry, sfx=sfx, tag=tag,
            spills=(False, True) if name == "D" else (False,))
        got += check_fused_mlp_kernel(model, dev, levels, wentry, sfx=sfx,
                                      tag=tag)
        if name == "P3":
            check_padded_slots(model, calls, levels, True, tag)
            for e in got:
                e["padded"] = macs
        entries[name] = got
        del model, calls, levels
    model = shape_model("Dm", dev)
    entries["Dm"] = check_train_kernels(
        model, dev, mip_shapes(model, dev), wentry, ndc=1,
        forward_only=MIP_EVAL, tag="[kernel-wDm]", sfx="_wDm")
    del model
    return entries


def check_pair_kernels(env, dev, wentry: dict) -> dict:
    """Phase 2z: every kernel of the 1,024 builds (each tile on a cluster
    of two CTAs) against its plain version on the card at phase 2's
    tolerances, forward and backward (each backward also as its two
    passes; the weight-gradient pass against `weight_grads_reference` at
    WGRAD_TOL, torch.matmul beside it), weights from seed 0: at E kernel
    4 at the eval path's three shapes, kernels 2 and 3 at a batch-512
    train step's four calls, kernel 5 (`save_acts` off and on) at its
    coarse and env levels and kernel 1 at 28,672 rows; at Em (mip-NeRF
    360's 1,024 / 128, one density channel) kernels 2 and 3 at a
    batch-2048 step's 131,072 rows and an eval chunk's 262,144; at P4
    (768 / 384, zero-padded into E's build) kernels 4, 2, 3, 5 and 1
    likewise at the model's own width, the padded gradient slots exactly
    0 (`check_padded_slots`). As at
    D, E's and Em's kernel-3 moment and covariance gradients are held on
    the loss without its density-gradient term (`check_train_kernels`
    `dsig_free_moments`), and on the whole loss no further from the f32
    plain version's than the bf16 plain version's are
    (`WHOLE_F32_RATIO`; `scripts/torch_k3_conditioning.py`), so the two
    bf16 versions' distance there is rounding. P4 holds them on the whole
    loss, as P3 and Dm. Each time
    beside the bound of the model's own MACs and bytes. Returns the JSON
    entries by shape, named with `_wE`, `_wEm`, `_pP4`."""
    import torch
    entries = {}
    for name in ("E", "P4"):
        sfx = f"_w{name}" if name == "E" else f"_p{name}"
        tag = f"[kernel{sfx[1:]}]"
        model = shape_model(name, dev)
        macs = padded_macs(model.mlp)
        print(f"{tag} MACs per row: model {macs['model_macs_per_row']:,}, "
              f"build ({macs['build']}) {macs['build_macs_per_row']:,}",
              flush=True)
        with torch.no_grad():
            got = [check_kernels(model, env, dev,
                                 shapes=main_path_inputs(model, env, dev),
                                 sfx=sfx, tag=tag)]
        calls, levels, _ = train_shapes(model, env, dev)
        got += check_train_kernels(model, dev, calls, wentry, tag=tag,
                                   sfx=sfx, dsig_free_moments=name == "E")
        got += check_train_render_kernel(model, dev, levels, wentry,
                                         sfx=sfx, tag=tag)
        got += check_fused_mlp_kernel(model, dev, levels, wentry, sfx=sfx,
                                      tag=tag)
        if name == "P4":
            check_padded_slots(model, calls, levels, True, tag)
            for e in got:
                e["padded"] = macs
        entries[name] = got
        del model, calls, levels
    model = shape_model("Em", dev)
    entries["Em"] = check_train_kernels(
        model, dev, mip_shapes(model, dev), wentry, ndc=1,
        forward_only=MIP_EVAL, tag="[kernel-wEm]", sfx="_wEm",
        dsig_free_moments=True)
    del model
    return entries


TRAIN_STEPS = 200
MIP_ORT_STEPS = 24   # phase 8c: the orientation-loss variant
# The shadow preset's tie falls from `loss.env_distill_end` 0.7 of the run
# over `_fall` 0.15: steps 140-170 of 200. Phase 10 holds 16 graphed
# steps from this step against eager ones, across that edge.
SHADOW_WINDOW = int(0.7 * TRAIN_STEPS) - 4


# Kernel launches of one train step. Pano-NeRF: kernel 2 for coarse, view
# consistency and env, 1 for view consistency alone with the key on,
# kernel 5 taking coarse and env; kernel 3 for the fine level; the
# presets add kernel 2 for the tight re-read (`tight`, which also keeps
# the env march off kernel 5) and, forward only, the env-distill march
# (`distill`). The study switches: density noise (`noise`) keeps kernel 5
# off both levels; the importance probe (`probe`) is a kernel-2 forward;
# env_resample (`resample`) runs the placing env march as a kernel-2
# forward and the resampled one forward and backward (the tight re-read
# and kernel 5 then skip the env); point normals (`point`) move the fine
# level to kernel 2 and keep one kernel-3 pair for the point query.
# mip-NeRF: kernel 2 for both levels, or for the coarse one and kernel 3
# for the fine one with the orientation loss (`ort`). Each backward is
# two launches, the row pass and the weight-gradient pass; no model path
# calls kernel 1.
#
# `levels` (`nerf.num_levels`): every level before Pano-NeRF's fine one
# is a coarse-like level (kernel 5 with the key on, else kernel 2); at one
# level there is no fine level, so no kernel 3, view consistency or env
# march. `vc`: the view-consistency re-query, off with
# `train.randomized: false` (as the draws-dependent switches are).
def per_step_launches(render_kernel: bool, mip: bool = False,
                      ort: bool = False, tight: bool = False,
                      distill: bool = False, noise: bool = False,
                      probe: bool = False, resample: bool = False,
                      point: bool = False, levels: int = 2,
                      vc: bool = True) -> dict:
    fwd_only = 0
    if mip:
        fwd = dict(fused_mlp_ipe_fwd=levels - 1 if ort else levels,
                   fused_mlp_normals_fwd=1 if ort else 0,
                   fused_render_train_fwd=0, fused_mlp_apply_fwd=0)
    else:
        k5 = render_kernel and not noise
        fine = levels >= 2
        env_k5 = fine and k5 and not tight and not resample
        before = levels - fine
        fwd = dict(fused_mlp_ipe_fwd=(before * (not k5) + fine * (
            vc + (not env_k5) + (tight and not resample) + point)),
                   fused_mlp_normals_fwd=int(fine),
                   fused_render_train_fwd=before * k5 + env_k5,
                   fused_mlp_apply_fwd=0)
        fwd_only = fine * (distill + probe + resample)
    want = dict(fwd)
    for k, n in fwd.items():
        want[k.replace("_fwd", "_bwd")] = 2 * n
    want["fused_mlp_weight_grads"] = sum(fwd.values())
    want["fused_mlp_ipe_fwd"] += fwd_only
    return want


def _family(system) -> dict:
    """What the checks need to know of a system: its tag suffix, its
    launches per train step and per val panorama."""
    cfg = system.model.cfg
    mip = not system.surface
    rnd = system.train_randomized
    ort = mip and system.hparams["loss.ort_loss"] > 0
    k5 = cfg.use_train_render_kernel and not mip
    tight = cfg.env_tight_rgb > 0
    distill = cfg.env_distill_samples > 0 and rnd
    study = dict(noise=cfg.density_noise > 0 and rnd,
                 probe=cfg.env_mode() == "importance" and rnd,
                 resample=cfg.env_resample, point=cfg.point_normals)
    sfx = ("-mip" + ("-ort" if ort else "")) if mip else (
        ("-k5" if k5 else "") + ("-shadow" if distill else "-hdr" if tight
                                 else ""))
    if not mip and (cfg.env_mode() != "fixed" or cfg.illum_field
                    or any(study.values())):
        sfx += "-" + cfg.env_mode() + "".join(
            f"-{k}" for k, on in (("resample", cfg.env_resample),
                                  ("illum", cfg.illum_field),
                                  ("point", cfg.point_normals),
                                  ("noise", study["noise"])) if on)
    elif mip and cfg.density_noise > 0 and rnd:
        sfx += "-noise"
    sfx += "".join(tag for tag, on in (
        (f"-L{cfg.num_levels}", cfg.num_levels != 2),
        ("-nostop", not cfg.stop_resample_grad),
        ("-noint", cfg.disable_integration), ("-det", not rnd),
        ("-valrnd", system.val_randomized)) if on)
    per_pano = eval_launches(MIP_CONFIG if mip else HDR_CONFIG if tight
                             else CONFIG, cfg.env_resample, cfg.num_levels)
    if not system.model.kernels:   # the plain route launches no kernel
        zero = dict.fromkeys(per_step_launches(False), 0)
        return dict(mip=mip, k5=False, sfx=sfx + "-plain", per_pano=zero,
                    per_step=zero)
    per_step = per_step_launches(k5, mip, ort, tight, distill, **study,
                                 levels=cfg.num_levels, vc=rnd)
    from pano_nerf_tpu_torch.engine.losses import use_scale_distill
    if use_scale_distill(system.hparams):
        # The re-march: one more kernel-2 forward and backward.
        sfx += "-sd"
        for k, n in (("fused_mlp_ipe_fwd", 1), ("fused_mlp_ipe_bwd", 2),
                     ("fused_mlp_weight_grads", 1)):
            per_step[k] += n
    return dict(mip=mip, k5=k5, sfx=sfx, per_pano=per_pano,
                per_step=per_step)


@clocked
def drive_train_path(workdir: str, scene: str,
                     render_kernel: bool = False, config: str = CONFIG,
                     opts=(), steps: int = TRAIN_STEPS,
                     name: str = "") -> dict:
    """Train `steps` steps of `config` through the train entry point (3
    train views, 1 val view at train.factor 4, `train.steps_per_call` 8:
    groups of 8 steps and single steps, each dispatch one CUDA graph
    replay), with `nerf.use_train_render_kernel` off or on and the
    overrides `opts`; launch counts zeroed just before and read just
    after, plain versions forbidden, every step's loss recorded (a
    dispatch returns the losses of all its steps); over 200 steps the
    loss must fall."""
    import torch
    from pano_nerf_tpu_torch import train as train_entry
    from pano_nerf_tpu_torch.engine.system import BaseSystem
    from pano_nerf_tpu_torch.kernels import counters
    mip = config == MIP_CONFIG
    name = name or ("mip" if mip else _stem(config) + "train") + (
        "_k5" if render_kernel else "") + (
        "_" + "_".join(str(o) for o in opts).replace(".", "") if opts
        else "")
    out = os.path.join(workdir, name)
    argv = ["--data_path", scene, "--out_dir", out, "--config", config,
            "--init_seed", "0", "train.sample_num", "'n0_1_2'",
            "optimizer.max_steps", str(steps), "log_every_n_step", "50",
            *opts]
    if render_kernel:
        argv += ["nerf.use_train_render_kernel", "True"]
    losses, dispatches, graphs = [], [], []
    make = BaseSystem.make_train_step_device_data

    def recording(self, state, dataset, gen, surf, batch, k=1):
        run = make(self, state, dataset, gen, surf, batch, k)
        graphs.append(run.graph)

        def wrapped(st):
            parts, step_losses = run(st)
            losses.append(step_losses.clone())
            dispatches.append(k)
            return parts, step_losses
        return wrapped

    restore = forbid_plain_versions()
    BaseSystem.make_train_step_device_data = recording
    counters.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer = train_entry.main(argv)
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        launches = counters.launch_counts()
        warmup = dict(counters.WARMUP)
        BaseSystem.make_train_step_device_data = make
        restore()
    family = _family(trainer.system)
    tag = f"[train{family['sfx']}]"
    vals = [float(x) for x in torch.cat(losses).cpu()]
    if len(vals) != steps or sum(dispatches) != steps:
        raise AssertionError(f"{len(vals)} steps ran, expected {steps}")
    replays = sum(g.replays for g in graphs)
    if replays != len(dispatches):
        raise AssertionError(f"{len(dispatches)} dispatches but {replays} "
                             f"graph replays")
    if dispatches.count(8) < steps // 8 - 5:
        raise AssertionError(f"too few 8-step groups: {dispatches}")
    bad = [i for i, x in enumerate(vals) if not x == x or abs(x) == float("inf")]
    if bad:
        raise AssertionError(f"non-finite loss at steps {bad[:10]}")
    first, last = sum(vals[:20]) / 20, sum(vals[-20:]) / 20
    print(f"{tag} {len(dispatches)} dispatches ({dispatches.count(8)} groups "
          f"of 8 steps, {dispatches.count(1)} single steps) through "
          f"{len(graphs)} captured graphs; mean loss of steps 1-20 "
          f"{first:.6f}, of steps {steps - 19}-{steps} {last:.6f}")
    if steps >= TRAIN_STEPS and not last < first:
        raise AssertionError(f"the loss did not fall over {steps} steps")
    # Per step, per val panorama (the sanity pass and the final one), plus
    # what the captures' eager warm-up steps and chunks launched: exact.
    per_step, per_pano = family["per_step"], family["per_pano"]
    for k in launches:
        want = (per_step.get(k, 0) * steps + per_pano.get(k, 0) * 2
                + warmup.get(k, 0))
        if launches[k] != want:
            raise AssertionError(
                f"{k}: {launches[k]} launches in {steps} steps and two "
                f"validations, expected {per_step.get(k, 0)} per step + "
                f"{per_pano.get(k, 0)} per panorama + "
                f"{warmup.get(k, 0)} in warm-ups")
    save_dir = trainer.hparams["save_dir"]
    with open(os.path.join(save_dir, "metrics.jsonl")) as fp:
        recs = [json.loads(line) for line in fp]
    train_recs = [r for r in recs if r["kind"] == "train"]
    vals_recs = [r for r in recs if r["kind"] == "val"]
    if [r["step"] for r in vals_recs] != [0, steps]:
        raise AssertionError(f"validations at {[r['step'] for r in vals_recs]}")
    rps = [r["rays_per_sec"] for r in train_recs]
    batch = int(trainer.hparams["train.batch_size"])
    # The first window includes the captures; report the later ones.
    steady = rps[1:] if len(rps) > 1 else rps
    mean_rps = sum(steady) / len(steady) if steady else None
    rate = ("no 50-step window" if mean_rps is None else
            "train rays/s per 50-step window "
            + ", ".join(f"{x:.1f}" for x in rps)
            + f"; steady {mean_rps:.1f} rays/s = "
            f"{1e3 * batch / mean_rps:.3f} ms per step")
    print(f"{tag} {steps} steps of batch {batch} on "
          f"{trainer.train_dataset.num_rays:,} rays ({wall:.1f} s with "
          f"validation and captures): {rate}; launches "
          + json.dumps(launches)
          + " of which warm-up " + json.dumps(warmup)
          + f"; final val psnr_ldr_vol {vals_recs[-1]['psnr_ldr_vol']:.3f}",
          flush=True)
    return dict(launches=launches, trainer=trainer, rays_per_s=mean_rps,
                losses=vals,
                save_dir=save_dir)


RENDER_FRAMES = 3

# Phases 12-14: `configs/panonerf.yaml` with the study switches (opts,
# kernel 5's key, steps). Phase 12 runs 208 steps so that its freeze and
# the rise of its distill (0.5 of the run: step 104) fall inside an
# 8-step graph (steps 100-107; the log edge at 100 starts a group).
STUDY_PHASES = {
    12: (("nerf.env_sampling", "importance", "nerf.env_resample", "True",
          "nerf.illum_field", "True", "loss.illum_distill", "0.05",
          "loss.illum_distill_start", "0.5", "loss.illum_distill_ramp",
          "0.25", "train.illum_freeze", "0.5"), False, 208),
    13: (("nerf.env_sampling", "stratified", "nerf.point_normals", "True"),
         True, TRAIN_STEPS),
    14: (("nerf.env_rotation", "True", "nerf.density_noise", "1.0"), True,
         TRAIN_STEPS),
}
STUDY_WINDOW = 100   # phase 12's graphed-vs-eager window: steps 100-115


@clocked
def drive_render_path(workdir: str, scene: str, save_dir: str,
                      config: str = CONFIG) -> dict:
    """`python -m pano_nerf_tpu_torch.render_path` (in process) on the
    checkpoint in `save_dir` of a `TRAIN_STEPS`-step run of `config`:
    `RENDER_FRAMES` frames on the path through the 3 training views
    (`--path interp`), 128x256 each through the chunk graph; launch
    counts zeroed just before and read just after, exact (the panorama's
    of `EVAL_LAUNCHES` per frame plus the capture's warm-up), no
    plain-version call; every frame's EXR read back whole and finite,
    its PNG an 8-bit PNG."""
    import numpy as np
    from pano_nerf_tpu_torch import render_path as rp_entry
    from pano_nerf_tpu_torch.data.io_exr import read_exr
    from pano_nerf_tpu_torch.kernels import counters
    out = os.path.join(workdir, _stem(config) + "frames")
    argv = ["--data_path", scene, "--ckpt_dir", save_dir, "--config",
            config, "--out", out, "--n_views", str(RENDER_FRAMES),
            "--path", "interp", "train.sample_num", "'n0_1_2'"]
    restore = forbid_plain_versions()
    counters.reset_launch_counts()
    try:
        res = rp_entry.main(argv)
    finally:
        launches = counters.launch_counts()
        warmup = dict(counters.WARMUP)
        restore()
    n = len(res["frames"])
    if n != RENDER_FRAMES or res["step"] != TRAIN_STEPS:
        raise AssertionError(f"{n} frames of step {res['step']}, expected "
                             f"{RENDER_FRAMES} of step {TRAIN_STEPS}")
    per_frame = EVAL_LAUNCHES[config]
    for k in launches:
        want = per_frame.get(k, 0) * n + warmup.get(k, 0)
        if launches[k] != want:
            raise AssertionError(f"{k}: {launches[k]} launches for {n} "
                                 f"frames, expected {want} (warm-up "
                                 f"{warmup})")
    for stem in res["frames"]:
        hdr = read_exr(stem + ".exr")
        if hdr.shape[:2] != tuple(res["size"]) or not np.all(
                np.isfinite(hdr)):
            raise AssertionError(f"{stem}.exr: shape {hdr.shape}, finite "
                                 f"{bool(np.all(np.isfinite(hdr)))}")
        with open(stem + ".png", "rb") as fp:
            if fp.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{stem}.png is no PNG")
    ms = res["ms_per_frame"]
    print(f"[render_path-{_stem(config) or 'panonerf_'}] {config}: {n} "
          f"frames of {res['size'][0]}x{res['size'][1]} from step "
          f"{res['step']} through the chunk graph: host ms per frame "
          + ", ".join(f"{x:.1f}" for x in ms)
          + " (the first with the capture); launches "
          + json.dumps({k: launches[k] for k in per_frame})
          + f" ({json.dumps(per_frame)} per frame + warm-up "
          f"{json.dumps(warmup)}); EXR and PNG frames finite", flush=True)
    return dict(launches=launches, ms_per_frame=ms)


def _train_inputs(trainer):
    import torch
    from pano_nerf_tpu_torch.core.rays import rays_to_tensors
    ds, dev = trainer.train_dataset, trainer.system.device
    return (rays_to_tensors(ds.rays, dev),
            torch.as_tensor(ds.images, dtype=torch.float32).to(dev))


# Timing turns and the profiled window are 8 steps (one replay of the
# 8-step graph), cut from 16 to pay for phases 2x and 23-24 within the
# call's time budget; no check reads them but the profile's launch-count
# match, which holds at any count.
TIMED_STEPS = 8


@clocked
def time_train_modes(trainer, steps: int = TIMED_STEPS) -> dict:
    """ms per train step and train rays/s of the 8-step graph, the
    one-step graph and eager steps, on the trained system, in turns
    (8, 1, eager, eager, 1, 8) of `steps` steps each; each turn ends in a
    device sync."""
    import torch
    system = trainer.system
    batch = int(trainer.hparams["train.batch_size"])
    data = _train_inputs(trainer)
    gen = torch.Generator(device=system.device).manual_seed(21)
    state = system.create_state()
    graph8, graph1 = (system.make_graphed_train_step(state, data, gen, True,
                                                     batch, k) for k in (8, 1))
    one = system.make_device_step(data, gen, True, batch)
    for fn in (graph8, graph1):
        fn(state)   # capture
    one(state)
    modes = {"graph, 8 steps per replay":
             lambda: [graph8(state) for _ in range(steps // 8)],
             "graph, 1 step per replay":
             lambda: [graph1(state) for _ in range(steps)],
             "eager": lambda: [one(state) for _ in range(steps)]}
    names = list(modes)
    times = {m: [] for m in modes}
    for m in names + names[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        modes[m]()
        torch.cuda.synchronize()
        times[m].append(1e3 * (time.perf_counter() - t0) / steps)
    tag = f"[time{_family(system)['sfx']}]"
    res = {}
    for m, ts in times.items():
        ms = sum(ts) / len(ts)
        res[m] = ms
        print(f"{tag} {m}: {ms:.3f} ms per train step ("
              + " / ".join(f"{t:.3f}" for t in ts) + f" in two turns of "
              f"{steps} steps) = {1e3 * batch / ms:.1f} train rays/s",
              flush=True)
    return res


# Graphed steps are held against eager steps from the same state and
# generator: where an op of the step sums in an order that varies between
# runs, two eager runs already differ in the last bits, and Adam's
# normalisation of tiny gradients grows that over the steps (the kernels'
# backwards add in a fixed order: on the kernel route the spread is 0).
# The spread is measured in the same call: four eager runs, the largest
# distance of the six pairs. The graph's median distance to the four runs must stay within
# twice it, or within f32 rounding (1e-6 rel) where the spread is smaller:
# a graph that drew other numbers, read a stale learning rate or lost a
# step lands orders of magnitude further off.
GRAPH_STEPS = 16
EAGER_RUNS = 4


def _within_spread(graph, eager, dist, floor):
    """(spread, the graph's median distance, tolerance, pass?) for the
    eager runs `eager` and the graphed run `graph` under `dist`."""
    import statistics
    spread = max(dist(a, b) for i, a in enumerate(eager)
                 for b in eager[:i])
    got = statistics.median(dist(graph, e) for e in eager)
    tol = max(2 * spread, floor)
    return spread, got, tol, got <= tol


@clocked
def check_graphed_against_eager(trainer, start_step: int = 0) -> None:
    """16 steps from one state (the trained weights, a fresh Adam at step
    `start_step`, one generator seed) four times eagerly and once as two
    replays of the 8-step graph: parameters (rel-norm) and every step's
    loss. With an env-distill schedule or an illum-distill rise, its
    weight at each of the 16 steps is printed and must change inside
    each 8-step graph: the graph reads it from the device step counter
    at every replay."""
    import torch
    system = trainer.system
    batch = int(trainer.hparams["train.batch_size"])
    data = _train_inputs(trainer)
    model = system.model
    start = {k: v.clone() for k, v in model.param_state().items()}

    def run(graphed: bool):
        model.load_params(start)
        state = system.create_state()
        state.step = start_step
        state.step_t.fill_(start_step)
        gen = torch.Generator(device=system.device).manual_seed(31)
        if graphed:
            fn = system.make_graphed_train_step(state, data, gen, True, batch,
                                                8)
            losses = torch.cat([fn(state)[1].clone()
                                for _ in range(GRAPH_STEPS // 8)])
        else:
            one = system.make_device_step(data, gen, True, batch)
            losses = torch.stack([one(state)["loss"]
                                  for _ in range(GRAPH_STEPS)])
        end = start_step + GRAPH_STEPS
        if state.step != end or int(state.step_t) != end:
            raise AssertionError(f"step counts {state.step}, "
                                 f"{int(state.step_t)} after {GRAPH_STEPS}"
                                 f" steps from {start_step}")
        flat = torch.cat([p.detach().reshape(-1) for p in system.params()])
        return flat.clone(), losses.cpu(), gen.get_state()

    eager = [run(False) for _ in range(EAGER_RUNS)]
    graph = run(True)
    model.load_params(start)
    loss_scale = float(eager[0][1].abs().max())
    params = _within_spread(graph, eager, lambda a, b: _rel(a[0], b[0]),
                            1e-6)
    loss = _within_spread(graph, eager,
                          lambda a, b: float((a[1] - b[1]).abs().max()),
                          1e-6 * loss_scale)
    same_gen = all(torch.equal(graph[2], e[2]) for e in eager)
    tag = f"[graph{_family(system)['sfx']}]"
    from pano_nerf_tpu_torch.engine.losses import (env_distill_schedule,
                                                   illum_distill_rise)
    for what, fn in (("env-distill", env_distill_schedule),
                     ("illum-distill", illum_distill_rise)):
        if fn(system.hparams, torch.tensor(0)) is None:
            continue
        sched = [float(fn(system.hparams, torch.tensor(start_step + i)))
                 for i in range(GRAPH_STEPS)]
        print(f"{tag} {what} weight factor at steps {start_step}-"
              f"{start_step + GRAPH_STEPS - 1}: "
              + ", ".join(f"{x:.4f}" for x in sched), flush=True)
        if len(set(sched[:8])) < 2 or len(set(sched[8:])) < 2:
            raise AssertionError(f"the {what} schedule does not move "
                                 "inside each 8-step graph of the window")
    print(f"{tag} {GRAPH_STEPS} steps from one state: eager vs eager "
          f"spread ({EAGER_RUNS} runs, largest of the pairs) params "
          f"rel-norm {params[0]:.3e}, per-step loss {loss[0]:.3e}; graphed "
          f"vs eager (median over the runs) params {params[1]:.3e} "
          f"(tolerance {params[2]:.3e}), loss {loss[1]:.3e} (tolerance "
          f"{loss[2]:.3e}); generator states equal: {same_gen}", flush=True)
    if not (params[3] and loss[3] and same_gen):
        raise AssertionError("graphed train steps differ from eager ones "
                             "beyond the eager-vs-eager spread")


@clocked
def check_illum_freeze(trainer) -> None:
    """`train.illum_freeze` inside a graph: one graphed step from a fresh
    Adam at the step before the freeze moves the illuminant field (its
    gradients are not 0), one from a fresh Adam at the freeze step leaves
    it bit-equal (its gradients are 0: the device-side mask) while the
    MLP moves. The trained parameters are put back after."""
    import torch
    system, hp = trainer.system, trainer.hparams
    fstep = float(hp["train.illum_freeze"]) * int(hp["optimizer.max_steps"])
    first = int(-(-fstep // 1))   # the first frozen step
    batch = int(hp["train.batch_size"])
    data = _train_inputs(trainer)
    saved = {k: v.clone() for k, v in system.model.param_state().items()}
    field = list(system.model.illum.parameters())
    mlp = list(system.model.mlp.parameters())
    res = []
    for step in (first - 1, first):
        state = system.create_state()
        state.step = step
        state.step_t.fill_(step)
        gen = torch.Generator(device=system.device).manual_seed(41)
        run = system.make_graphed_train_step(state, data, gen, True, batch,
                                             1)
        before = [p.detach().clone() for p in field + mlp]
        run(state)
        moved = [float((p - b).abs().max())
                 for p, b in zip(field + mlp, before)]
        res.append((step, max(float(p.grad.abs().max()) for p in field),
                    max(moved[:len(field)]), min(moved[len(field):])))
        system.model.load_params(saved)
    tag = f"[freeze{_family(system)['sfx']}]"
    print(f"{tag} graphed step from a fresh Adam, illum field frozen from "
          f"step {fstep:g}: " + "; ".join(
              f"step {s}: field |grad| max {g:.3e}, field moved {m:.3e}, "
              f"every MLP leaf moved (least max move {w:.3e})"
              for s, g, m, w in res), flush=True)
    (_, g0, m0, w0), (_, g1, m1, w1) = res
    if not (g0 > 0 and m0 > 0 and g1 == 0.0 and m1 == 0.0 and w0 > 0
            and w1 > 0):
        raise AssertionError(f"illum_freeze: {res}")


# The CPU side of the step checks and of `check_against_plain` runs in
# CPU_WORKERS processes of CPU_THREADS threads each, spawned once
# (`cpu_pool`), beside the card's work: on the card's 8-core host a
# batch-64 step keeps 8 threads of one process far from busy, and four
# steps at a time in four processes take less time than the four in
# turn. The workers run at a lower priority (CPU_NICE), so the process
# that drives the card, whose eager steps and renders wait on the host,
# is not held up by them. The steps, renders, their inputs and the
# statistics over them are the same; the CPU's sums may order apart.
CPU_WORKERS, CPU_THREADS, CPU_NICE = 4, 2, 10
_CPU_POOL = None


def _init_cpu_worker(threads: int) -> None:
    import torch
    os.nice(CPU_NICE)
    torch.set_num_threads(threads)


def cpu_pool():
    """The worker processes of the CPU steps (started at first use)."""
    global _CPU_POOL
    if _CPU_POOL is None:
        import concurrent.futures
        import multiprocessing
        _CPU_POOL = concurrent.futures.ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_init_cpu_worker, initargs=(CPU_THREADS,))
    return _CPU_POOL


def close_cpu_pool() -> None:
    global _CPU_POOL
    if _CPU_POOL is not None:
        _CPU_POOL.shutdown(wait=True, cancel_futures=True)
        _CPU_POOL = None


def _step_args(trainer, seed: int, num_rays: int) -> tuple:
    """`_one_step`'s arguments after the config and device for the batch
    of `_check_batch(trainer, seed, num_rays)`: the trainer's parameters,
    the batch's rays, targets and env rays (numpy) and its draws."""
    import numpy as np
    from pano_nerf_tpu_torch.core.rays import Rays
    ds = trainer.train_dataset
    idx, draws_np = _check_batch(trainer, seed, num_rays)
    sd = {k: v.detach().cpu().numpy().copy() for k, v in
          trainer.system.model.param_state().items()}
    D = int(trainer.hparams["nerf.num_ray_samples"])
    rays = Rays(*(np.asarray(getattr(ds.rays, k)[idx], np.float32)
                  for k in Rays._fields))
    batch = (rays, np.asarray(ds.images[idx], np.float32),
             ds.generate_lit_rays(num=D, near=0.0, far=10.0))
    return sd, batch, draws_np


def _one_step(hp, dev, state_dict, batch, draws_np) -> tuple:
    """One train step (clip off) on `dev` of the config's system from the
    parameters `state_dict` (numpy) on `batch` (rays, targets, env rays:
    numpy, `_step_args`) with the draws `draws_np` (numpy, of the
    system's draws type); returns (loss parts, flat gradient on the
    CPU)."""
    import numpy as np
    import torch
    from pano_nerf_tpu_torch.core.rays import Rays
    from pano_nerf_tpu_torch.engine.system import build_system
    system = build_system(dict(hp, **{"optimizer.grad_clip": 0.0}),
                          device=dev)
    system.model.load_params({k: torch.from_numpy(v)
                              for k, v in state_dict.items()})
    rays_np, rgbs_np, env_np = batch
    if system.surface:
        system.set_env_rays(env_np)
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(dev)

    def draw(x):   # uniforms as float32, the env-distill index as int64
        if x is None or np.issubdtype(np.asarray(x).dtype, np.integer):
            return None if x is None else torch.as_tensor(x).to(dev)
        return T(x)

    parts = system.make_train_step(True)(
        system.create_state(), Rays(*(T(x) for x in rays_np)), T(rgbs_np),
        None if draws_np is None
        else type(draws_np)(*(draw(x) for x in draws_np)))
    grads = torch.cat([p.grad.reshape(-1).cpu() for p in system.params()])
    return {k: float(v) for k, v in parts.items()}, grads


def _steps(jobs):
    """Run `_one_step` on each (hp, dev, *args) of `jobs`: the CPU ones
    queued in `cpu_pool`, the card's here now; returns a function that
    waits for the CPU ones and returns the results in order (gradients as
    torch tensors)."""
    import torch
    pool = cpu_pool()
    futs = [pool.submit(_one_step, hp, dev, *args) if dev == "cpu"
            else None for hp, dev, *args in jobs]
    out = [_one_step(hp, dev, *args) if f is None else None
           for f, (hp, dev, *args) in zip(futs, jobs)]

    def results() -> list:
        for i, f in enumerate(futs):
            if f is not None:
                parts, grads = f.result()
                out[i] = (parts, torch.as_tensor(grads))
        return out
    return results


# The step checks' comparisons, each waiting for its CPU steps: they run
# after the card's later phases (`finish_step_checks`, before the report),
# so the pool's CPU steps overlap the card's work instead of holding it.
# The steps, statistics and bounds are those of the checks as called.
PENDING_CHECKS: list = []


def defer_check(finish) -> None:
    """Queue `finish` (a check's comparison) under the current phase."""
    PENDING_CHECKS.append((PHASE, finish))


def finish_step_checks() -> None:
    """Run every queued comparison in order, each under its phase's name
    (a failure names the phase that queued it)."""
    global PHASE
    here, t0 = PHASE, time.perf_counter()
    n = len(PENDING_CHECKS)
    while PENDING_CHECKS:
        PHASE, finish = PENDING_CHECKS.pop(0)
        finish()
    PHASE = here
    print(f"[clock] finish_step_checks: {n} checks' comparisons took "
          f"{time.perf_counter() - t0:.1f} s (waiting for their CPU "
          f"steps)", flush=True)


def _check_batch(trainer, seed: int, num_rays: int) -> tuple:
    """A batch of `num_rays` rays of the trainer's dataset and its draws,
    made with numpy from `seed`, as `_one_step` takes them (None without
    `train.randomized`)."""
    import numpy as np
    from pano_nerf_tpu_torch.models.mip_nerf import MipDraws
    from pano_nerf_tpu_torch.models.pano_mip_nerf import TrainDraws
    hp = trainer.hparams
    cfg = trainer.system.model.cfg
    ds = trainer.train_dataset
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, ds.num_rays, num_rays)
    D = int(hp["nerf.num_ray_samples"])
    t_coarse = rng.random((num_rays, cfg.coarse_samples(False) + 1))
    u_fine = rng.random((num_rays, cfg.num_samples + 1))
    if not trainer.system.train_randomized:
        return idx, None
    draws_np = (TrainDraws(
        t_coarse=t_coarse, u_fine=u_fine,
        t_env=rng.random((num_rays, D, cfg.num_env_samples + 1)),
        d_alt=rng.normal(size=(num_rays, 3))) if trainer.system.surface
        else MipDraws(t_coarse=t_coarse, u_fine=u_fine))
    more = cfg.num_levels - 2
    if not trainer.system.surface:
        if cfg.density_noise > 0:
            draws_np = draws_np._replace(
                noise_coarse=rng.normal(
                    size=(num_rays, cfg.coarse_samples(False), 1)),
                noise_fine=rng.normal(size=(num_rays, cfg.num_samples, 1)))
        if more > 0:
            draws_np = draws_np._replace(u_more=rng.random(
                (more, num_rays, cfg.num_samples + 1)))
            if cfg.density_noise > 0:
                draws_np = draws_np._replace(noise_more=rng.normal(
                    size=(more, num_rays, cfg.num_samples, 1)))
        return idx, draws_np
    if cfg.env_distill_samples > 0:
        draws_np = draws_np._replace(
            ed_idx=rng.integers(0, D, (num_rays, 1)),
            t_ed=rng.random((num_rays, 1, cfg.env_distill_samples + 1)))
    mode = cfg.env_mode()
    if mode != "fixed":
        draws_np = draws_np._replace(q_rot=rng.normal(size=(num_rays, 4)))
    if mode in ("stratified", "importance"):
        draws_np = draws_np._replace(u_cos=rng.random((num_rays, D, 1)),
                                     u_phi=rng.random((num_rays, D, 1)))
    if mode == "importance":
        dp = cfg.env_probe_dirs
        draws_np = draws_np._replace(
            gumbel=rng.gumbel(size=(num_rays, D, dp)),
            t_probe=rng.random((num_rays, dp, cfg.env_probe_samples + 1)))
    if cfg.env_resample:
        draws_np = draws_np._replace(u_resample=rng.random(
            (num_rays * D, cfg.num_env_fine_samples + 1)))
    if cfg.density_noise > 0:
        draws_np = draws_np._replace(
            noise_coarse=rng.normal(size=(num_rays,
                                          cfg.coarse_samples(False), 1)),
            noise_fine=rng.normal(size=(num_rays, cfg.num_samples, 1)))
    from pano_nerf_tpu_torch.engine.losses import use_scale_distill
    if use_scale_distill(hp):
        draws_np = draws_np._replace(
            t_sd=rng.random((num_rays, cfg.num_env_samples + 1)))
    if more > 0:
        draws_np = draws_np._replace(u_more=rng.random(
            (more, num_rays, cfg.num_samples + 1)))
        if cfg.density_noise > 0:
            draws_np = draws_np._replace(noise_more=rng.normal(
                size=(more, num_rays, cfg.num_samples, 1)))
    return idx, draws_np


def grad_errors(trainer, seeds, num_rays: int = 64,
                normal_free: bool = True) -> list:
    """For each seed's batch, from the trainer's parameters: one train
    step of the shipped loss on the card, in bf16 on the CPU and in f32
    on the CPU, and (`normal_free`) one on the card and one in bf16 on the
    CPU without the orientation and surface terms. Returns per batch the
    loss parts of the first three and the squared norms of the gradients'
    differences (`card`, `cpu`: to f32; `plain`: card to CPU without the
    two terms) and of their references (`f32`, `cpu_plain`), from a
    function that waits for the CPU steps (`_steps`)."""
    hp = trainer.hparams
    hp_plain = dict(hp, **{"loss.ort_loss": 0.0, "loss.surface_loss": 0.0})
    hp_f32 = dict(hp, **{"train.precision": "f32"})
    sq = lambda a, b=0.0: float(((a - b) ** 2).sum())
    runs = [(hp, "cuda"), (hp, "cpu"), (hp_f32, "cpu")]
    if normal_free:
        runs += [(hp_plain, "cuda"), (hp_plain, "cpu")]
    batches = [_step_args(trainer, seed, num_rays) for seed in seeds]
    results = _steps([(h, dev, *args) for args in batches
                      for h, dev in runs])

    def errors() -> list:
        res, out = results(), []
        for b in range(len(batches)):
            card, cpu, f32, *plain = res[b * len(runs):(b + 1) * len(runs)]
            out.append(dict(parts=(card[0], cpu[0], f32[0]),
                            card=sq(card[1], f32[1]),
                            cpu=sq(cpu[1], f32[1]), f32=sq(f32[1])))
            if normal_free:
                card_p, cpu_p = plain
                out[-1].update(plain=sq(card_p[1], cpu_p[1]),
                               cpu_plain=sq(cpu_p[1]))
        return out
    return errors


GRAD_BATCHES = 16


@clocked
def check_train_step_against_cpu(trainer, num_rays: int = 64,
                                 well_conditioned: bool = True) -> None:
    """Train steps on the card (kernels) and on the CPU (plain versions)
    from the same parameters, batches and numpy-made draws, over
    GRAD_BATCHES batches.

    Loss parts are pooled over the batches (each part's summed absolute
    difference over its summed absolute CPU value) and must agree within
    5e-2. The gradient of the shipped loss is ill-conditioned in bf16: the
    orientation and surface terms normalize per-sample density gradients,
    some of them tiny, so rounding moves it by tens of percent whichever
    device computes it (the plain bf16 version on the CPU differs from
    the f32 one as much). A batch's distance is set by its few worst
    rays, so it is held two ways: (a) the card's gradients of the shipped
    loss must track the f32 gradients about as well as the CPU's bf16
    gradients do: the median over the batches of the per-batch ratio
    (card's distance to f32 over the CPU's) within 1.5, as the JAX kernel
    tests hold their kernels (a median, since one batch's ratio ranged
    0.1-9.4 on correct kernels: `scripts/torch_check_spread.py`,
    `scripts/check_statistics.py`); and (b) without the two
    normal-dependent terms the card's and the CPU's bf16 gradients must
    agree at rel-norm 5e-2, all the batches' gradients together. Where
    the rounding of the positions sets the f32 gradient and the normals
    (not `well_conditioned`: phase 19) (b) is not run, as the CPU's own
    bf16 gradient is as far from its f32 one as from the card's, and the
    parts that read the normals (`NORMAL_PARTS`) are printed, not
    held. The card's steps run now; the comparison is queued
    (`defer_check`) until the CPU's are in."""
    tag = f"[check{_family(trainer.system)['sfx']}]"
    errors = grad_errors(trainer, range(5, 5 + GRAD_BATCHES), num_rays,
                         well_conditioned)
    defer_check(lambda: _hold_step_errors(tag, errors(), num_rays,
                                          well_conditioned))


def _hold_step_errors(tag: str, errs: list, num_rays: int,
                      well_conditioned: bool) -> None:
    """`check_train_step_against_cpu`'s comparison of the per-batch
    errors `errs` (`grad_errors`)."""
    import math
    import statistics
    failures = []
    card, cpu, f32 = errs[0]["parts"]
    for k in cpu:
        diffs = [abs(e["parts"][0][k] - e["parts"][1][k]) for e in errs]
        refs = [abs(e["parts"][1][k]) for e in errs]
        err = sum(diffs) / max(sum(refs), 1e-12)
        print(f"{tag} train step {k}: pooled rel {err:.3e} over "
              f"{GRAD_BATCHES} batches (bound 5e-2); first batch card "
              f"{card[k]:.6e} cpu {cpu[k]:.6e} (f32 {f32[k]:.6e}); per batch "
              + " ".join(f"{d / max(r, 1e-12):.1e}"
                         for d, r in zip(diffs, refs)))
        diff = sum(diffs)
        if not well_conditioned and k in NORMAL_PARTS:
            print(f"{tag} train step {k}: not held (reads the normals)")
        elif not (err <= 5e-2 or diff <= 1e-9 * GRAD_BATCHES):
            failures.append(k)
    rel = lambda e, d, ref: math.sqrt(e[d] / e[ref])
    each = lambda d, ref: " ".join(f"{rel(e, d, ref):.3e}" for e in errs)
    ratios = [rel(e, "card", "cpu") for e in errs]
    median = statistics.median(ratios)
    tot = {d: sum(e[d] for e in errs) for d in errs[0] if d != "parts"}
    e_card, e_cpu = rel(tot, "card", "f32"), rel(tot, "cpu", "f32")
    print(f"{tag} train step gradients vs f32 over {GRAD_BATCHES} batches "
          f"of {num_rays} rays: median of the per-batch ratios card / cpu "
          f"bf16 {median:.3f} (must be <= 1.5); pooled card {e_card:.3e}, "
          f"cpu bf16 {e_cpu:.3e} (ratio {e_card / e_cpu:.3f}, not held); "
          f"per batch ratio " + " ".join(f"{r:.3f}" for r in ratios)
          + f"; card {each('card', 'f32')}; cpu bf16 {each('cpu', 'f32')}")
    if not median <= 1.5:
        failures.append("grads vs f32")
    if well_conditioned:
        e = rel(tot, "plain", "cpu_plain")
        print(f"{tag} train step gradients without the orientation and "
              f"surface terms (mip-NeRF's shipped loss has neither): card "
              f"vs cpu rel-norm {e:.3e} over {GRAD_BATCHES} batches "
              f"(tolerance 5e-2); per batch {each('plain', 'cpu_plain')}")
        if not e <= 5e-2:
            failures.append("grads without normal terms")
    else:
        print(f"{tag} train step gradients without the orientation and "
              f"surface terms: not held (the f32 gradient moves 0.64 under "
              f"1e-6 shifts of the ray origins here, "
              f"scripts/torch_grad_conditioning.py)", flush=True)
    if failures:
        raise AssertionError(f"train step on the card differs from the CPU "
                             f"in {failures}")


# Kernel name in the profiler -> (launch counter, launches of the counter
# per kernel): a backward counts its row pass and its weight-gradient
# pass, so each row-pass kernel stands for two of its counter's launches.
PROFILED_KERNELS = {
    "fused_mlp_fwd_kernel<0>": ("fused_mlp_ipe_fwd", 1),
    "fused_mlp_bwd_kernel<0>": ("fused_mlp_ipe_bwd", 2),
    "fused_mlp_fwd_kernel<1>": ("fused_mlp_normals_fwd", 1),
    "fused_mlp_bwd_kernel<1>": ("fused_mlp_normals_bwd", 2),
    "fused_mlp_fwd_kernel<2>": ("fused_mlp_apply_fwd", 1),
    "fused_mlp_bwd_kernel<2>": ("fused_mlp_apply_bwd", 2),
    "train_fwd_kernel": ("fused_render_train_fwd", 1),
    "train_bwd_kernel": ("fused_render_train_bwd", 2),
    "fused_render_kernel": ("fused_render_level", 1),
    "fused_mlp_wgrad_kernel": ("fused_mlp_weight_grads", 1),
}


@clocked
def profile_train_step(trainer, steps: int = TIMED_STEPS) -> None:
    """torch.profiler over `steps` train steps of the trained system, as
    replays of the 8-step graph and as eager steps (each after its
    own warm-up): the device's busy and idle share of the host wall time
    and the top device ops; the launch counters' increments over the
    graphed window held against the kernels the profiler saw by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pano_nerf_tpu_torch.kernels import counters
    system = trainer.system
    hp = trainer.hparams
    batch = int(hp["train.batch_size"])
    data = _train_inputs(trainer)
    gen = torch.Generator(device=system.device).manual_seed(3)
    state = system.create_state()
    graphed = system.make_graphed_train_step(state, data, gen, True, batch,
                                             8)
    one = system.make_device_step(data, gen, True, batch)
    family = _family(system)
    what = f"{steps} train steps" + dict(
        [("-k5", " with the render kernel"), ("-mip", " of mip-NeRF")]).get(
            family["sfx"], "")
    for mode in ("graph", "eager"):
        fn = ((lambda: graphed(state)) if mode == "graph"
              else (lambda: one(state)))
        calls = steps // 8 if mode == "graph" else steps
        fn()
        torch.cuda.synchronize()
        before = counters.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        after = counters.launch_counts()
        _report_profile(prof, wall_us, f"{what}, {mode}")
        counted = {k: after[k] - before[k] for k in after}
        seen = {name: 0 for name in PROFILED_KERNELS}
        for e in _device_split(prof)[0]:
            for name in PROFILED_KERNELS:
                if name in e.name:
                    seen[name] += 1
        from_trace = {}
        for name, (counter, per) in PROFILED_KERNELS.items():
            from_trace[counter] = from_trace.get(counter, 0) + per * seen[
                name]
        want = {k: n * steps for k, n in family["per_step"].items()}
        want["fused_render_level"] = 0
        print(f"[time] {what}, {mode}: launch counters "
              + json.dumps(counted) + "; from the profiler's kernel names "
              + json.dumps(from_trace), flush=True)
        if counted != want or from_trace != want:
            raise AssertionError(f"{mode} steps: launch counters "
                                 f"{counted} and profiled kernels "
                                 f"{from_trace} disagree with {want}")
    if family["sfx"] == "":
        adam_grads_ab(state.optimizer)


def _is_annotation(e) -> bool:
    """A user range mirrored onto the device timeline (torch.optim's
    `Optimizer.step#Adam.step`): it spans kernels and the idle time
    between them, so it is no device work of its own."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(
        "Optimizer.")


def _union_us(spans) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _device_split(prof):
    """(kernel events, {annotation name: (count, span us, kernel-busy us
    inside the spans)}) of a profile's device timeline."""
    import torch
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in cuda if not _is_annotation(e)]
    ranges = [(e.time_range.start, e.time_range.end) for e in kernels]
    notes = {}
    for e in cuda:
        if _is_annotation(e):
            a, b = e.time_range.start, e.time_range.end
            inside = _union_us((max(x, a), min(y, b)) for x, y in ranges
                               if x < b and y > a)
            n, span, k = notes.get(e.name, (0, 0.0, 0.0))
            notes[e.name] = (n + 1, span + b - a, k + inside)
    return kernels, notes


def _report_profile(prof, wall_us: float, what: str) -> None:
    kernels, notes = _device_split(prof)
    if not kernels:
        print("[time] the profiler recorded no device events: device busy "
              "share not measured")
        return
    busy = _union_us((e.time_range.start, e.time_range.end) for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print(f"[time] {what}: host wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), idle "
          f"{100 * (1 - busy / wall_us):.1f}%, {len(kernels)} device events "
          f"(kernels, copies and fills; user ranges apart)")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"[time]   {t / 1e3:9.3f} ms  {n:5d} x  {name[:90]}")
    for name, (n, span, inside) in notes.items():
        print(f"[time]   range {name}: {n} x, span {span / 1e3:.3f} ms on "
              f"the device, of which kernels busy {inside / 1e3:.3f} ms")


@clocked
def adam_grads_ab(optimizer, steps: int = 5, rounds: int = 3) -> None:
    """Adam's device cost with the gradients as a train step leaves them
    against the same gradients cloned into fresh contiguous tensors, in
    alternating rounds: whether views of the weight-gradient pass's packed
    buffer reach the optimizer, and what they cost it (torch.profiler,
    `steps` optimizer steps per round; the step changes the weights, so
    run it last)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.grad is not None]
    left = [p.grad for p in params]
    cloned = [g.clone(memory_format=torch.contiguous_format) for g in left]
    views = sum(g._base is not None for g in left)
    strided = sum(not g.is_contiguous() for g in left)
    print(f"[adam] {len(params)} gradients after a step: {views} views of "
          f"another tensor, {strided} not contiguous", flush=True)
    for r in range(2 * rounds):
        how, grads = (("as left by the step", left) if r % 2 == 0
                      else ("cloned", cloned))
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                optimizer.step()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / steps
        kernels, notes = _device_split(prof)
        busy = _union_us((e.time_range.start, e.time_range.end)
                         for e in kernels) / 1e3 / steps
        span = sum(v[1] for v in notes.values()) / 1e3 / steps
        print(f"[adam] round {r // 2 + 1}, gradients {how}: "
              f"{len(kernels)} device events in {steps} steps, device busy "
              f"{busy:.4f} ms, range span {span:.4f} ms, host wall "
              f"{wall:.4f} ms per step", flush=True)


# ---- 2d and 15-18: the scale-distill re-march, the plain route, the last
# loss terms ----------------------------------------------------------------

PLAIN_STEPS = 48
# Phases 15-18: (config, overrides). 15-17 take the plain route (f32, a
# mip-NeRF topology the kernels are not built for, both heads), 18 the
# kernels with every loss term the port lifted last.
PLAIN_PHASES = {
    15: (CONFIG, ("train.precision", "'f32'")),
    16: (MIP_CONFIG, ("nerf.mlp.net_depth", "4", "nerf.mlp.net_width", "128",
                      "nerf.use_viewdirs", "False")),
    17: (CONFIG, ("nerf.emissive_head", "True", "nerf.chroma_head", "True")),
    18: (CONFIG, ("loss.scale_distill", "0.1", "loss.scale_distill_dist",
                  "0.1", "loss.vc_chroma", "0.1", "loss.vc_chroma_sg",
                  "True", "loss.vc_sat_mask", "True")),
}
# The bounds of the new gates. Fixed: the f32 loss parts that do not
# depend on normals and the f32 gradient without the orientation and
# surface terms, card against CPU. Measured, each at least 3x the largest
# reading of three full calls on an H100 (PERF.md section 6): the parts
# that depend on normals (7.8e-5 pooled), the whole f32 gradient (1.7e-2
# pooled; a batch's distance is set by its few worst rays) and the
# plain route's chunk graph against eager chunks (0; the 1e-4 of the
# kernel route's eval check). Graphed against eager steps on the plain
# route read 0 in every call (eager runs and the graph agreed bit for
# bit), so they are held at the existing 1e-6 floor.
F32_PART_TOL = 1e-4
F32_GRAD_PLAIN_TOL = 1e-3
F32_NORMAL_PART_TOL = 1e-3
F32_GRAD_TOL = 1e-1
PLAIN_CHUNK_TOL = 1e-4
NORMAL_PARTS = ("loss", "ort", "vol_surface")


def scale_distill_shapes(model, env, dev) -> dict:
    """Kernel 2's call on the scale-distill re-march of a batch-512 train
    step (`_train_batch`'s rays; num_env_samples Gaussians over [near,
    far] at uniforms from seed 15): name -> (normals?, means, covs,
    v_enc)."""
    import torch
    from pano_nerf_tpu_torch.ops import mip
    cfg = model.cfg
    b = _train_batch(model, env, dev)
    rays = b["rays"]
    g = torch.Generator(device=dev).manual_seed(15)
    u = torch.rand((rays.origins.shape[0], cfg.num_env_samples + 1),
                   generator=g, device=dev)
    with torch.no_grad():
        _, (m, c) = mip.sample_along_rays(
            rays.origins, rays.directions, rays.radii, cfg.num_env_samples,
            rays.near, rays.far, cfg.disparity, t_rand=u)
    return {"scale_distill": (False, m.contiguous(), c.contiguous(),
                              b["v"])}


@clocked
def check_f32_step_against_cpu(trainer, num_rays: int = 64) -> None:
    """f32 train steps on the card (the plain route, TF32 off) and on the
    CPU from the same parameters, batches and numpy-made draws, over the
    GRAD_BATCHES batches of phase 5, pooled: each loss part as the summed
    absolute differences over the summed absolute CPU values, within
    F32_PART_TOL where it does not depend on normals and
    F32_NORMAL_PART_TOL where it does; the gradient without the
    orientation and surface terms within F32_GRAD_PLAIN_TOL and the
    shipped loss's within F32_GRAD_TOL (rel-norm of all batches'
    gradients together). The two devices order their f32 sums apart
    (cuBLAS, MKL); the normal-dependent terms normalize tiny density
    gradients and so show it most. The comparison is queued as
    `check_train_step_against_cpu`'s."""
    tag = f"[check{_family(trainer.system)['sfx']}]"
    hp = trainer.hparams
    hp_plain = dict(hp, **{"loss.ort_loss": 0.0, "loss.surface_loss": 0.0})
    runs = [(hp, "cuda"), (hp, "cpu"), (hp_plain, "cuda"), (hp_plain, "cpu")]
    batches = [_step_args(trainer, seed, num_rays)
               for seed in range(5, 5 + GRAD_BATCHES)]
    results = _steps([(h, dev, *args) for args in batches
                      for h, dev in runs])
    defer_check(lambda: _hold_f32_steps(tag, results(), len(batches),
                                        len(runs), num_rays))


def _hold_f32_steps(tag: str, res: list, nbatch: int, nruns: int,
                    num_rays: int) -> None:
    """`check_f32_step_against_cpu`'s comparison of the steps `res`."""
    import math
    sq = lambda a, b=0.0: float(((a - b) ** 2).sum())
    parts, tot, each = [], dict.fromkeys(("full", "f", "plain", "p"), 0.0), {
        "full": [], "plain": []}
    for b in range(nbatch):
        card, cpu, card_p, cpu_p = res[b * nruns:(b + 1) * nruns]
        parts.append((card[0], cpu[0]))
        for name, ref, (a, b) in (("full", "f", (card[1], cpu[1])),
                                  ("plain", "p", (card_p[1], cpu_p[1]))):
            tot[name] += sq(a, b)
            tot[ref] += sq(b)
            each[name].append(math.sqrt(sq(a, b) / sq(b)))
    for k in parts[0][1]:
        diff = sum(abs(c[k] - p[k]) for c, p in parts)
        rel = diff / max(sum(abs(p[k]) for _, p in parts), 1e-30)
        bound = F32_NORMAL_PART_TOL if k in NORMAL_PARTS else F32_PART_TOL
        print(f"{tag} f32 train step {k}: card vs cpu pooled rel {rel:.3e} "
              f"(bound {bound:g}); per batch " + " ".join(
                  f"{abs(c[k] - p[k]) / max(abs(p[k]), 1e-30):.2e}"
                  for c, p in parts), flush=True)
        hold(f"f32 loss part {k} rel", rel, bound)
    for name, ref, bound, what in (
            ("plain", "p", F32_GRAD_PLAIN_TOL,
             "without the orientation and surface terms"),
            ("full", "f", F32_GRAD_TOL, "of the shipped loss")):
        rel = math.sqrt(tot[name] / tot[ref])
        print(f"{tag} f32 train step gradient {what}: card vs cpu rel-norm "
              f"{rel:.3e} over {GRAD_BATCHES} batches of {num_rays} rays "
              f"(bound {bound:g}); per batch "
              + " ".join(f"{x:.2e}" for x in each[name]), flush=True)
        hold(f"f32 gradient {what} rel-norm", rel, bound)


def drive_plain_phase(ph: int, workdir: str, scene: str,
                      base_times: dict) -> dict:
    """Phase `ph` of 15-18 (`PLAIN_PHASES`): 48 steps through the train
    entry point with exact launch counts (none on the plain route),
    falling losses; on the plain route the trained weights' panorama,
    graph against eager chunks; the step against the CPU (15: in f32),
    graphed steps against eager ones, ms per step beside phase 4's; 15
    also the profile. Returns the run (its launches)."""
    enter_phase(str(ph))
    config, opts = PLAIN_PHASES[ph]
    run = drive_train_path(workdir, scene, config=config, opts=opts,
                           steps=PLAIN_STEPS, name=f"phase{ph}")
    trainer = run.pop("trainer")
    system = trainer.system
    family = _family(system)
    tag = f"[phase{ph}{family['sfx']}]"
    plain = not system.model.kernels
    if plain != (ph != 18):
        raise AssertionError(f"phase {ph}: kernel route {not plain}")
    losses = run["losses"]
    first, last = sum(losses[:16]) / 16, sum(losses[-16:]) / 16
    print(f"{tag} mean loss of steps 1-16 {first:.6f}, of steps 33-48 "
          f"{last:.6f}", flush=True)
    if not last < first:
        raise CheckFailed("mean loss of steps 33-48 (vs steps 1-16)", last,
                          first)
    if ph == 18:
        base = per_step_launches(False)
        more = {k: family["per_step"][k] - base[k] for k in base}
        print(f"{tag} launches per step beyond phase 4's "
              + json.dumps({k: v for k, v in more.items() if v})
              + " (counted exactly over the run)", flush=True)
    else:
        where_the_time_goes(scene, params=system.model.param_state(),
                            tag=f"[eval-phase{ph}]", config=config,
                            opts=opts, tol=PLAIN_CHUNK_TOL)
    if ph == 17:
        import numpy as np
        from pano_nerf_tpu_torch.data.io_exr import read_exr
        tree = os.path.join(run["save_dir"], f"val_{PLAIN_STEPS:06d}",
                            "pred_emission")
        files = sorted(os.listdir(tree))
        em = read_exr(os.path.join(tree, files[0]))
        if not (files and np.isfinite(em).all() and em.min() >= 0):
            raise AssertionError(f"emission product {tree}: {files}")
        print(f"{tag} val tree's emission product {files[0]}: "
              f"{em.shape}, mean {float(em.mean()):.4f}", flush=True)
    if ph == 15:
        check_f32_step_against_cpu(trainer)
    else:
        check_train_step_against_cpu(trainer)
    check_graphed_against_eager(trainer)
    ms = time_train_modes(trainer)
    g8 = "graph, 8 steps per replay"
    print(f"[time-phase{ph}] graph of 8 steps {ms[g8]:.3f} ms per step "
          f"(one-step graph {ms['graph, 1 step per replay']:.3f}, eager "
          f"{ms['eager']:.3f}) vs phase 4 in this call "
          f"{base_times[False][g8]:.3f}", flush=True)
    if ph == 15:
        profile_train_step(trainer)
    return run


# Phases 19-20: JAX's level loop and the last model and system keys on
# `configs/panonerf.yaml`. 19: three levels with the resampling gradient
# and without integration, key on; 20: the deterministic train step,
# served randomized; 20m: mip-NeRF at one level with density noise and
# the orientation loss (kernel 3 on the one level), served randomized.
# Without integration every IPE degree reaches the MLP unattenuated and
# the step's gradient is set by f32 rounding of the sample positions
# (moving every ray origin by 1e-6 moves the f32 gradient by 6e-2, 0.64
# with the other two keys: `scripts/torch_grad_conditioning.py`), and so
# are the normals (the same shifts leave the CPU's own at a median cosine
# of -0.04-0.11 with its unshifted render). So 19 holds the median ratio
# and the loss parts that do not read the normals, and kernels 2-5 to
# their plain versions on zero covariances on the same inputs; its
# served view is held card vs CPU within twice the CPU's own change
# under 1e-6 shifts (`check_against_plain(shifts=)`).
LEVELS_3 = ("nerf.num_levels", "3", "nerf.stop_resample_grad", "False",
            "nerf.disable_integration", "True")
VAL_RANDOMIZED = ("val.randomized", "True")
# phase -> (config, opts, kernel 5's key, steps, served opts, the mean
# loss of the last 20 steps held below that of the first 20)
LEVEL_PHASES = {
    "19": (CONFIG, LEVELS_3, True, TRAIN_STEPS, (), False),
    "20": (CONFIG, ("train.randomized", "False"), False, TRAIN_STEPS,
           VAL_RANDOMIZED, False),
    "20m": (MIP_CONFIG, ("nerf.num_levels", "1", "nerf.density_noise",
                         "1.0", "loss.ort_loss", "0.1"), False, 64,
            VAL_RANDOMIZED, False),
}


@clocked
def check_zero_covariance_kernels(system) -> None:
    """Kernels 2-5 against their plain versions on zero covariances (what
    `nerf.disable_integration` hands them: every IPE degree unattenuated)
    at phase 2's shapes and tolerances, on the system's trained weights:
    kernel 4 at an eval chunk's three levels, kernels 2 and 3 (forward
    and backward) at a train step's four calls, kernel 5 at its two
    levels. The entries are not reported: the shapes are phase 2's."""
    import torch
    model, env, dev = system.model, system.env_rays, system.device
    zero = lambda xs: tuple(torch.zeros_like(x) if i == 1 else x
                            for i, x in enumerate(xs))
    shapes = {n: (list(zero(args)), kw)
              for n, (args, kw) in main_path_inputs(model, env,
                                                    dev).items()}
    with torch.no_grad():
        check_kernels(model, env, dev, shapes=shapes, sfx="_noint",
                      tag="[kernel-noint]")
    calls, levels, _ = train_shapes(model, env, dev)
    calls = {n: (nm, m, torch.zeros_like(c), v)
             for n, (nm, m, c, v) in calls.items()}
    levels = {n: zero(args) for n, args in levels.items()}
    wentry = _wgrad_entry()
    check_train_kernels(model, dev, calls, wentry, tag="[kernel-noint]",
                        sfx="_noint", dsig_rms=True)
    check_train_render_kernel(model, dev, levels, wentry, sfx="_noint",
                              tag="[kernel-noint]")


# Phases 21-23m and 25-25m: the shapes of `OTHER_SHAPES`, the padded
# widths and the 512 / 256 builds trained and served, 64 steps each: 21,
# A with kernel 5's key on (kernels 2, 3, 5; served through kernel 4);
# 22, B with the key off (kernels 2 and 3; kernel 4); 22m, C with
# `loss.ort_loss` (kernels 2 and 3, served through them); 23, P1 (trunk
# 64, view 32, in the 128 / 64 build) as 21; 23m, P2 mip-NeRF (200 / 100,
# in the one-channel 256 / 128 build) as 22m; 25, D (trunk 512, view 256)
# as 21; 25m, Dm (mip-NeRF at 512 / 256) as 22m; 26, E (trunk 1,024, view
# 512) as 21 (kernels 2, 3 and 5 on CTA pairs; kernel 4); 26m, Em
# (mip-NeRF at 1,024 / 128) as 22m; 25-26m each with its loss held
# falling. Entries as in `LEVEL_PHASES`. E with the key off is phase 26k
# (`drive_key_off_phase`).
SHAPE_PHASES = {
    "21": (CONFIG, SHAPE_A, True, 64, (), False),
    "22": (CONFIG, SHAPE_B, False, 64, (), False),
    "22m": (MIP_CONFIG, SHAPE_C + ("loss.ort_loss", "0.1"), False, 64, (),
            False),
    "23": (CONFIG, SHAPE_P1, True, 64, (), False),
    "23m": (MIP_CONFIG, SHAPE_P2 + ("loss.ort_loss", "0.1"), False, 64, (),
            False),
    "25": (CONFIG, SHAPE_D, True, 64, (), True),
    "25m": (MIP_CONFIG, SHAPE_D + ("loss.ort_loss", "0.1"), False, 64, (),
            True),
    "26": (CONFIG, SHAPE_E, True, 64, (), True),
    "26m": (MIP_CONFIG, SHAPE_EM + ("loss.ort_loss", "0.1"), False, 64, (),
            True),
}
# The phases run after phase 24 (the wide builds), and ms per graphed step
# of each shape phase, for the next wider build's line.
LATE_PHASES = ("25", "25m", "26", "26m")
SHAPE_MS: dict = {}
# Phase 26k's steps: E with the key off, beside phase 26's key on.
KEY_OFF_STEPS = 16


@clocked
def drive_key_off_phase(workdir: str, scene: str) -> list:
    """Phase 26k: E with kernel 5's key off (kernels 2 and 3 on CTA
    pairs), beside phase 26's key on: KEY_OFF_STEPS steps through the
    train entry point with exact launch counts, 16 graphed steps against
    eager ones, ms per step beside phase 26's. Returns the run (its
    launches)."""
    import torch
    enter_phase("26k")
    run = drive_train_path(workdir, scene, config=CONFIG, opts=SHAPE_E,
                           steps=KEY_OFF_STEPS, name="phase26k")
    trainer = run.pop("trainer")
    check_graphed_against_eager(trainer)
    ms = time_train_modes(trainer)
    g8 = "graph, 8 steps per replay"
    print(f"[time-phase26k] graph of 8 steps {ms[g8]:.3f} ms per step "
          f"(one-step graph {ms['graph, 1 step per replay']:.3f}, eager "
          f"{ms['eager']:.3f}), key off, vs phase 26 (key on) in this call "
          f"{SHAPE_MS['26']:.3f}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return [run]


def drive_level_phase(ph: str, workdir: str, scene: str,
                      base_times: dict) -> list:
    """Phase `ph` of `LEVEL_PHASES` or `SHAPE_PHASES`: its steps through
    the train entry point (graphed, exact launch counts, over 200 steps the loss
    falling; where the entry asks, the last 20 steps' mean below the first
    20's), the checkpoint served through `eval --ckpt_dir` (20, 20m:
    randomized), the panorama's chunk graph bit-equal to eager chunks and
    ms per panorama, a view of the checkpoint rendered on the card and on
    the CPU (`check_against_plain`); the step against the CPU
    (`check_train_step_against_cpu`; 19 without the normal-free gradient,
    and kernels 2-5 on zero covariances against their plain versions,
    `check_zero_covariance_kernels`), 16 graphed steps against eager
    ones, ms per graphed step beside phase 4's (19: 4b's, key on).
    Returns the runs (their launches)."""
    import torch
    enter_phase(ph)
    dev = torch.device("cuda")
    config, opts, key, steps, served_opts, falls = {**LEVEL_PHASES,
                                                    **SHAPE_PHASES}[ph]
    mip = config == MIP_CONFIG
    name = f"phase{ph}"
    run = drive_train_path(workdir, scene, render_kernel=key, config=config,
                           opts=opts, steps=steps, name=name)
    trainer = run.pop("trainer")
    if falls:
        losses = run["losses"]
        first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
        if not last < first:
            raise CheckFailed(f"mean loss of steps {steps - 19}-{steps} (vs "
                              "steps 1-20)", last, first)
    family = _family(trainer.system)
    tag = f"[{name}{family['sfx']}]"
    print(f"{tag} launches per step " + json.dumps(
        {k: v for k, v in family["per_step"].items() if v})
        + " and per panorama " + json.dumps(
            {k: v for k, v in family["per_pano"].items() if v})
        + " (counted exactly over the run)", flush=True)
    served_opts = opts + served_opts
    served = drive_main_path(workdir, scene, ["--ckpt_dir", run["save_dir"]],
                             step=steps, config=config, opts=served_opts,
                             name=name + "_served")
    params = trainer.ckpt.restore(map_location=dev)["params"]
    where_the_time_goes(scene, params=params, tag=f"[eval-{name}]",
                        config=config, opts=served_opts, profiled=False)
    noint = "nerf.disable_integration" in opts
    check_against_plain(scene, config, tag=f"[check-{name}]",
                        opts=served_opts, params=params,
                        shifts=2 if noint else 0)
    check_train_step_against_cpu(trainer, well_conditioned=not noint)
    if noint:
        check_zero_covariance_kernels(trainer.system)
    check_graphed_against_eager(trainer)
    ms = time_train_modes(trainer)
    g8 = "graph, 8 steps per replay"
    SHAPE_MS[ph] = ms[g8]
    base = "" if mip else (
        f" vs phase 4{'b' if key else ''} in this call "
        f"{base_times[bool(key)][g8]:.3f}")
    if ph.startswith("26") and "25" + ph[2:] in SHAPE_MS:
        base += (f", phase 25{ph[2:]} (512 / 256) "
                 f"{SHAPE_MS['25' + ph[2:]]:.3f}")
    print(f"[time-{name}] graph of 8 steps {ms[g8]:.3f} ms per step "
          f"(one-step graph {ms['graph, 1 step per replay']:.3f}, "
          f"eager {ms['eager']:.3f}){base}", flush=True)
    del trainer
    return [run, served]


OPS360_TOL = 1e-4   # card vs CPU, over max(1, the output's largest value)


@clocked
def drive_library_phase(workdir: str, scene: str) -> dict:
    """Phase 24, the library modules on the card: (1) a synthesized
    reference Lightning checkpoint at P1's widths (`state_dict` under
    `mip_nerf.mlp.`, `hyper_parameters` with `nerf.*`) imported through
    `import_reference_ckpt`, served through `eval --ckpt_dir` (kernel 4,
    96 launches per panorama) and held to the same checkpoint rendered on
    the CPU (`check_against_plain`); (2) the scene's EXR files read by
    the native decoder and by the pure-Python codec, bitwise equal, the
    decoder's name printed; (3) a 2-view Blender scene written with the
    port's PNG writer read through `Blender`, its rays put on the card;
    (4) the 360 ops on CUDA tensors held to the same ops on the CPU
    (`OPS360_TOL`). Returns the served run (its launches)."""
    import glob
    import numpy as np
    import torch
    from pano_nerf_tpu_torch import import_reference_ckpt
    from pano_nerf_tpu_torch.core.rays import RAYS_KEYS, rays_to_tensors
    from pano_nerf_tpu_torch.data import io_exr
    from pano_nerf_tpu_torch.data.perspective_datasets import Blender
    from pano_nerf_tpu_torch.engine.checkpoint import Checkpointer
    from pano_nerf_tpu_torch.models.mlp import NerfMLP
    from pano_nerf_tpu_torch.ops import mip
    from pano_nerf_tpu_torch.utils.vis import write_png
    enter_phase("24")
    dev = torch.device("cuda")
    W, VW = int(SHAPE_P1[1]), int(SHAPE_P1[3])
    ref = NerfMLP(96, 27, net_width=W, net_width_condition=VW,
                  num_density_channels=5,
                  generator=torch.Generator().manual_seed(24))
    ckpt = os.path.join(workdir, "reference.ckpt")
    torch.save({"state_dict": {"mip_nerf.mlp." + k: v for k, v in
                               ref.state_dict().items()},
                "hyper_parameters": {"nerf.mlp.net_width": W,
                                     "nerf.mlp.net_width_condition": VW}},
               ckpt)
    imported = import_reference_ckpt.main([
        "--torch_ckpt", ckpt, "--out_dir", os.path.join(workdir, "imported"),
        "--config", CONFIG, "train.sample_num", "'n0_1'"])
    served = drive_main_path(workdir, scene,
                             ["--ckpt_dir", imported["ckpt_dir"]], step=0,
                             opts=SHAPE_P1, name="imported_served")
    params = Checkpointer(os.path.join(imported["ckpt_dir"], "checkpoints")
                          ).restore()["params"]
    check_against_plain(scene, CONFIG, tag="[check-imported]",
                        opts=SHAPE_P1, params=params)

    files = sorted(glob.glob(os.path.join(scene, "**", "*.exr"),
                             recursive=True))
    secs, decoders = {"native": 0.0, "python": 0.0}, set()
    for f in files:
        t0 = time.perf_counter()
        a = io_exr.read_exr(f)
        secs["native"] += time.perf_counter() - t0
        decoders.add(io_exr.read_exr.decoder)
        t0 = time.perf_counter()
        b = io_exr.read_exr(f, native=False)
        secs["python"] += time.perf_counter() - t0
        if a.tobytes() != b.tobytes():
            raise AssertionError(f"{f}: the native EXR decoder differs "
                                 f"from the pure-Python codec")
    print(f"[exr] {len(files)} EXR files of the scene read by decoder "
          f"{sorted(decoders)} in {secs['native']:.2f} s, bitwise equal to "
          f"the pure-Python codec ({secs['python']:.2f} s)"
          + (f"; native unavailable: {io_exr.native_error()}"
             if io_exr.native_error() else ""), flush=True)
    if not files or decoders != {"native"}:
        raise AssertionError(f"the native EXR decoder read {decoders} of "
                             f"{len(files)} files: {io_exr.native_error()}")

    root = os.path.join(workdir, "blender")
    os.makedirs(os.path.join(root, "r"))
    rng = np.random.default_rng(24)
    for split in ("train", "val"):
        frames = []
        for i in range(2):
            write_png(os.path.join(root, f"r/{split}_{i}.png"),
                      rng.integers(0, 256, (64, 48, 4), dtype=np.uint8))
            c2w = np.eye(4)
            c2w[:3, 3] = rng.uniform(-1, 1, 3)
            frames.append(dict(file_path=f"r/{split}_{i}",
                               transform_matrix=c2w.tolist()))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fp:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, fp)
    ds = Blender(root, split="train", white_bkgd=True)
    rays = rays_to_tensors(ds.rays, dev)
    for k in RAYS_KEYS:
        x = getattr(rays, k)
        host = torch.as_tensor(np.asarray(getattr(ds.rays, k), np.float32))
        if x.device.type != "cuda" or not torch.equal(x.cpu(), host):
            raise AssertionError(f"Blender rays {k} on the card differ")
    rgb = torch.as_tensor(ds.images).to(dev)
    if not (bool(torch.isfinite(rgb).all()) and 0 <= float(rgb.min())
            and float(rgb.max()) <= 1):
        raise AssertionError("Blender images outside [0, 1]")
    print(f"[blender] 2 views of 64x48 written by write_png, read by "
          f"Blender: {ds.num_rays} rays and images {tuple(rgb.shape)} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    g = torch.Generator().manual_seed(24)
    B, N = 4096, 32
    ins = dict(o=torch.randn(B, 3, generator=g) * 0.3,
               d=torch.randn(B, 3, generator=g),
               r=torch.rand(B, 1, generator=g) * 0.01 + 1e-3,
               near=torch.full((B, 1), 0.5), far=torch.full((B, 1), 20.0),
               u=torch.rand(B, N + 1, generator=g),
               rgb=torch.rand(B, N, 3, generator=g),
               density=torch.rand(B, N, 1, generator=g) * 3)
    out = {}
    for where in ("cpu", "cuda"):
        x = {k: v.to(where) for k, v in ins.items()}
        t_inv, (m, c) = mip.sample_along_rays_360(
            x["o"], x["d"], x["r"], N, x["near"], x["far"], t_rand=x["u"])
        comp = mip.volumetric_lighting_composing(
            x["rgb"], x["density"], 1.0 / t_inv, x["d"], True)
        out[where] = dict(t_inv=t_inv, means=m, covs=c,
                          ipe=mip.integrated_pos_enc_360(m, c),
                          contract=mip.contract(m), comp_rgb=comp[0],
                          distance=comp[1], acc=comp[2], weights=comp[3])
    errs = {}
    for k, want in out["cpu"].items():
        got = out["cuda"][k].cpu()
        errs[k] = float((got - want).abs().max()) / max(
            1.0, float(want.abs().max()))
    print(f"[ops360] {B} rays x {N} samples, card vs CPU, max abs err over "
          f"max(1, scale) (tolerance {OPS360_TOL:g}): " + json.dumps(
              {k: float(f"{v:.3e}") for k, v in errs.items()}), flush=True)
    for k, v in errs.items():
        hold(f"ops360 {k}", v, OPS360_TOL)
    return served


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
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.get_num_threads()} CPU threads",
          flush=True)
    build_kernels()
    from pano_nerf_tpu_torch.kernels import build

    from pano_nerf_tpu_torch.core.config import load_config
    from pano_nerf_tpu_torch.core.rays import rays_to_tensors
    from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
    from pano_nerf_tpu_torch.models.mip_nerf import MipNeRF
    from pano_nerf_tpu_torch.models.pano_mip_nerf import PanoMipNeRF
    dev = torch.device("cuda")
    hp = load_config(CONFIG)
    model = PanoMipNeRF.from_hparams(
        hp, torch.Generator().manual_seed(0)).to(dev)
    env = rays_to_tensors(generate_lit_rays(hp["nerf.num_ray_samples"],
                                            far=10.0, radius=0.0142), dev)
    enter_phase("2")
    with torch.no_grad():
        entry = check_kernels(model, env, dev)
    calls, levels, surf = train_shapes(model, env, dev)
    wentry = _wgrad_entry()
    train_entries = check_train_kernels(model, dev, calls, wentry)
    k5_entries = check_train_render_kernel(model, dev, levels, wentry)
    k1_entries = check_fused_mlp_kernel(model, dev, levels, wentry)
    preset_entries = check_train_kernels(
        model, dev, preset_shapes(model, env, dev, calls, surf), wentry,
        forward_only=PRESET_FWD_ONLY, tag="[kernel-presets]",
        sfx="_presets")
    del calls, levels, surf
    # 2s: the study switches' kernel shapes.
    enter_phase("2s")
    k2k3_s, k5_s, k4_s = study_shapes(model, env, dev)
    study_entries = check_train_kernels(
        model, dev, k2k3_s, wentry, forward_only=("probe",),
        tag="[kernel-study]", sfx="_study")
    study_entries += check_train_render_kernel(
        model, dev, k5_s, wentry, sfx="_study", tag="[kernel-study]")
    with torch.no_grad():
        study_entries.append(check_kernels(model, env, dev, shapes=k4_s,
                                           sfx="_study",
                                           tag="[kernel-study]"))
    del k2k3_s, k5_s, k4_s
    # 2d: kernel 2 on the scale-distill re-march.
    enter_phase("2d")
    sd_entries = check_train_kernels(
        model, dev, scale_distill_shapes(model, env, dev), wentry,
        tag="[kernel-sd]", sfx="_sd")
    enter_phase("2m")
    mip_model = MipNeRF.from_hparams(
        load_config(MIP_CONFIG), torch.Generator().manual_seed(0)).to(dev)
    mip_entries = check_train_kernels(
        mip_model, dev, mip_shapes(mip_model, dev), wentry, ndc=1,
        forward_only=MIP_EVAL, tag="[kernel-mip]", sfx="_c1")
    del mip_model
    # 2w: the builds at the other MLP shapes.
    enter_phase("2w")
    shape_entries = check_other_shape_kernels(env, dev, wentry)
    # 2x: narrower models padded into the builds.
    enter_phase("2x")
    build.LOADED.clear()
    padded_entries = check_padded_kernels(env, dev, wentry)
    check_libraries("2x")
    # 2y: the 512 / 256 builds.
    enter_phase("2y")
    wide_entries = check_wide_kernels(env, dev, wentry)
    check_libraries("2y")
    # 2z: the 1,024 builds, each tile on a pair of CTAs.
    enter_phase("2z")
    pair_entries = check_pair_kernels(env, dev, wentry)
    check_libraries("2z")
    if wentry["max_abs_err"] != wentry["max_abs_err"]:
        raise AssertionError("weight-gradient pass gave NaN")
    with tempfile.TemporaryDirectory() as workdir:
        enter_phase("3")
        scene = make_scene(workdir)
        run = drive_main_path(workdir, scene, ["--init_seed", "0"])
        where_the_time_goes(scene)
        check_against_plain(scene)
        enter_phase("4")
        train = drive_train_path(workdir, scene)
        train_k5 = drive_train_path(workdir, scene, render_kernel=True)
        print(f"[train-k5] steady train rays/s with the key on "
              f"{train_k5['rays_per_s']:.1f} vs off {train['rays_per_s']:.1f}"
              f" (ms per step {512e3 / train_k5['rays_per_s']:.3f} vs "
              f"{512e3 / train['rays_per_s']:.3f})", flush=True)
        trained = drive_main_path(workdir, scene,
                                  ["--ckpt_dir", train["save_dir"]],
                                  step=TRAIN_STEPS)
        where_the_time_goes(scene, params=train["trainer"].ckpt.restore(
            map_location=dev)["params"], tag="[eval-trained]")
        base_times = {}
        enter_phase("5")
        for t in (train, train_k5):
            check_train_step_against_cpu(t["trainer"])
            check_graphed_against_eager(t["trainer"])
            base_times[t is train_k5] = time_train_modes(t["trainer"])
            profile_train_step(t["trainer"])
        del train["trainer"], train_k5["trainer"]
        # 25-26m: the 512 / 256 and 1,024 builds trained and served, early,
        # so that their CPU steps (the widest) run in the pool beside the
        # later phases' card work; each phase's libraries printed and
        # checked.
        shape_runs = {}
        for ph in LATE_PHASES:
            build.LOADED.clear()
            shape_runs[ph] = drive_level_phase(ph, workdir, scene,
                                               base_times)
            check_libraries(ph)
        build.LOADED.clear()
        shape_runs["26k"] = drive_key_off_phase(workdir, scene)
        check_libraries("26k")
        # 7: mip-NeRF eval; 8: its train path (8b: the checkpoint served;
        # 8c: with the orientation loss, kernel 3 forward and backward).
        enter_phase("7")
        mip_run = drive_main_path(workdir, scene, ["--init_seed", "0"],
                                  config=MIP_CONFIG)
        where_the_time_goes(scene, tag="[eval-mip]", config=MIP_CONFIG)
        check_against_plain(scene, MIP_CONFIG, tag="[check-mip]")
        enter_phase("8")
        mip_train = drive_train_path(workdir, scene, config=MIP_CONFIG)
        mip_trained = drive_main_path(workdir, scene,
                                      ["--ckpt_dir", mip_train["save_dir"]],
                                      step=TRAIN_STEPS, config=MIP_CONFIG)
        where_the_time_goes(scene, params=mip_train["trainer"].ckpt.restore(
            map_location=dev)["params"], tag="[eval-mip-trained]",
            config=MIP_CONFIG)
        check_train_step_against_cpu(mip_train["trainer"])
        check_graphed_against_eager(mip_train["trainer"])
        time_train_modes(mip_train["trainer"])
        profile_train_step(mip_train["trainer"])
        mip_ort = drive_train_path(workdir, scene, config=MIP_CONFIG,
                                   opts=("loss.ort_loss", "0.1"),
                                   steps=MIP_ORT_STEPS)
        del mip_train["trainer"]
        # 9: the HDR preset, 10: the shadow preset: train (9/10), serve
        # the checkpoints (9b/10b), one step against the CPU, graphed
        # steps against eager ones (10: across the tie's fall), times and
        # the profile (9c/10c).
        enter_phase("9")
        presets = {c: drive_train_path(workdir, scene, config=c)
                   for c in PRESETS}
        served = {}
        for c, t in presets.items():
            served[c] = drive_main_path(workdir, scene,
                                        ["--ckpt_dir", t["save_dir"]],
                                        step=TRAIN_STEPS, config=c)
            where_the_time_goes(
                scene, params=t["trainer"].ckpt.restore(
                    map_location=dev)["params"],
                tag=f"[eval{_family(t['trainer'].system)['sfx']}-trained]",
                config=c)
        check_against_plain(scene, HDR_CONFIG, tag="[check-hdr]")
        for c, t in presets.items():
            enter_phase("9c" if c == HDR_CONFIG else "10c")
            check_train_step_against_cpu(t["trainer"])
            check_graphed_against_eager(
                t["trainer"],
                start_step=SHADOW_WINDOW if c == SHADOW_CONFIG else 0)
            time_train_modes(t["trainer"])
            profile_train_step(t["trainer"])
            del t["trainer"]
        # 11: novel-view frames from a checkpoint of each family.
        enter_phase("11")
        saves = {CONFIG: train["save_dir"],
                 HDR_CONFIG: presets[HDR_CONFIG]["save_dir"],
                 MIP_CONFIG: mip_train["save_dir"]}
        frames = {c: drive_render_path(workdir, scene, save, c)
                  for c, save in saves.items()}
        # 12-14: the study switches: train, one step against the CPU,
        # graphed steps against eager ones, ms per step; 12 also the
        # freeze inside a graph and its checkpoint served (12b).
        enter_phase("12")
        study = {ph: drive_train_path(workdir, scene, render_kernel=k5,
                                      opts=opts, steps=steps,
                                      name=f"study{ph}")
                 for ph, (opts, k5, steps) in STUDY_PHASES.items()}
        opts12, _, steps12 = STUDY_PHASES[12]
        served12 = drive_main_path(workdir, scene,
                                   ["--ckpt_dir", study[12]["save_dir"]],
                                   step=steps12, opts=opts12)
        where_the_time_goes(scene, params=study[12]["trainer"].ckpt.restore(
            map_location=dev)["params"], tag="[eval-study12-trained]",
            opts=opts12)
        for ph, t in study.items():
            enter_phase(str(ph))
            check_train_step_against_cpu(t["trainer"])
            check_graphed_against_eager(
                t["trainer"], start_step=STUDY_WINDOW if ph == 12 else 0)
            if ph == 12:
                check_illum_freeze(t["trainer"])
            ms = time_train_modes(t["trainer"])
            g8 = "graph, 8 steps per replay"
            print(f"[time-study{ph}] graph of 8 steps {ms[g8]:.3f} ms per "
                  f"step (key {'on' if STUDY_PHASES[ph][1] else 'off'}) vs "
                  f"the fixed env set in this call: phase 4 (key off) "
                  f"{base_times[False][g8]:.3f}, phase 4b (key on) "
                  f"{base_times[True][g8]:.3f}", flush=True)
            del t["trainer"]
        # 15-18: the plain route (f32, a mip-NeRF topology, both heads)
        # and the last loss terms on the kernels.
        plain_runs = {ph: drive_plain_phase(ph, workdir, scene, base_times)
                      for ph in PLAIN_PHASES}
        # 19-20: the level loop and the last model and system keys.
        level_runs = [r for ph in LEVEL_PHASES
                      for r in drive_level_phase(ph, workdir, scene,
                                                 base_times)]
        # 21-23m: the other MLP shapes and the padded widths, trained and
        # served, each phase's libraries printed and checked.
        for ph in (p for p in SHAPE_PHASES if p not in LATE_PHASES):
            build.LOADED.clear()
            shape_runs[ph] = drive_level_phase(ph, workdir, scene,
                                               base_times)
            check_libraries(ph)
        # 24: the library modules (a reference checkpoint imported and
        # served, the native EXR decoder, the Blender loader, 360 ops).
        imported = drive_library_phase(workdir, scene)
        # The step checks' comparisons, as their CPU steps come in.
        finish_step_checks()
    enter_phase("report")
    entry["launches"] = run["launches"]["fused_render_level"]
    for e in train_entries:
        e["launches"] = train["launches"][e["name"]]
    for e in k5_entries:
        e["launches"] = train_k5["launches"][e["name"]]
    mip_runs = (mip_run, mip_trained, mip_train, mip_ort, frames[MIP_CONFIG])
    for e in mip_entries:   # the one-channel build, over the mip-NeRF runs
        e["launches"] = sum(r["launches"][e["name"][:-3]] for r in mip_runs)
    preset_runs = (tuple(presets.values()) + tuple(served.values())
                   + (frames[HDR_CONFIG],))
    for e in preset_entries:   # the presets' shapes, over the preset runs
        e["launches"] = sum(r["launches"][e["name"][:-len("_presets")]]
                            for r in preset_runs)
    study_runs = tuple(study.values()) + (served12,)
    for e in study_entries:   # the study shapes, over the study runs
        e["launches"] = sum(r["launches"][e["name"][:-len("_study")]]
                            for r in study_runs)
    for e in sd_entries:   # the re-march's shape, over phase 18's run
        e["launches"] = plain_runs[18]["launches"][e["name"][:-len("_sd")]]
    # The other shapes' entries, over their phases' runs (train and
    # served): A over 21, B over 22, C over 22m; kernel 1 at A, as at the
    # shipped shape, and kernel 5 at B (22 runs with the key off) are on
    # no main path.
    for e in shape_entries["H"] + shape_entries["H2"]:
        e["launches"] = 0   # no phase trains H or H2
    for name, ph in (("A", "21"), ("B", "22"), ("C", "22m")):
        for e in shape_entries[name]:
            e["launches"] = sum(r["launches"][e["name"][:-len("_wA")]]
                                for r in shape_runs[ph])
            if e["launches"] == 0 and not (
                    e["name"].startswith("fused_mlp_apply")
                    or e["name"].startswith("fused_render_train")
                    and name == "B"):
                raise AssertionError(f"{e['name']}: no launch on phase "
                                     f"{ph}'s path")
    # The padded widths' entries: P1 over phase 23 and the imported P1
    # checkpoint served in phase 24; P2's kernels 2 and 3 (one density
    # channel) over phase 23m; kernel 1 at either, and kernels 4 and 5 at
    # P2 (23m is mip-NeRF), are on no main path.
    padded_runs = {"P1": tuple(shape_runs["23"]) + (imported,),
                   "P2": tuple(shape_runs["23m"])}
    for name, runs in padded_runs.items():
        for e in padded_entries[name]:
            base = e["name"][:-len("_pP1")]
            e["launches"] = sum(r["launches"][base] for r in runs)
            on_path = (not base.startswith("fused_mlp_apply")
                       if name == "P1" else base.startswith(
                           ("fused_mlp_ipe", "fused_mlp_normals")))
            if on_path and e["launches"] == 0:
                raise AssertionError(f"{e['name']}: no launch on its "
                                     f"phases' path")
    # The 512 / 256 builds' entries: D over phase 25, Dm over 25m; kernel
    # 1 at D and every kernel at P3 (a model no phase trains) are on no
    # main path.
    # The 1,024 builds' likewise: E over phases 26 (key on) and 26k (key
    # off), Em over 26m; kernel 1 at E and every kernel at P4 are on no
    # main path.
    for name, sfx, runs, es in (
            ("D", "_wD", shape_runs["25"], wide_entries),
            ("Dm", "_wDm", shape_runs["25m"], wide_entries),
            ("P3", "_pP3", (), wide_entries),
            ("E", "_wE", shape_runs["26"] + shape_runs["26k"], pair_entries),
            ("Em", "_wEm", shape_runs["26m"], pair_entries),
            ("P4", "_pP4", (), pair_entries)):
        for e in es[name]:
            base = e["name"][:-len(sfx)]
            e["launches"] = sum(r["launches"][base] for r in runs)
            on_path = (not name.startswith("P")
                       and not base.startswith("fused_mlp_apply"))
            if on_path and e["launches"] == 0:
                raise AssertionError(f"{e['name']}: no launch on its "
                                     f"phase's path")
    for e in k1_entries + [wentry]:   # counted over every run
        e["launches"] = sum(r["launches"][e["name"]]
                            for r in (run, trained, train, train_k5,
                                      frames[CONFIG]) + mip_runs
                            + preset_runs + study_runs
                            + tuple(plain_runs.values())
                            + tuple(level_runs)
                            + tuple(r for rs in shape_runs.values()
                                    for r in rs) + (imported,))
    print(f"[card] {card}")
    print(json.dumps({"kernels": k1_entries + train_entries + [wentry, entry]
                      + k5_entries + mip_entries + preset_entries
                      + study_entries + sd_entries
                      + [e for es in shape_entries.values() for e in es]
                      + [e for es in padded_entries.values() for e in es]
                      + [e for es in wide_entries.values() for e in es]
                      + [e for es in pair_entries.values() for e in es]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException as exc:
        what = (str(exc).splitlines() or [""])[0]
        if not isinstance(exc, CheckFailed):
            what = f"{type(exc).__name__}: {what}"
        print(f"[fail] phase {PHASE}: {what}", flush=True)
        raise
    finally:
        close_cpu_pool()
    if code:
        print(f"[fail] phase {PHASE}: exit code {code} (no card or no "
              "checkout)", flush=True)
    sys.exit(code)
