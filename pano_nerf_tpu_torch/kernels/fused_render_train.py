"""Whole training render level on the H100, forward and backward (kernel 5).

Replaces the TPU kernel `fused_render_train` of
pano_nerf_tpu/kernels/fused_render_train.py:451 (`_forward_core` :106,
`_train_bwd_kernel` :188; pallas_call :358 and :399; custom VJP :416-448).
One forward launch renders one level of a ray batch with no normals: IPE,
the trunk and heads, padded-softplus radiance and density, and
alpha compositing, returning per ray rgb, acc, the clipped expected
distance and the weights. The backward is hand-derived (derivation at
fused_render_train.py:26-43): the compositing adjoint per ray, then the
MLP backward and the IPE adjoint, giving the gradient of all 8 lanes of
the moments (means, covs, delta, t_mid) and of every parameter. The
training coarse level and the secondary env queries take it when
`nerf.use_train_render_kernel` is on.

What bounds it on an H100: tensor-core operations, as kernel 2 (611,328
MACs per sample row forward, 3 x 611,328 backward, against 96 B of
inputs per row); compositing is O(S) per ray. At batch 512 the coarse
level is 512 x 56 = 28,672 rows and the env queries 5,120 x 5 = 25,600.

Design (csrc/fused_render_train.cu, sharing csrc/mlp_rows.cuh with
kernels 1-3): one block of two consumer warpgroups and a producer warpgroup
per tile of floor(64 / S) whole rays, so compositing stays inside a block
(at S = 56 a tile is one ray and 8 of its 64 rows idle; in the 1,024-wide
build a tile runs on a pair of CTAs, as kernels 2 and 3 do); the MLP on
`wgmma` products with TMA-streamed weights; compositing and its adjoint
as sequential f32 scans, one thread per ray. The backward is two
launches: the row pass (recompute, or load the bf16 trunk spill of
`save_acts` by TMA, then the adjoints) writes the operand rows of the
weight-gradient pass of csrc/fused_mlp.cu, which reduces them; weight
gradients are rounded to bf16 as the TPU kernel's are.

The source is built once per model shape (`shapes.MlpShape` with 5
density channels; the viewdir codes arrive encoded, with identity, as
JAX's kernel 5 encodes them, fused_render_train.py:483, so a model
without identity is refused: JAX's kernel raises on it).

`fused_render_train` is the wrapper: its plain version
`fused_render_train_reference` runs for CPU tensors, the CUDA kernels for
CUDA tensors, anything else raises. Launches are counted in
`fused_render_train.launches` and `.backward_launches`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from pano_nerf_tpu_torch.kernels import build
from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
from pano_nerf_tpu_torch.kernels import shapes
from pano_nerf_tpu_torch.kernels.fused_render import check_inputs, softplus
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.ops import mip

Tensor = torch.Tensor

SOURCE = "fused_render_train.cu"
OUT8 = 8          # per-ray output: rgb(3) | acc | distance | 0(3)
TILE_ROWS = 64    # sample rows per block: the largest S the kernel takes


def check_kernel_support(mlp: NerfMLP, num_samples: int, min_deg: int,
                         max_deg: int, deg_view: int,
                         device: torch.device) -> None:
    """Raise ValueError unless the kernels cover this model and sample
    count on `device`: the checks of `fused_mlp_ipe.check_kernel_support`
    (on the card the widths, IPE degrees and viewdir degrees of the
    builds), a viewdir encoding with identity (JAX's kernel 5 encodes it
    so and raises on an MLP without it), on the card 5 density channels,
    and 1 <= S <= 64."""
    k2.check_kernel_support(mlp, min_deg, max_deg, device)
    if deg_view < 1 or mlp.view_dim != 3 + 6 * deg_view:
        raise ValueError(f"fused_render_train encodes viewdirs with "
                         f"identity at deg_view >= 1; got deg_view "
                         f"{deg_view} for an MLP of view_dim "
                         f"{mlp.view_dim}")
    if device.type == "cuda" and mlp.num_density_channels != 5:
        raise ValueError(f"fused_render_train is built for 5 density "
                         f"channels, got {mlp.num_density_channels}")
    if not 1 <= num_samples <= TILE_ROWS:
        raise ValueError(f"fused_render_train takes 1..{TILE_ROWS} samples "
                         f"per ray, got {num_samples}")


def kernel_library(shape: shapes.MlpShape = shapes.STANDARD
                   ) -> ctypes.CDLL:
    """The library of SOURCE built for `shape` (5 density channels),
    built at first use and configured once."""
    defines = shape.defines(with_channels=False)
    lib = (build.load_library(SOURCE, defines) if defines
           else build.load_library(SOURCE))
    if not getattr(lib, "_pano_configured", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_render_train_forward.argtypes = (
            [ptr] * 8 + [i32, i32, i32, f32, f32, i32, ptr])
        lib.fused_render_train_backward_rows.argtypes = (
            [ptr] * 13 + [i32, i32, i32, f32, f32, i32, ptr])
        lib.fused_render_train_blocks.argtypes = [i32, i32]
        lib.fused_render_train_bias_workspace.argtypes = [i32, ptr]
        for fn in ("fused_render_train_forward",
                   "fused_render_train_backward_rows",
                   "fused_render_train_blocks",
                   "fused_render_train_bias_workspace"):
            getattr(lib, fn).restype = i32
        shapes.check_built_shape(lib, "fused_render_train_shape", shape,
                                 defines)
        lib._pano_configured = True
    return lib


class Level(NamedTuple):
    """A launch's static arguments (`shape`: the MLP's, which picks the
    libraries)."""
    R: int
    S: int
    min_deg: int
    density_bias: float
    rgb_padding: float
    white_bkgd: bool
    shape: shapes.MlpShape = shapes.STANDARD


def level_rows(means: Tensor, covs: Tensor, viewdirs: Tensor,
               t_samples: Tensor, dirs: Tensor, deg_view: int
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """The kernels' inputs: moments [R*S, 8] f32 (means | covs | delta |
    t_mid, differentiable), the clip bounds [R, 2] (t_0 | t_S) and the
    viewdir encoding per row [R*S, VP] bf16 (both without gradient)."""
    R, S = means.shape[:2]
    t_mids = 0.5 * (t_samples[:, :-1] + t_samples[:, 1:])
    delta = ((t_samples[:, 1:] - t_samples[:, :-1])
             * torch.linalg.norm(dirs, dim=-1, keepdim=True))
    mc = torch.cat([means.reshape(-1, 3), covs.reshape(-1, 3),
                    delta.reshape(-1, 1), t_mids.reshape(-1, 1)], dim=1)
    clip = torch.cat([t_samples[:, :1], t_samples[:, -1:]],
                     dim=1).detach().contiguous()
    venc = mip.pos_enc(viewdirs, 0, deg_view, True)[:, None, :]
    return mc, clip, k2.viewdir_rows(venc, (R, S))


def launch_forward(mc: Tensor, clip: Tensor, v: Tensor, weights: Tensor,
                   biases: Tensor, lv: Level, save_acts: bool,
                   lib: Optional[ctypes.CDLL] = None
                   ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """One forward launch (of `lib`, by default this package's library for
    `lv.shape`); returns out [R, 8], weights [R, S] and, with
    `save_acts`, the bf16 trunk spill [R*S, 8 W]. Not counted."""
    lib = kernel_library(lv.shape) if lib is None else lib
    dev = mc.device
    out = torch.empty((lv.R, OUT8), dtype=torch.float32, device=dev)
    w = torch.empty((lv.R, lv.S), dtype=torch.float32, device=dev)
    acts = (torch.empty((lv.R * lv.S, 8 * lv.shape.W), dtype=torch.bfloat16,
                        device=dev) if save_acts else None)
    err = lib.fused_render_train_forward(
        mc.data_ptr(), clip.data_ptr(), v.data_ptr(), weights.data_ptr(),
        biases.data_ptr(), out.data_ptr(), w.data_ptr(),
        acts.data_ptr() if save_acts else None, lv.R, lv.S, lv.min_deg,
        lv.density_bias, lv.rgb_padding, int(lv.white_bkgd),
        torch.cuda.current_stream(dev).cuda_stream)
    k2.check_launch(k2.kernel_library(lv.shape),
                    "fused_render_train forward", err)
    return out, w, acts


def run_backward(counter, mlp: NerfMLP, mc: Tensor, clip: Tensor, v: Tensor,
                 weights: Tensor, biases: Tensor, acts: Optional[Tensor],
                 g_out: Tensor, g_w: Tensor, lv: Level
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Backward row pass + weight-gradient pass, both counted on `counter`;
    returns (d mc [R*S, 8], {parameter name: gradient})."""
    mlp_lib = k2.kernel_library(lv.shape)
    ops, dw, db = k2.backward_buffers(
        mlp_lib, weights, biases,
        kernel_library(lv.shape).fused_render_train_blocks(lv.R, lv.S)
        * TILE_ROWS, False)
    dmc = torch.empty((lv.R * lv.S, 8), dtype=torch.float32,
                      device=mc.device)
    launch_backward_rows(mc, clip, v, weights, biases, acts, g_out, g_w, lv,
                         ops, dmc, db)
    counter.backward_launches += 1
    return dmc, k2.weight_grads(mlp_lib, counter, mlp, ops, dw, db)


def launch_backward_rows(mc: Tensor, clip: Tensor, v: Tensor,
                         weights: Tensor, biases: Tensor,
                         acts: Optional[Tensor], g_out: Tensor, g_w: Tensor,
                         lv: Level, ops: Tensor, dmc: Tensor, db: Tensor,
                         lib: Optional[ctypes.CDLL] = None) -> None:
    """One launch of the backward row pass (of `lib`, by default this
    package's library for `lv.shape`): writes d mc, the operand rows
    `ops` (64 per block) and the bias gradients into db. Not counted."""
    lib = kernel_library(lv.shape) if lib is None else lib
    part, count = k2.bias_workspace(lib.fused_render_train_bias_workspace,
                                    lib.fused_render_train_blocks(lv.R, lv.S),
                                    mc.device)
    err = lib.fused_render_train_backward_rows(
        mc.data_ptr(), clip.data_ptr(), v.data_ptr(), weights.data_ptr(),
        biases.data_ptr(), g_out.data_ptr(), g_w.data_ptr(),
        acts.data_ptr() if acts is not None else None, ops.data_ptr(),
        dmc.data_ptr(), db.data_ptr(), part.data_ptr(), count.data_ptr(),
        lv.R, lv.S, lv.min_deg,
        lv.density_bias, lv.rgb_padding, int(lv.white_bkgd),
        torch.cuda.current_stream(mc.device).cuda_stream)
    k2.check_launch(k2.kernel_library(lv.shape),
                    "fused_render_train backward", err)


class _FusedRenderTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mc, clip, v, weights, biases, meta, *params):
        mlp, lv, save_acts = meta
        out, w, acts = launch_forward(mc, clip, v, weights, biases, lv,
                                      save_acts)
        fused_render_train.launches += 1
        ctx.meta = meta
        ctx.save_for_backward(mc, clip, v, weights, biases, acts)
        return out, w

    @staticmethod
    def backward(ctx, g_out, g_w):
        mc, clip, v, weights, biases, acts = ctx.saved_tensors
        mlp, lv, _ = ctx.meta
        g_out = (mc.new_zeros(lv.R, OUT8) if g_out is None
                 else g_out.contiguous())
        g_w = mc.new_zeros(lv.R, lv.S) if g_w is None else g_w.contiguous()
        dmc, grads = run_backward(fused_render_train, mlp, mc, clip, v,
                                  weights, biases, acts, g_out, g_w, lv)
        names = [n for n, _ in mlp.named_parameters()]
        return ((dmc, None, None, None, None, None)
                + tuple(grads[n] for n in names))


def fused_render_train(mlp: NerfMLP, means: Tensor, covs: Tensor,
                       viewdirs: Tensor, t_samples: Tensor, dirs: Tensor, *,
                       min_deg: int, max_deg: int, deg_view: int,
                       density_bias: float, rgb_padding: float,
                       white_bkgd: bool, save_acts: bool = False,
                       packed: Optional[Tuple[Tensor, Tensor]] = None
                       ) -> Dict[str, Tensor]:
    """Render one training level; differentiable (first order) w.r.t. the
    parameters, means, covs, t_samples and dirs.

    means, covs: [R, S, 3]; viewdirs: [R, 3] unit view directions;
    t_samples: [R, S+1]; dirs: [R, 3] un-normalized ray directions (their
    norm scales the deltas); all float32 and contiguous. The viewdir
    encoding and the distance's clip bounds t_samples[:, 0] and [:, -1]
    are data (no gradient), as in the TPU kernel. `save_acts` spills the
    bf16 trunk activations for the backward instead of recomputing them
    (same results). `packed` is `fused_render.pack_params(mlp)`, computed
    here when not given. Returns rgb [R, 3], acc [R], distance [R] and
    weights [R, S], float32.
    """
    R, S = check_inputs("fused_render_train", means, covs, viewdirs,
                        t_samples, dirs)
    check_kernel_support(mlp, S, min_deg, max_deg, deg_view, means.device)
    if means.device.type == "cpu":
        return fused_render_train_reference(
            mlp, means, covs, viewdirs, t_samples, dirs, min_deg=min_deg,
            max_deg=max_deg, deg_view=deg_view, density_bias=density_bias,
            rgb_padding=rgb_padding, white_bkgd=white_bkgd)
    if means.device.type != "cuda":
        raise ValueError(f"fused_render_train runs on cpu or cuda tensors, "
                         f"got {means.device}")
    shape = shapes.build_of(mlp)
    weights, biases = k2.packed_for(mlp, packed, means.device,
                                    k2.kernel_library(shape))
    mc, clip, v = level_rows(means, covs, viewdirs, t_samples, dirs,
                             deg_view)
    params = [p for _, p in mlp.named_parameters()]
    save_acts = bool(save_acts) and torch.is_grad_enabled() and (
        mc.requires_grad or any(p.requires_grad for p in params))
    lv = Level(R, S, min_deg, float(density_bias), float(rgb_padding),
               bool(white_bkgd), shape)
    out, w = _FusedRenderTrain.apply(mc, clip, v, weights, biases,
                                     (mlp, lv, save_acts), *params)
    return dict(rgb=out[:, 0:3], acc=out[:, 3], distance=out[:, 4],
                weights=w)


fused_render_train.launches = 0
fused_render_train.backward_launches = 0


def fused_render_train_reference(mlp: NerfMLP, means: Tensor, covs: Tensor,
                                 viewdirs: Tensor, t_samples: Tensor,
                                 dirs: Tensor, *, min_deg: int, max_deg: int,
                                 deg_view: int, density_bias: float,
                                 rgb_padding: float, white_bkgd: bool
                                 ) -> Dict[str, Tensor]:
    """Plain PyTorch version: IPE -> NerfMLP -> padded softplus radiance
    and softplus density -> `mip.volumetric_rendering`, differentiated by
    torch autograd. As in the kernel, the viewdir encoding and the clip
    bounds of the distance carry no gradient; matmul operands are rounded
    to the MLP's compute dtype with float32 accumulation."""
    x = mip.integrated_pos_enc(means, covs, min_deg, max_deg)
    v = mip.pos_enc(viewdirs, 0, deg_view, True).detach()[:, None, :]
    raw_rgb, raw_density = mlp(x, v)
    density = softplus(raw_density[..., :1] + density_bias)
    rgb = softplus(raw_rgb) * (1.0 + 2.0 * rgb_padding) - rgb_padding
    comp_rgb, _, acc, weights = mip.volumetric_rendering(
        rgb, density, t_samples, dirs, white_bkgd)
    t_mids = 0.5 * (t_samples[:, :-1] + t_samples[:, 1:])
    distance = torch.sum(weights * t_mids, dim=-1) / torch.clamp(acc,
                                                                 min=1e-10)
    distance = torch.minimum(torch.maximum(distance,
                                           t_samples[:, 0].detach()),
                             t_samples[:, -1].detach())
    return dict(rgb=comp_rgb, acc=acc, distance=distance, weights=weights)
