"""Whole eval render level on the H100: IPE + NerfMLP + compositing + normals.

Replaces the TPU kernel `fused_render_level` (`_render_kernel`) of
pano_nerf_tpu/kernels/fused_render.py:128-315. One call renders one level
of a ray chunk: integrated positional encoding of the sample Gaussians, the
full trunk and heads with the viewdir encoding (built in the kernel, with
identity, as JAX's kernel builds it), softplus density and radiance, alpha compositing, expected distance, albedo and roughness, and
on the fine level the per-sample density-gradient normals and their
weighted average. Only per-ray products leave the kernel.

What bounds it on an H100: tensor-core operations. A sample row of the
shipped 8x256 / 1x128 model costs 611,328 MACs of MLP (1.22 MFLOP), plus
507,904 MACs (1.02 MFLOP) of normal chain on the fine level, against 32
B of input moments. A 128x256 panorama
(32,768 rays x (56 + 56 + 10*5) rows) is 8.4 TFLOP: >= 8.5 ms at 989
TFLOP/s dense bf16, while its inputs move in ~0.05 ms at 3.35 TB/s.

Design (csrc/fused_render.cu): tiles of <= 128 sample rows of whole rays
(`plan_tiles`: 2 rays at S=56, 25 at S=5), walked by one persistent
block per SM; two consumer warpgroups each own 64 rows and run every
product on `wgmma` (bf16 operands from shared memory, float32
accumulators in registers) over all its output columns, while a producer
warpgroup streams the bf16 weights from L2 by TMA through a 2-stage ring,
so each weight byte in shared memory serves 128 rows; the ReLU masks are
kept as bits for the normal chain; compositing is a sequential float32
scan per ray. The 512-wide build takes tiles of <= 64 rows (1 ray at
S=56, 12 at S=5; `tile_rows`) whose two warpgroups split every
product's columns instead (two 64-row tiles do not fit a block at that
width). The source is built once per model shape (`shapes.MlpShape`:
trunk 128, 256 or 512, view branch 64, 128 or 256, IPE degrees 1..16,
deg_view 1..4 with identity; 5 density channels), each build a library
of its own (`kernel_library(shape)`); a narrower trunk or view branch
runs zero-padded in the next build (`pack_params`).

`fused_render_level` is the wrapper: it validates its inputs, runs the
plain PyTorch version `fused_render_level_reference` for CPU tensors and
launches the CUDA kernel for CUDA tensors (or raises). It counts its
launches in `fused_render_level.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pano_nerf_tpu_torch.kernels import build
from pano_nerf_tpu_torch.kernels import shapes
from pano_nerf_tpu_torch.models import normals as normals_lib
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.ops import mip

Tensor = torch.Tensor

SOURCE = "fused_render.cu"
TILE_ROWS = 128      # sample rows per tile (whole rays only), W <= 256
MAX_SAMPLES = 64     # the largest S the kernel takes
OUT_FIXED = 17       # rgb(3) | acc | distance | albedo(3) | roughness |
#                      normal(3) | ort | 0(4), then the S weights
_HP = 16             # padded head width


def softplus(x: Tensor) -> Tensor:
    """log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|)), the kernel's form."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def check_kernel_support(mlp: NerfMLP, num_samples: int, min_deg: int,
                         max_deg: int, deg_view: int,
                         device: torch.device) -> None:
    """Raise ValueError unless the kernel covers this model and sample
    count on `device`: kernel 2's topology and shapes
    (`shapes.shape_gaps`: on the card the widths and degrees it is built
    for, on the CPU any), the 5-channel density head, a viewdir encoding
    with identity (the kernel builds it so, as JAX's does; on the card
    deg_view 1..4) and 1 <= S <= 64."""
    want, bad = shapes.shape_gaps(mlp, min_deg, max_deg, device)
    top = shapes.MAX_DEG_VIEW if device.type == "cuda" else None
    want.update(num_density_channels=(5,),
                view_dim=f"3 + 6 deg_view, deg_view 1..{top or ''}")
    if mlp.num_density_channels != 5:
        bad["num_density_channels"] = mlp.num_density_channels
    if (not 1 <= deg_view <= (top or deg_view)
            or mlp.view_dim != 3 + 6 * deg_view):
        bad["view_dim"] = (mlp.view_dim, deg_view)
    if bad:
        raise ValueError(f"fused_render_level supports only the standard "
                         f"topology and shapes {want}; got {bad}")
    if not 1 <= num_samples <= MAX_SAMPLES:
        raise ValueError(f"fused_render_level takes 1..{MAX_SAMPLES} samples "
                         f"per ray, got {num_samples}")


class TilePlan(NamedTuple):
    """How one launch cuts R rays of S samples into tiles of whole rays."""
    rays_per_tile: int
    num_tiles: int
    R: int

    def rays(self, t: int) -> Tuple[int, int]:
        """The rays [first, end) of tile t, as the kernel indexes them
        (`ray0 = t * rpt`); the last tile may hold fewer."""
        if not 0 <= t < self.num_tiles:
            raise IndexError(f"tile {t} of {self.num_tiles}")
        first = t * self.rays_per_tile
        return first, min(first + self.rays_per_tile, self.R)


def tile_rows(shape: shapes.MlpShape = shapes.STANDARD) -> int:
    """Sample rows per tile in the build of `shape`: TILE_ROWS (two
    64-row tiles, row split) up to trunk 256, 64 (one tile, column split)
    in the 512-wide build."""
    return TILE_ROWS if shape.W <= 256 else TILE_ROWS // 2


def plan_tiles(R: int, S: int,
               shape: shapes.MlpShape = shapes.STANDARD) -> TilePlan:
    """The kernel's tiling in the build of `shape`: floor(tile_rows / S)
    whole rays per tile (at most `tile_rows(shape)` rows), ceil(R / that)
    tiles. `kernel_library` checks once, for every S, that the library
    cuts the same way (`fused_render_tile_rays`)."""
    if R < 1 or not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"no tiling for R={R}, S={S}")
    per = tile_rows(shape) // S
    return TilePlan(per, -(-R // per), R)


def check_inputs(name: str, means: Tensor, covs: Tensor, viewdirs: Tensor,
                 t_samples: Tensor, dirs: Tensor) -> Tuple[int, int]:
    """Validate one level's ray inputs (shapes, float32, contiguous, one
    device); returns (R, S)."""
    if means.ndim != 3 or means.shape[-1] != 3:
        raise ValueError(f"means must be [R, S, 3], got {tuple(means.shape)}")
    R, S = means.shape[:2]
    expect = dict(means=(means, (R, S, 3)), covs=(covs, (R, S, 3)),
                  viewdirs=(viewdirs, (R, 3)),
                  t_samples=(t_samples, (R, S + 1)), dirs=(dirs, (R, 3)))
    for arg, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{arg} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
        if t.device != means.device:
            raise ValueError(f"{arg} is on {t.device}, means on "
                             f"{means.device}")
    if R == 0:
        raise ValueError(f"{name} needs at least one ray")
    return R, S


# (K, N) of every product a tile streams from L2 as 64 x 64 bf16 TMA
# boxes: trunk 0..7, density, bottleneck, view, color; then the fine
# level's chain (layers 7..1, the skip columns of layer 5, layer 0).
_BOX_BYTES = 64 * 64 * 2


def weight_bytes_per_tile(need_normals: bool,
                          shape: shapes.MlpShape = shapes.STANDARD) -> int:
    """Bytes of weights one tile moves from L2 into shared memory (whole
    TMA boxes, zero-filled edges included) at `shape`, a build's
    (`shapes.build_of(mlp)`: a padded model moves its build's bytes)."""
    W, XF, VK, VW = shape.W, shape.XF, shape.VK, shape.VW
    prods = ([(XF, W)] + [(W, W)] * 4 + [(W + XF, W)] + [(W, W)] * 2
             + [(W, _HP), (W, W), (VK, VW), (VW, _HP)])
    if need_normals:
        prods += [(W, W)] * 7 + [(W, 128)] * 2
    return sum(-(-k // 64) * -(-n // 64) * _BOX_BYTES for k, n in prods)


# A packed layer: (parameter prefix, rows in the model, rows in the build,
# column blocks as (columns in the model, columns in the build)).
Block = Tuple[str, int, int, Tuple[Tuple[int, int], ...]]


def layer_blocks(mlp: NerfMLP) -> List[Block]:
    """The packed layers of `mlp` in the kernels' order, each with its
    rows and its column blocks in the model and in the build
    (`shapes.build_of`). Two layers split their input at the trunk width
    and so pad each block apart: the skip layer over [h4 | x] and the
    view layer over [bottleneck | viewdir codes]."""
    sh, b = shapes.shape_of(mlp), shapes.build_of(mlp)
    W, X, VW = (sh.W, b.W), (mlp.xyz_dim, b.XF), (sh.VW, b.VW)
    blocks = []
    for i in range(len(mlp.layers)):
        cols = ((X,) if i == 0 else (W, X) if i == mlp.skip_index + 1
                else (W,))
        blocks.append((f"layers.{i}.0", *W, cols))
    return blocks + [
        ("density_layer", sh.C, _HP, (W,)), ("extra_layer", *W, (W,)),
        ("view_layers.0.0", *VW, (W, (mlp.view_dim, b.VP))),
        ("color_layer", 3, _HP, (VW,))]


def pack_tensors(mlp: NerfMLP, tensors: Dict[str, Tensor]
                 ) -> Tuple[Tensor, Tensor]:
    """Per-parameter tensors of `mlp` (its parameters, their gradients)
    by parameter name -> flat float32 (weights, biases) in the kernels'
    layout at the build shape, every padded slot zero."""
    ws, bs = [], []
    for name, rows, brows, cols in layer_blocks(mlp):
        w = tensors[f"{name}.weight"].detach().float()
        parts, c0 = [], 0
        for c, bc in cols:
            parts.append(F.pad(w[:, c0:c0 + c], (0, bc - c)))
            c0 += c
        ws.append(F.pad(torch.cat(parts, 1), (0, 0, 0, brows - rows)))
        bs.append(F.pad(tensors[f"{name}.bias"].detach().float(),
                        (0, brows - rows)))
    return (torch.cat([w.reshape(-1) for w in ws]).contiguous(),
            torch.cat(bs).contiguous())


def pack_params(mlp: NerfMLP) -> Tuple[Tensor, Tensor]:
    """NerfMLP -> (bf16 weights, float32 biases) in the kernels' layout
    (csrc/nerf_mlp.cuh) at the build the MLP runs in (`shapes.build_of`:
    the model's own shape when it is a build's).

    Weights keep torch's [out, in] layout, zero-padded: trunk 0..7 (layer
    0 [W, XF] over the 6 L IPE features; layer 5 [W, W + XF] over [h4 |
    x]), density [16, W] (rows 0..C-1: C = 5 for Pano-NeRF, 1 for
    mip-NeRF), bottleneck [W, W], view [VW, W + VP] over [bottleneck |
    viewdir codes], color [16, VW] (rows 0..2). Biases: trunk 8 x W,
    density 16, bottleneck W, view VW, color 16. W, VW, XF (6 L rounded
    up to 16) and VP (the viewdir codes rounded up to 16) are the
    build's; a narrower model's rows and each block of its columns sit at
    the front of the build's, zeros after them (`layer_blocks`). At the
    shipped shape: XF 96, VP 32. The parameters themselves keep the
    model's shapes.
    """
    weights, biases = pack_tensors(mlp, dict(mlp.named_parameters()))
    return weights.to(torch.bfloat16), biases


def unpack_params(mlp: NerfMLP, weights: Tensor, biases: Tensor
                  ) -> Dict[str, Tensor]:
    """Inverse of `pack_params` for flat tensors in its layout (gradients,
    say): {parameter name of `mlp`: the slice at the model's shape}, in
    the flat tensors' dtype (views where a layer's blocks are contiguous
    in the build)."""
    out, w_off, b_off = {}, 0, 0
    for name, rows, brows, cols in layer_blocks(mlp):
        bcols = sum(bc for _, bc in cols)
        block = weights[w_off:w_off + brows * bcols].view(brows, bcols)
        if all(c == bc for c, bc in cols[:-1]):
            w = block[:rows, :sum(c for c, _ in cols)]
        else:
            parts, c0 = [], 0
            for c, bc in cols:
                parts.append(block[:rows, c0:c0 + c])
                c0 += bc
            w = torch.cat(parts, 1)
        out[f"{name}.weight"] = w
        out[f"{name}.bias"] = biases[b_off:b_off + rows]
        w_off += brows * bcols
        b_off += brows
    return out


def padded_slots(mlp: NerfMLP) -> Tuple[Tensor, Tensor]:
    """Boolean masks over `pack_params(mlp)`'s flat (weights, biases):
    True where a slot lies outside the model (rows, columns and lanes the
    build pads with zeros), whose gradients must be exactly zero."""
    weights, biases = pack_params(mlp)
    dev = weights.device
    masks = dict(weight=torch.ones(weights.numel(), dtype=torch.bool,
                                   device=dev),
                 bias=torch.ones(biases.numel(), dtype=torch.bool,
                                 device=dev))
    idx = unpack_params(mlp, torch.arange(weights.numel(), device=dev),
                        torch.arange(biases.numel(), device=dev))
    for name, t in idx.items():
        masks[name.rsplit(".", 1)[1]][t.reshape(-1)] = False
    return masks["weight"], masks["bias"]


def kernel_library(shape: shapes.MlpShape = shapes.STANDARD) -> ctypes.CDLL:
    """The library of SOURCE built for `shape` (5 density channels; its
    other values as `MlpShape.defines`), built at first use and configured
    once."""
    defines = shape.defines(with_channels=False)
    lib = (build.load_library(SOURCE, defines) if defines
           else build.load_library(SOURCE))
    if not getattr(lib, "_pano_configured", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_render_level_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32, f32, i32, i32, i32,
            ptr]
        lib.fused_render_level_launch.restype = i32
        lib.fused_render_error_string.argtypes = [i32]
        lib.fused_render_error_string.restype = ctypes.c_char_p
        lib.fused_render_tile_rays.argtypes = [i32]
        lib.fused_render_tile_rays.restype = i32
        for name in ("fused_render_weight_count", "fused_render_bias_count"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        shapes.check_built_shape(lib, "fused_render_shape", shape, defines)
        bad = {S: lib.fused_render_tile_rays(S)
               for S in range(1, MAX_SAMPLES + 1)
               if lib.fused_render_tile_rays(S)
               != plan_tiles(1, S, shape).rays_per_tile}
        if bad:
            raise RuntimeError(f"{SOURCE} cuts tiles unlike plan_tiles: "
                               f"rays per tile by S {bad}")
        lib._pano_configured = True
    return lib


def _unpack(out: Tensor, S: int, need_normals: bool, need_extras: bool
            ) -> Dict[str, Optional[Tensor]]:
    res = dict(rgb=out[:, 0:3], acc=out[:, 3], distance=out[:, 4],
               weights=out[:, OUT_FIXED:OUT_FIXED + S], normal=None,
               albedo=None, roughness=None, ort=None)
    if need_extras:
        res["albedo"], res["roughness"] = out[:, 5:8], out[:, 8]
    if need_normals:
        res["normal"], res["ort"] = out[:, 9:12], out[:, 12]
    return res


def level_rows(means: Tensor, covs: Tensor, viewdirs: Tensor,
               t_samples: Tensor, dirs: Tensor) -> Tuple[Tensor, Tensor]:
    """The kernel's inputs: per-row moments [R*S, 8] (means | covs |
    delta | t_mid) and per-ray info [R, 8] (viewdir | t_0 | t_S | dir)."""
    t_mids = 0.5 * (t_samples[:, :-1] + t_samples[:, 1:])
    delta = ((t_samples[:, 1:] - t_samples[:, :-1])
             * torch.linalg.norm(dirs, dim=-1, keepdim=True))
    mc = torch.cat([means.reshape(-1, 3), covs.reshape(-1, 3),
                    delta.reshape(-1, 1), t_mids.reshape(-1, 1)],
                   dim=1).contiguous()
    rayinfo = torch.cat([viewdirs, t_samples[:, :1], t_samples[:, -1:],
                         dirs], dim=1).contiguous()
    return mc, rayinfo


def launch_level(lib: ctypes.CDLL, mc: Tensor, rayinfo: Tensor,
                 weights: Tensor, biases: Tensor, R: int, S: int, *,
                 min_deg: int, density_bias: float, rgb_padding: float,
                 white_bkgd: bool, need_normals: bool, need_extras: bool
                 ) -> Tensor:
    """One launch of the library `lib` on rows from `level_rows`; returns
    the slab [R, 17 + S]. Not counted."""
    out = torch.empty((R, OUT_FIXED + S), dtype=torch.float32,
                      device=mc.device)
    stream = torch.cuda.current_stream(mc.device).cuda_stream
    err = lib.fused_render_level_launch(
        mc.data_ptr(), rayinfo.data_ptr(), weights.data_ptr(),
        biases.data_ptr(), out.data_ptr(), R, S, min_deg,
        float(density_bias), float(rgb_padding), int(bool(white_bkgd)),
        int(bool(need_normals)), int(bool(need_extras)), stream)
    if err != 0:
        raise RuntimeError("fused_render_level launch failed: "
                           + lib.fused_render_error_string(err).decode())
    return out


def fused_render_level(mlp: NerfMLP, means: Tensor, covs: Tensor,
                       viewdirs: Tensor, t_samples: Tensor, dirs: Tensor, *,
                       min_deg: int, max_deg: int, deg_view: int,
                       density_bias: float, rgb_padding: float,
                       white_bkgd: bool, need_normals: bool,
                       need_extras: bool,
                       packed: Optional[Tuple[Tensor, Tensor]] = None
                       ) -> Dict[str, Optional[Tensor]]:
    """Render one level; returns per-ray products.

    means, covs: [R, S, 3]; viewdirs: [R, 3] unit view directions;
    t_samples: [R, S+1]; dirs: [R, 3] un-normalized ray directions (their
    norm scales the deltas); all float32 and contiguous. `packed` is
    `pack_params(mlp)`, computed here when not given. Returns rgb [R, 3],
    acc [R], distance [R], weights [R, S] and, when asked for, normal
    [R, 3], ort [R] (sum_s w_norm relu(n_s . d)^2), albedo [R, 3],
    roughness [R]; float32.
    """
    R, S = check_inputs("fused_render_level", means, covs, viewdirs,
                        t_samples, dirs)
    check_kernel_support(mlp, S, min_deg, max_deg, deg_view, means.device)
    if means.device.type == "cpu":
        return fused_render_level_reference(
            mlp, means, covs, viewdirs, t_samples, dirs, min_deg=min_deg,
            max_deg=max_deg, deg_view=deg_view, density_bias=density_bias,
            rgb_padding=rgb_padding, white_bkgd=white_bkgd,
            need_normals=need_normals, need_extras=need_extras)
    if means.device.type != "cuda":
        raise ValueError(f"fused_render_level runs on cpu or cuda tensors, "
                         f"got {means.device}")
    if mlp.compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes in bf16; got compute "
                         f"dtype {mlp.compute_dtype} (train.precision)")
    weights, biases = pack_params(mlp) if packed is None else packed
    lib = kernel_library(shapes.build_of(mlp))
    if (weights.dtype != torch.bfloat16 or biases.dtype != torch.float32
            or weights.numel() != lib.fused_render_weight_count()
            or biases.numel() != lib.fused_render_bias_count()
            or weights.device != means.device
            or biases.device != means.device):
        raise ValueError("packed parameters do not match the kernel layout")

    mc, rayinfo = level_rows(means, covs, viewdirs, t_samples, dirs)
    out = launch_level(lib, mc, rayinfo, weights, biases, R, S,
                       min_deg=min_deg, density_bias=density_bias,
                       rgb_padding=rgb_padding, white_bkgd=white_bkgd,
                       need_normals=need_normals, need_extras=need_extras)
    fused_render_level.launches += 1
    return _unpack(out, S, need_normals, need_extras)


fused_render_level.launches = 0


def fused_render_level_reference(mlp: NerfMLP, means: Tensor, covs: Tensor,
                                 viewdirs: Tensor, t_samples: Tensor,
                                 dirs: Tensor, *, min_deg: int, max_deg: int,
                                 deg_view: int, density_bias: float,
                                 rgb_padding: float, white_bkgd: bool,
                                 need_normals: bool, need_extras: bool
                                 ) -> Dict[str, Optional[Tensor]]:
    """Plain PyTorch version of the kernel: IPE -> NerfMLP -> activations
    -> `volumetric_rendering` -> the explicit normal chain.

    The same function at the same arithmetic as the kernel: matmul
    operands rounded to the MLP's compute dtype, float32 accumulation and
    everything else in float32. Expectations divide by max(acc, 1e-12);
    each sample normal is -d raw_sigma / d means over max(norm, 1e-12)
    (the softplus factor cancels in the normalisation).
    """
    x = mip.integrated_pos_enc(means, covs, min_deg, max_deg)
    v = mip.pos_enc(viewdirs, 0, deg_view, True)[:, None, :]
    if need_normals:
        raw_rgb, raw_density, g_enc = normals_lib.mlp_with_density_grad(
            mlp, x, v)
    else:
        raw_rgb, raw_density = mlp(x, v)
    density = softplus(raw_density[..., :1] + density_bias)
    rgb = softplus(raw_rgb) * (1.0 + 2.0 * rgb_padding) - rgb_padding
    comp_rgb, distance, acc, weights = mip.volumetric_rendering(
        rgb, density, t_samples, dirs, white_bkgd)
    inv_acc = 1.0 / torch.clamp(acc, min=1e-12)
    res = dict(rgb=comp_rgb, acc=acc, distance=distance, weights=weights,
               normal=None, albedo=None, roughness=None, ort=None)
    if need_extras:
        albedo = torch.sigmoid(raw_density[..., 1:4]) * 0.77 + 0.03
        rough = softplus(raw_density[..., 4] - 1.0)
        res["albedo"] = torch.sum(weights[..., None] * albedo, 1) * inv_acc[:, None]
        res["roughness"] = torch.sum(weights * rough, 1) * inv_acc
    if need_normals:
        d_raw = normals_lib.density_means_grad(g_enc, x, min_deg, max_deg)
        n_s = -d_raw / torch.clamp(torch.linalg.norm(d_raw, dim=-1,
                                                     keepdim=True), min=1e-12)
        n = torch.sum(weights[..., None] * n_s, 1) * inv_acc[:, None]
        res["normal"] = n / torch.clamp(torch.linalg.norm(n, dim=-1,
                                                          keepdim=True),
                                        min=1e-12)
        ndot = torch.sum(n_s * dirs[:, None, :], -1)
        res["ort"] = torch.sum(weights * torch.relu(ndot) ** 2, 1) * inv_acc
    return res
