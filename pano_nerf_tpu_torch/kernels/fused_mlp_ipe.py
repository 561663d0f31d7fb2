"""IPE + NerfMLP on the H100 for training, forward and backward (kernel 2).

Replaces the TPU kernel `fused_mlp_ipe_apply` of
pano_nerf_tpu/kernels/fused_mlp_ipe.py:268 (`_fwd_kernel` :109,
`_bwd_ipe_kernel` :124-199). One call evaluates the MLP on raw Gaussian
moments: the integrated positional encoding is computed in the kernel, then
the 8x256 trunk, the density head (C = 5 channels for Pano-NeRF, 1 for
mip-NeRF), the bottleneck and the 1x128 view branch. The backward returns
the gradient of the moments (the env queries need it: their means depend
on the fine level's distance) and of every weight and bias; the viewdir
encoding gets none.

What bounds it on an H100. The forward: tensor-core operations, 611,328
MACs per row against 96 B of inputs and 64 B out (0.035 ms per 28,672
rows at 989 TFLOP/s dense bf16). The backward is two launches, each with
its own floor. The row pass recomputes the forward and runs the data
gradients (2 x 611,328 MACs per row, 0.071 ms per 28,672 rows) and writes
every operand of every weight-gradient product as bf16 rows (`ops`, 5,024
columns = 10 KB per row: 288 MB, >= 0.086 ms at 3.35 TB/s): bytes bound
it. The weight-gradient pass reads those rows once (>= 0.086 ms) for
611,328 MACs per row. The function's own bound, which leaves the operand
rows out, is 0.106 ms at 28,672 rows.

Design (csrc/fused_mlp.cu, template IPE; steps in csrc/mlp_rows.cuh):
the row kernels run one 64-row tile per block on warpgroup `wgmma`
products, the activation tile in 128-byte-swizzled shared memory as the A
operand, the weights streamed by TMA from a producer warpgroup through a
3-slice ring, epilogues from registers and 64-column operand rows
written by TMA stores. The weight-gradient pass is a TMA + `wgmma` GEMM:
128 x 256 output tiles, both operands MN-major in shared memory (the
reduction runs over the rows), a 4-stage ring fed by a producer warpgroup,
row chunks split over one wave of blocks and added into a zeroed f32
buffer in chunk order. Every f32 sum across blocks (those chunks, the row
passes' bias sums over tiles: `bias_workspace`) adds in a fixed order,
so a backward gives the same bits at every run; weight gradients are
then rounded to bf16 as both JAX paths round them. `wgrad_jobs` is the pass's
job table: the kernel takes it from here at every launch, and its plain
version `weight_grads_reference` runs the same table on the same operand
rows. The O_* columns mirror the layout the CUDA row passes write
(`csrc/mlp_rows.cuh`); `kernel_library` checks the widths against it.

The MLP's shape is a set of compile-time constants of the CUDA sources
(csrc/nerf_mlp.cuh): the density-channel count C (5 for Pano-NeRF, 1 for
mip-NeRF), the trunk width W (128, 256 or 512), the view-branch width
VW (64, 128 or 256), the IPE degree count L = max_deg - min_deg (1..16;
min_deg is a runtime argument) and the viewdir encoding's width VF
(deg_view 1..4, with or without identity); the plain version takes any
width and any number of degrees, as JAX's kernel does. `MlpShape`
(kernels/shapes.py) holds them; `MlpShape.defines` maps a shape to its
build's preprocessor definitions
(none for the shipped shape), `shape_of(mlp)` reads a model's,
`build_of(mlp)` names the build it runs in (a narrower trunk or view
branch zero-padded to the next build's width by `pack_params`, the
gradients sliced back by `unpack_params`), and `kernel_library(shape)`
builds and loads the library for a build at first use. Every shape keeps the
padded 16-lane head: the forward writes raw density into lanes 3..3+C-1
of the output slab and zeros past them, and the backward reads the head
cotangent of those lanes only, so the padded rows of the packed density
head get zero gradient and `unpack_params` returns the [C, W] head. The
IPE features are padded to XF (6 L rounded up to 16) and the viewdir
codes to VP (VF rounded up to 16) with zeros, over zero columns of the
packed weights.

`fused_mlp_ipe_apply` is the wrapper: it validates its inputs, runs the
plain PyTorch version `fused_mlp_ipe_reference` (IPE -> NerfMLP, torch
autograd for the backward) for CPU tensors and the CUDA kernels for CUDA
tensors, or raises. It counts forward launches in
`fused_mlp_ipe_apply.launches` and backward launches (row pass and
weight-gradient pass, two per backward) in
`fused_mlp_ipe_apply.backward_launches`; every weight-gradient pass (of
kernels 1, 2, 3 and 5) also counts in `weight_grads.launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pano_nerf_tpu_torch.kernels import build
from pano_nerf_tpu_torch.kernels.fused_render import (pack_params,
                                                      unpack_params)
from pano_nerf_tpu_torch.kernels.shapes import (HP, STANDARD, MlpShape,
                                                build_of, check_built_shape,
                                                pad16, shape_gaps, shape_of)
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.ops import mip

Tensor = torch.Tensor

SOURCE = "fused_mlp.cu"
OUT_W = 16     # output slab: raw rgb (3) | raw density (C) | 0


def check_kernel_support(mlp: NerfMLP, min_deg: int, max_deg: int,
                         device: torch.device) -> None:
    """Raise ValueError unless the kernels cover `mlp` on `device`
    (`shape_gaps`)."""
    want, bad = shape_gaps(mlp, min_deg, max_deg, device)
    if bad:
        raise ValueError(f"the fused MLP kernels support only the topology "
                         f"and shapes {want}; got {bad}")


def check_inputs(name: str, means: Tensor, covs: Tensor, v_enc: Tensor,
                 view_dim: int) -> Tuple[int, ...]:
    """Validate [..., 3] moments and a [..., view_dim] viewdir encoding of
    the same rank whose leading dims broadcast against the moments'.
    Returns the leading dims."""
    if means.ndim < 2 or means.shape[-1] != 3:
        raise ValueError(f"{name}: means must be [..., 3], got "
                         f"{tuple(means.shape)}")
    if tuple(covs.shape) != tuple(means.shape):
        raise ValueError(f"{name}: covs must match means "
                         f"{tuple(means.shape)}, got {tuple(covs.shape)}")
    lead = tuple(means.shape[:-1])
    if v_enc.ndim != means.ndim or v_enc.shape[-1] != view_dim or any(
            a not in (1, b) for a, b in zip(v_enc.shape[:-1], lead)):
        raise ValueError(f"{name}: v_enc must be [..., {view_dim}] "
                         f"broadcastable to {lead}, got "
                         f"{tuple(v_enc.shape)}")
    for t_name, t in (("means", means), ("covs", covs), ("v_enc", v_enc)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t_name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
        if t.device != means.device:
            raise ValueError(f"{name}: {t_name} is on {t.device}, means on "
                             f"{means.device}")
    if means.numel() == 0:
        raise ValueError(f"{name}: needs at least one row")
    if means.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got "
                         f"{means.device}")
    return lead


def kernel_library(shape: MlpShape = STANDARD) -> ctypes.CDLL:
    """The library of SOURCE built for `shape` (`MlpShape.defines`),
    built at first use and configured once."""
    defines = shape.defines()
    lib = (build.load_library(SOURCE, defines) if defines
           else build.load_library(SOURCE))
    if not getattr(lib, "_pano_configured", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fused_mlp_forward.argtypes = [ptr] * 7 + [i32, i32, i32, ptr]
        lib.fused_mlp_backward_rows.argtypes = [ptr] * 13 + [i32, i32, i32,
                                                             ptr]
        lib.fused_mlp_weight_grads.argtypes = [ptr, ptr, i32, i32, ptr, i32,
                                               ptr, i32, ptr]
        lib.fused_mlp_encoded_forward.argtypes = [ptr] * 5 + [i32, ptr]
        lib.fused_mlp_encoded_backward_rows.argtypes = [ptr] * 10 + [i32, ptr]
        lib.fused_mlp_bias_workspace.argtypes = [i32, ptr]
        for fn in ("fused_mlp_forward", "fused_mlp_backward_rows",
                   "fused_mlp_encoded_forward",
                   "fused_mlp_encoded_backward_rows",
                   "fused_mlp_bias_workspace",
                   "fused_mlp_weight_grads", "fused_mlp_weight_count",
                   "fused_mlp_bias_count", "fused_mlp_tile_rows",
                   "fused_mlp_ops_width", "fused_mlp_density_channels"):
            getattr(lib, fn).restype = i32
        for fn in ("fused_mlp_weight_count", "fused_mlp_bias_count",
                   "fused_mlp_tile_rows", "fused_mlp_density_channels"):
            getattr(lib, fn).argtypes = []
        lib.fused_mlp_ops_width.argtypes = [i32]
        lib.fused_mlp_error_string.argtypes = [i32]
        lib.fused_mlp_error_string.restype = ctypes.c_char_p
        check_built_shape(lib, "fused_mlp_shape", shape, defines)
        # The job table and the plain version index the operand rows and
        # the packed weights by this module's layout of the shape.
        lay = layout(shape)
        got = (lib.fused_mlp_ops_width(0), lib.fused_mlp_ops_width(1),
               lib.fused_mlp_weight_count())
        if got != (lay.OPW_IPE, lay.OPW_NRM, lay.W_TOTAL):
            raise RuntimeError(f"{SOURCE} lays out operand rows and weights "
                               f"as {got}, this module as "
                               f"{(lay.OPW_IPE, lay.OPW_NRM, lay.W_TOTAL)}")
        lib._pano_shape = shape
        lib._pano_configured = True
    return lib


def check_launch(lib: ctypes.CDLL, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.fused_mlp_error_string(err).decode())


def packed_for(mlp: NerfMLP, packed: Optional[Tuple[Tensor, Tensor]],
               device: torch.device, lib: ctypes.CDLL
               ) -> Tuple[Tensor, Tensor]:
    """The kernels' packed (bf16 weights, f32 biases), checked."""
    weights, biases = pack_params(mlp) if packed is None else packed
    if (weights.dtype != torch.bfloat16 or biases.dtype != torch.float32
            or weights.numel() != lib.fused_mlp_weight_count()
            or biases.numel() != lib.fused_mlp_bias_count()
            or weights.device != device or biases.device != device
            or not weights.is_contiguous() or not biases.is_contiguous()):
        raise ValueError("packed parameters do not match the kernel layout")
    return weights, biases


def rows_of(means: Tensor, covs: Tensor, v_enc: Tensor,
            lead: Sequence[int]) -> Tuple[Tensor, Tensor]:
    """Kernel rows: moments [M, 8] f32 (means | covs | 0 0) and the
    viewdir encoding per row [M, VP] bf16 (`viewdir_rows`)."""
    M = means.numel() // 3
    mc = torch.cat([means.reshape(M, 3), covs.reshape(M, 3),
                    means.new_zeros(M, 2)], dim=1)
    return mc, viewdir_rows(v_enc, lead)


def viewdir_rows(v_enc: Tensor, lead: Sequence[int]) -> Tensor:
    """The viewdir encoding [..., VF], broadcast to the leading dims
    `lead`, as kernel rows [M, VP] bf16 (VF rounded up to 16, zero past
    VF; 32 for the shipped 27); no gradient."""
    vf = v_enc.shape[-1]
    v = v_enc.detach().expand(*lead, vf).reshape(-1, vf)
    return F.pad(v, (0, pad16(vf) - vf)).to(torch.bfloat16).contiguous()


def bias_workspace(query, tiles: int, device: torch.device
                   ) -> Tuple[Tensor, Tensor]:
    """Scratch of the bias sums of a backward row pass over `tiles` blocks
    (csrc/mlp_rows.cuh `bias_sums`): the f32 partial rows and the zeroed
    int32 counters, sized by the library's `query` (its
    `*_bias_workspace` entry point)."""
    ints = ctypes.c_int()
    floats = query(tiles, ctypes.byref(ints))
    return (torch.empty(floats, dtype=torch.float32, device=device),
            torch.zeros(ints.value, dtype=torch.int32, device=device))


def backward_buffers(lib: ctypes.CDLL, weights: Tensor, biases: Tensor,
                     rows: int, normals: bool
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Scratch of a backward: the bf16 operand rows [rows, width] of the
    weight-gradient pass and the zeroed f32 weight and bias gradients."""
    dev = weights.device
    ops = torch.empty((rows, lib.fused_mlp_ops_width(int(normals))),
                      dtype=torch.bfloat16, device=dev)
    dw = torch.zeros(weights.numel(), dtype=torch.float32, device=dev)
    db = torch.zeros(biases.numel(), dtype=torch.float32, device=dev)
    return ops, dw, db


class Layout(NamedTuple):
    """Columns of a backward's bf16 operand rows (csrc/mlp_rows.cuh: every
    operand of every weight-gradient product, one row per sample row) and
    offsets of the packed weights (csrc/nerf_mlp.cuh), in elements, for
    one `MlpShape`."""
    O_X: int      # MLP input features x (XF)
    O_A: int      # trunk activations a_0..a_7
    O_BTL: int    # bottleneck
    O_V: int      # viewdir encoding (VP)
    O_HV: int     # view-branch activation (VW)
    O_DZ: int     # trunk cotangents dz_0..dz_7
    O_GD: int     # density-head cotangent (16)
    O_DBTL: int   # bottleneck cotangent
    O_DZV: int    # view-branch cotangent
    O_GR: int     # color-head cotangent (16)
    OPW_IPE: int
    O_CGX: int    # walk: cotangent of g_x (XF)
    O_C: int      # walk: c_0..c_6
    O_SZ: int     # chain: sz_0..sz_7
    OPW_NRM: int
    OFF_W0: int
    OFF_W1: int
    OFF_W5: int
    OFF_W6: int
    OFF_WD: int
    OFF_WB: int
    OFF_WV: int
    OFF_WC: int
    W_TOTAL: int


@functools.lru_cache(maxsize=None)
def layout(shape: MlpShape = STANDARD) -> Layout:
    W, VW, XF, VP, VK = shape.W, shape.VW, shape.XF, shape.VP, shape.VK
    o = dict(O_X=0)
    o["O_A"] = o["O_X"] + XF
    o["O_BTL"] = o["O_A"] + 8 * W
    o["O_V"] = o["O_BTL"] + W
    o["O_HV"] = o["O_V"] + VP
    o["O_DZ"] = o["O_HV"] + VW
    o["O_GD"] = o["O_DZ"] + 8 * W
    o["O_DBTL"] = o["O_GD"] + HP
    o["O_DZV"] = o["O_DBTL"] + W
    o["O_GR"] = o["O_DZV"] + VW
    o["OPW_IPE"] = o["O_GR"] + HP
    o["O_CGX"] = o["OPW_IPE"]
    o["O_C"] = o["O_CGX"] + XF
    o["O_SZ"] = o["O_C"] + 7 * W
    o["OPW_NRM"] = o["O_SZ"] + 8 * W
    o["OFF_W0"] = 0
    o["OFF_W1"] = o["OFF_W0"] + W * XF
    o["OFF_W5"] = o["OFF_W1"] + 4 * W * W
    o["OFF_W6"] = o["OFF_W5"] + W * (W + XF)
    o["OFF_WD"] = o["OFF_W6"] + 2 * W * W
    o["OFF_WB"] = o["OFF_WD"] + HP * W
    o["OFF_WV"] = o["OFF_WB"] + W * W
    o["OFF_WC"] = o["OFF_WV"] + VW * VK
    o["W_TOTAL"] = o["OFF_WC"] + HP * VW
    return Layout(**o)


# The shipped shape's layout, by name.
(O_X, O_A, O_BTL, O_V, O_HV, O_DZ, O_GD, O_DBTL, O_DZV, O_GR, OPW_IPE,
 O_CGX, O_C, O_SZ, OPW_NRM, OFF_W0, OFF_W1, OFF_W5, OFF_W6, OFF_WD, OFF_WB,
 OFF_WV, OFF_WC, W_TOTAL) = layout(STANDARD)


MAX_FAN_IN = 256   # fan-in columns of one job: the pass's wgmma N
MAX_JOBS = 32      # jobs of one launch (csrc/fused_mlp.cu MAX_JOBS)


def wgrad_jobs(normals: bool, shape: MlpShape = STANDARD
               ) -> List[Tuple[int, ...]]:
    """The weight-gradient products of a backward, the job table that
    `launch_weight_grads` hands the CUDA pass (`fused_mlp_weight_grads`)
    and `weight_grads_reference` runs: (b1, a1, b2, a2, n, k, out, ldo),
    dW[n, k] += B1^T A1 (+ B2^T A2) over the rows, B the fan-out side
    (cotangent columns), A the fan-in side (layer inputs), written at
    `out` with row stride `ldo` in the packed layout of `shape`; b2 < 0:
    one pair. NORMALS adds the chain's sz_i against the walk's c_{i-1} to
    each trunk weight. A fan-in wider than MAX_FAN_IN (the 512-wide
    build's) is split into jobs of MAX_FAN_IN columns each."""
    return [part for job in _layer_jobs(normals, shape)
            for part in _split_fan_in(job)]


def _split_fan_in(job: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    b1, a1, b2, a2, n, k, out, ldo = job
    return [(b1, a1 + c, b2, a2 + c if b2 >= 0 else a2, n,
             min(MAX_FAN_IN, k - c), out + c, ldo)
            for c in range(0, k, MAX_FAN_IN)]


def _layer_jobs(normals: bool, shape: MlpShape) -> List[Tuple[int, ...]]:
    """One job per packed weight (or per block of its fan-in columns)."""
    lay, W, XF, VW = layout(shape), shape.W, shape.XF, shape.VW
    VK, VP = shape.VK, shape.VP

    def pair(i, a_col):   # chain column and walk column of trunk layer i
        return (lay.O_SZ + i * W, a_col) if normals else (-1, -1)
    trunk = [(lay.O_DZ, lay.O_X, *pair(0, lay.O_CGX), W, XF, lay.OFF_W0, XF)]
    for i in range(1, 5):
        trunk.append((lay.O_DZ + i * W, lay.O_A + (i - 1) * W,
                      *pair(i, lay.O_C + (i - 1) * W), W, W,
                      lay.OFF_W1 + (i - 1) * W * W, W))
    trunk += [(lay.O_DZ + 5 * W, lay.O_A + 4 * W, *pair(5, lay.O_C + 4 * W),
               W, W, lay.OFF_W5, W + XF),
              (lay.O_DZ + 5 * W, lay.O_X, *pair(5, lay.O_CGX), W, XF,
               lay.OFF_W5 + W, W + XF)]
    for i in (6, 7):
        trunk.append((lay.O_DZ + i * W, lay.O_A + (i - 1) * W,
                      *pair(i, lay.O_C + (i - 1) * W), W, W,
                      lay.OFF_W6 + (i - 6) * W * W, W))
    return trunk + [
        (lay.O_GD, lay.O_A + 7 * W, -1, -1, HP, W, lay.OFF_WD, W),
        (lay.O_DBTL, lay.O_A + 7 * W, -1, -1, W, W, lay.OFF_WB, W),
        (lay.O_DZV, lay.O_BTL, -1, -1, VW, W, lay.OFF_WV, VK),
        (lay.O_DZV, lay.O_V, -1, -1, VW, VP, lay.OFF_WV + W, VK),
        (lay.O_GR, lay.O_HV, -1, -1, HP, VW, lay.OFF_WC, VW)]


def weight_grads_reference(ops: Tensor, normals: bool,
                           shape: MlpShape = STANDARD) -> Tensor:
    """Plain version of the weight-gradient pass: the packed f32 weight
    gradients [W_TOTAL] of the operand rows `ops` [rows, OPW] (bf16 or
    f32) of `shape`, one f32 matmul per job (a NORMALS trunk job stacks
    its two pairs along the rows). Tests and chip_smoke.py hold the
    kernel against it; no main-path code calls it. The walk's part of
    Wd's sigma row (the column sum of c_7) is added by the row pass, not
    here."""
    lay = layout(shape)
    width = lay.OPW_NRM if normals else lay.OPW_IPE
    if ops.ndim != 2 or ops.shape[1] != width:
        raise ValueError(f"ops must be [rows, {width}], got "
                         f"{tuple(ops.shape)}")
    o = ops.float()
    dw = torch.zeros(lay.W_TOTAL, dtype=torch.float32, device=ops.device)
    for b1, a1, b2, a2, n, k, out, ldo in wgrad_jobs(normals, shape):
        b, a = o[:, b1:b1 + n], o[:, a1:a1 + k]
        if b2 >= 0:
            b = torch.cat([b, o[:, b2:b2 + n]], 0)
            a = torch.cat([a, o[:, a2:a2 + k]], 0)
        dw.as_strided((n, k), (ldo, 1), out).add_(b.t() @ a)
    return dw


def tile_rows(lib: ctypes.CDLL, M: int) -> int:
    """M rounded up to whole 64-row tiles."""
    tile = lib.fused_mlp_tile_rows()
    return -(-M // tile) * tile


def launch_weight_grads(lib: ctypes.CDLL, ops: Tensor, dw: Tensor,
                        normals: bool) -> None:
    """One launch of the CUDA weight-gradient pass of the library `lib`
    (built for one `MlpShape`): adds the packed weight gradients of the
    operand rows `ops` [rows, OPW] bf16 (rows a multiple of 64) into the
    f32 buffer dw [W_TOTAL]. Not counted."""
    shape = lib._pano_shape
    lay = layout(shape)
    width = lay.OPW_NRM if normals else lay.OPW_IPE
    if (ops.dtype != torch.bfloat16 or ops.ndim != 2
            or ops.shape[1] != width or ops.shape[0] % 64
            or not ops.is_contiguous() or dw.dtype != torch.float32
            or dw.numel() != lay.W_TOTAL or not dw.is_contiguous()):
        raise ValueError(f"weight gradients need bf16 ops [64 k, {width}] "
                         f"and f32 dw [{lay.W_TOTAL}]")
    jobs = _job_table(normals, shape)
    # The pass's block counter and one flag per output tile, zeroed.
    sync = torch.zeros(1 + _job_tiles(normals, shape), dtype=torch.int32,
                       device=ops.device)
    stream = torch.cuda.current_stream(ops.device).cuda_stream
    check_launch(lib, "fused_mlp weight gradients", lib.fused_mlp_weight_grads(
        ops.data_ptr(), dw.data_ptr(), ops.shape[0], int(normals), jobs,
        len(jobs) // 8, sync.data_ptr(), sync.numel(), stream))


@functools.lru_cache(maxsize=None)
def _job_tiles(normals: bool, shape: MlpShape = STANDARD) -> int:
    """Output tiles (128 fan-out rows of a job) of the pass's job table."""
    return sum(-(-job[4] // 128) for job in wgrad_jobs(normals, shape))


_JOB_TABLES: Dict[Tuple[bool, MlpShape], ctypes.Array] = {}


def _job_table(normals: bool, shape: MlpShape = STANDARD) -> ctypes.Array:
    """`wgrad_jobs(normals, shape)` flattened into a C int array, made
    once."""
    key = (normals, shape)
    if key not in _JOB_TABLES:
        flat = [v for job in wgrad_jobs(normals, shape) for v in job]
        _JOB_TABLES[key] = (ctypes.c_int * len(flat))(*flat)
    return _JOB_TABLES[key]


def weight_grads(lib: ctypes.CDLL, counter, mlp: NerfMLP, ops: Tensor,
                 dw: Tensor, db: Tensor, normals: bool = False
                 ) -> Dict[str, Tensor]:
    """The weight-gradient pass over the operand rows `ops` of a backward
    row pass (this library's or kernel 5's), counted on `counter`; returns
    {parameter name: gradient}."""
    launch_weight_grads(lib, ops, dw, normals)
    counter.backward_launches += 1
    weight_grads.launches += 1
    # Weight gradients are rounded to bf16 (the packed weights' type), as
    # the TPU kernels' `dw.astype(p.dtype)`, in one pass over the packed
    # buffer; bias gradients stay f32. The gradients are views of these
    # per-call buffers.
    return unpack_params(mlp, dw.to(torch.bfloat16).float(), db)


weight_grads.launches = 0


def launch_forward(lib: ctypes.CDLL, mc: Tensor, v: Tensor, weights: Tensor,
                   biases: Tensor, min_deg: int, normals: bool,
                   save_acts: bool = False
                   ) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """One forward launch of the library `lib`; returns out [M, OUT_W]
    and, with `normals`, d sigma / d x [M, 3] and (with `save_acts`) the
    bf16 trunk spill [M, 8 W]. Not counted."""
    M, dev = mc.shape[0], mc.device
    out = torch.empty((M, OUT_W), dtype=torch.float32, device=dev)
    dsig = (torch.empty((M, 3), dtype=torch.float32, device=dev)
            if normals else None)
    acts = (torch.empty((M, 8 * lib._pano_shape.W), dtype=torch.bfloat16,
                        device=dev) if normals and save_acts else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check_launch(lib, "fused_mlp forward", lib.fused_mlp_forward(
        mc.data_ptr(), v.data_ptr(), weights.data_ptr(), biases.data_ptr(),
        out.data_ptr(), dsig.data_ptr() if normals else None,
        acts.data_ptr() if acts is not None else None, M, min_deg,
        int(normals), stream))
    return out, dsig, acts


def launch_backward_rows(lib: ctypes.CDLL, mc: Tensor, v: Tensor,
                         weights: Tensor, biases: Tensor, g: Tensor,
                         q: Optional[Tensor], acts: Optional[Tensor],
                         ops: Tensor, dmc: Tensor, dw: Tensor, db: Tensor,
                         min_deg: int, normals: bool) -> None:
    """One launch of the backward row pass: writes dmc, the operand rows
    `ops`, the bias gradients into db and (NORMALS) the walk's part of
    Wd's sigma row into the zeroed dw. Not counted."""
    stream = torch.cuda.current_stream(mc.device).cuda_stream
    part, count = bias_workspace(lib.fused_mlp_bias_workspace,
                                 tile_rows(lib, mc.shape[0])
                                 // lib.fused_mlp_tile_rows(), mc.device)
    check_launch(lib, "fused_mlp backward", lib.fused_mlp_backward_rows(
        mc.data_ptr(), v.data_ptr(), weights.data_ptr(), biases.data_ptr(),
        g.data_ptr(), q.data_ptr() if q is not None else None,
        acts.data_ptr() if acts is not None else None, ops.data_ptr(),
        dmc.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(),
        count.data_ptr(), mc.shape[0], min_deg, int(normals), stream))


def run_backward(lib: ctypes.CDLL, counter, mlp: NerfMLP, mc: Tensor,
                 v: Tensor, weights: Tensor, biases: Tensor, g: Tensor,
                 q: Optional[Tensor], acts: Optional[Tensor], min_deg: int,
                 normals: bool) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Backward row pass + weight-gradient pass; returns (d mc [M, 8],
    {parameter name: gradient})."""
    M = mc.shape[0]
    ops, dw, db = backward_buffers(lib, weights, biases, tile_rows(lib, M),
                                   normals)
    dmc = torch.empty((M, 8), dtype=torch.float32, device=mc.device)
    launch_backward_rows(lib, mc, v, weights, biases, g, q, acts, ops, dmc,
                         dw, db, min_deg, normals)
    counter.backward_launches += 1
    return dmc, weight_grads(lib, counter, mlp, ops, dw, db, normals)


class _FusedMlpIpe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mc, v, weights, biases, meta, *params):
        mlp, min_deg = meta
        out, _, _ = launch_forward(kernel_library(build_of(mlp)), mc, v,
                                   weights, biases, min_deg, normals=False)
        fused_mlp_ipe_apply.launches += 1
        ctx.meta = meta
        ctx.save_for_backward(mc, v, weights, biases)
        return out

    @staticmethod
    def backward(ctx, g):
        mc, v, weights, biases = ctx.saved_tensors
        mlp, min_deg = ctx.meta
        dmc, grads = run_backward(
            kernel_library(build_of(mlp)), fused_mlp_ipe_apply, mlp, mc, v,
            weights, biases, g.contiguous(), None, None, min_deg,
            normals=False)
        names = [n for n, _ in mlp.named_parameters()]
        return (dmc, None, None, None, None) + tuple(grads[n] for n in names)


def fused_mlp_ipe_apply(mlp: NerfMLP, means: Tensor, covs: Tensor,
                        v_enc: Tensor, *, min_deg: int, max_deg: int,
                        packed: Optional[Tuple[Tensor, Tensor]] = None
                        ) -> Tuple[Tensor, Tensor]:
    """IPE + NerfMLP on Gaussian moments; differentiable.

    means, covs: [..., 3] float32; v_enc: [..., mlp.view_dim] float32
    viewdir encoding of the same rank, broadcastable to the moments'
    leading dims.
    `packed` is `fused_render.pack_params(mlp)`, computed here when not
    given (pass it to share one packing between calls of a step). Returns
    raw_rgb [..., 3] and raw_density [..., C], float32 (C =
    `mlp.num_density_channels`).
    """
    lead = check_inputs("fused_mlp_ipe_apply", means, covs, v_enc,
                        mlp.view_dim)
    check_kernel_support(mlp, min_deg, max_deg, means.device)
    if means.device.type == "cpu":
        return fused_mlp_ipe_reference(mlp, means, covs, v_enc,
                                       min_deg=min_deg, max_deg=max_deg)
    C = mlp.num_density_channels
    lib = kernel_library(build_of(mlp))
    weights, biases = packed_for(mlp, packed, means.device, lib)
    mc, v = rows_of(means, covs, v_enc, lead)
    out = _FusedMlpIpe.apply(mc, v, weights, biases, (mlp, min_deg),
                             *[p for _, p in mlp.named_parameters()])
    return (out[:, :3].reshape(*lead, 3),
            out[:, 3:3 + C].reshape(*lead, C))


fused_mlp_ipe_apply.launches = 0
fused_mlp_ipe_apply.backward_launches = 0


def fused_mlp_ipe_reference(mlp: NerfMLP, means: Tensor, covs: Tensor,
                            v_enc: Tensor, *, min_deg: int, max_deg: int
                            ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version: IPE (float32) -> NerfMLP, differentiated by
    torch autograd. Matmul operands are rounded to the MLP's compute dtype
    with float32 accumulation, as in the kernel; so are their gradients
    (the autograd of that rounding rounds the cotangent too)."""
    x = mip.integrated_pos_enc(means, covs, min_deg, max_deg)
    return mlp(x, v_enc)
