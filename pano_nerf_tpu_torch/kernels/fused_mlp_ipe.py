"""IPE + NerfMLP on the H100 for training, forward and backward (kernel 2).

Replaces the TPU kernel `fused_mlp_ipe_apply` of
pano_nerf_tpu/kernels/fused_mlp_ipe.py:268 (`_fwd_kernel` :109,
`_bwd_ipe_kernel` :124-199). One call evaluates the MLP on raw Gaussian
moments: the integrated positional encoding is computed in the kernel, then
the 8x256 trunk, the 5-channel density head, the bottleneck and the 1x128
view branch. The backward returns the gradient of the moments (the env
queries need it: their means depend on the fine level's distance) and of
every weight and bias; the viewdir encoding gets none.

What bounds it on an H100: tensor-core operations. A row is 611,328 MACs
forward; the backward recomputes the forward and adds the data and weight
gradients, 3 x 611,328 MACs, against 96 B of inputs and 64 B of
cotangent. At batch 512 a train step runs it on 82,944 rows (coarse
28,672, env 25,600, view consistency 28,672): ~0.1 TFLOP forward and
~0.3 TFLOP backward, >= 0.4 ms at 989 TFLOP/s dense bf16.

Design (csrc/fused_mlp.cu, template NORMALS=false): 64-row tiles, bf16
activations in shared memory, WMMA bf16 products with f32 accumulation,
weights read from L2. The backward's row kernel writes every operand of
the weight-gradient products (bf16 rows); a second kernel reduces
dW = dZ^T A over the rows in 64x64 output tiles and 2048-row chunks,
adding partial tiles with atomicAdd into a zeroed f32 buffer. The order of
those atomics varies between runs, so weight gradients vary in the last
f32 bits; they are then rounded to bf16 as both JAX paths round them.

`fused_mlp_ipe_apply` is the wrapper: it validates its inputs, runs the
plain PyTorch version `fused_mlp_ipe_reference` (IPE -> NerfMLP, torch
autograd for the backward) for CPU tensors and the CUDA kernels for CUDA
tensors, or raises. It counts forward launches in
`fused_mlp_ipe_apply.launches` and backward launches (row pass and
weight-gradient pass, two per backward) in
`fused_mlp_ipe_apply.backward_launches`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from pano_nerf_tpu_torch.kernels import build
from pano_nerf_tpu_torch.kernels.fused_render import (pack_params,
                                                      unpack_params)
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.ops import mip

Tensor = torch.Tensor

SOURCE = "fused_mlp.cu"
OUT_W = 16     # output slab: raw rgb (3) | raw density (5) | 0
V_PAD = 32     # viewdir encoding, padded (27 used)
_W, _VW, _XF, _VF = 256, 128, 96, 27


def check_kernel_support(mlp: NerfMLP, min_deg: int, max_deg: int,
                         device: torch.device) -> None:
    """Raise ValueError unless the kernels' specialisation covers `mlp`.

    The topology (8-deep trunk with the skip at layer 4, one view layer,
    3 rgb and 5 density channels, 16 IPE degrees, the 27-wide viewdir
    encoding) is required on every device. The widths (256 trunk, 128 view
    branch) and bf16 compute are what the CUDA kernels are compiled for;
    the plain version on the CPU takes any width.
    """
    want = dict(net_depth=8, skip_index=4, net_depth_condition=1,
                num_rgb_channels=3, num_density_channels=5,
                xyz_dim=_XF, view_dim=_VF)
    if device.type == "cuda":
        want.update(net_width=_W, net_width_condition=_VW)
    bad = {k: getattr(mlp, k) for k, v in want.items()
           if getattr(mlp, k) != v}
    if max_deg - min_deg != 16:
        bad["deg"] = (min_deg, max_deg)
    if bad:
        raise ValueError(f"the fused MLP kernels support only the topology "
                         f"{want}; got {bad}")
    if device.type == "cuda" and mlp.compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernels compute in bf16; got compute "
                         f"dtype {mlp.compute_dtype} (train.precision)")


def check_inputs(name: str, means: Tensor, covs: Tensor, v_enc: Tensor
                 ) -> Tuple[int, ...]:
    """Validate [..., 3] moments and a [..., 27] viewdir encoding of the
    same rank whose leading dims broadcast against the moments'. Returns
    the leading dims."""
    if means.ndim < 2 or means.shape[-1] != 3:
        raise ValueError(f"{name}: means must be [..., 3], got "
                         f"{tuple(means.shape)}")
    if tuple(covs.shape) != tuple(means.shape):
        raise ValueError(f"{name}: covs must match means "
                         f"{tuple(means.shape)}, got {tuple(covs.shape)}")
    lead = tuple(means.shape[:-1])
    if v_enc.ndim != means.ndim or v_enc.shape[-1] != _VF or any(
            a not in (1, b) for a, b in zip(v_enc.shape[:-1], lead)):
        raise ValueError(f"{name}: v_enc must be [..., {_VF}] broadcastable "
                         f"to {lead}, got {tuple(v_enc.shape)}")
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


def kernel_library() -> ctypes.CDLL:
    lib = build.load_library(SOURCE)
    if not getattr(lib, "_pano_configured", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fused_mlp_forward.argtypes = [ptr] * 7 + [i32, i32, i32, ptr]
        lib.fused_mlp_backward_rows.argtypes = [ptr] * 11 + [i32, i32, i32,
                                                             ptr]
        lib.fused_mlp_weight_grads.argtypes = [ptr, ptr, i32, i32, ptr]
        lib.fused_mlp_encoded_forward.argtypes = [ptr] * 5 + [i32, ptr]
        lib.fused_mlp_encoded_backward_rows.argtypes = [ptr] * 8 + [i32, ptr]
        for fn in ("fused_mlp_forward", "fused_mlp_backward_rows",
                   "fused_mlp_encoded_forward",
                   "fused_mlp_encoded_backward_rows",
                   "fused_mlp_weight_grads", "fused_mlp_weight_count",
                   "fused_mlp_bias_count", "fused_mlp_tile_rows",
                   "fused_mlp_ops_width"):
            getattr(lib, fn).restype = i32
        for fn in ("fused_mlp_weight_count", "fused_mlp_bias_count",
                   "fused_mlp_tile_rows"):
            getattr(lib, fn).argtypes = []
        lib.fused_mlp_ops_width.argtypes = [i32]
        lib.fused_mlp_error_string.argtypes = [i32]
        lib.fused_mlp_error_string.restype = ctypes.c_char_p
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
    viewdir encoding per row [M, 32] bf16 (27 used)."""
    M = means.numel() // 3
    mc = torch.cat([means.reshape(M, 3), covs.reshape(M, 3),
                    means.new_zeros(M, 2)], dim=1)
    return mc, viewdir_rows(v_enc, lead)


def viewdir_rows(v_enc: Tensor, lead: Sequence[int]) -> Tensor:
    """The viewdir encoding [..., 27], broadcast to the leading dims `lead`,
    as kernel rows [M, 32] bf16 (27 used); no gradient."""
    v = v_enc.detach().expand(*lead, _VF).reshape(-1, _VF)
    return F.pad(v, (0, V_PAD - _VF)).to(torch.bfloat16).contiguous()


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


def tile_rows(lib: ctypes.CDLL, M: int) -> int:
    """M rounded up to whole 64-row tiles."""
    tile = lib.fused_mlp_tile_rows()
    return -(-M // tile) * tile


def weight_grads(lib: ctypes.CDLL, counter, mlp: NerfMLP, ops: Tensor,
                 dw: Tensor, db: Tensor, normals: bool = False
                 ) -> Dict[str, Tensor]:
    """The weight-gradient pass over the operand rows `ops` of a backward
    row pass (this library's or kernel 5's), counted on `counter`; returns
    {parameter name: gradient}."""
    stream = torch.cuda.current_stream(ops.device).cuda_stream
    check_launch(lib, "fused_mlp weight gradients", lib.fused_mlp_weight_grads(
        ops.data_ptr(), dw.data_ptr(), ops.shape[0], int(normals), stream))
    counter.backward_launches += 1
    # Weight gradients are rounded to bf16 (the packed weights' type), as
    # the TPU kernels' `dw.astype(p.dtype)`; bias gradients stay f32.
    return {name: g.to(torch.bfloat16).float() if name.endswith(
        "weight") else g.clone()
        for name, g in unpack_params(mlp, dw, db).items()}


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
    stream = torch.cuda.current_stream(mc.device).cuda_stream
    check_launch(lib, "fused_mlp backward", lib.fused_mlp_backward_rows(
        mc.data_ptr(), v.data_ptr(), weights.data_ptr(), biases.data_ptr(),
        g.data_ptr(), q.data_ptr() if q is not None else None,
        acts.data_ptr() if acts is not None else None, ops.data_ptr(),
        dmc.data_ptr(), dw.data_ptr(), db.data_ptr(), M, min_deg,
        int(normals), stream))
    counter.backward_launches += 1
    return dmc, weight_grads(lib, counter, mlp, ops, dw, db, normals)


class _FusedMlpIpe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mc, v, weights, biases, meta, *params):
        mlp, min_deg = meta
        lib = kernel_library()
        M = mc.shape[0]
        out = torch.empty((M, OUT_W), dtype=torch.float32, device=mc.device)
        stream = torch.cuda.current_stream(mc.device).cuda_stream
        check_launch(lib, "fused_mlp_ipe forward", lib.fused_mlp_forward(
            mc.data_ptr(), v.data_ptr(), weights.data_ptr(),
            biases.data_ptr(), out.data_ptr(), None, None, M, min_deg, 0,
            stream))
        fused_mlp_ipe_apply.launches += 1
        ctx.meta = meta
        ctx.save_for_backward(mc, v, weights, biases)
        return out

    @staticmethod
    def backward(ctx, g):
        mc, v, weights, biases = ctx.saved_tensors
        mlp, min_deg = ctx.meta
        dmc, grads = run_backward(
            kernel_library(), fused_mlp_ipe_apply, mlp, mc, v, weights,
            biases, g.contiguous(), None, None, min_deg, normals=False)
        names = [n for n, _ in mlp.named_parameters()]
        return (dmc, None, None, None, None) + tuple(grads[n] for n in names)


def fused_mlp_ipe_apply(mlp: NerfMLP, means: Tensor, covs: Tensor,
                        v_enc: Tensor, *, min_deg: int, max_deg: int,
                        packed: Optional[Tuple[Tensor, Tensor]] = None
                        ) -> Tuple[Tensor, Tensor]:
    """IPE + NerfMLP on Gaussian moments; differentiable.

    means, covs: [..., 3] float32; v_enc: [..., 27] float32 viewdir
    encoding of the same rank, broadcastable to the moments' leading dims.
    `packed` is `fused_render.pack_params(mlp)`, computed here when not
    given (pass it to share one packing between calls of a step). Returns
    raw_rgb [..., 3] and raw_density [..., 5], float32.
    """
    lead = check_inputs("fused_mlp_ipe_apply", means, covs, v_enc)
    check_kernel_support(mlp, min_deg, max_deg, means.device)
    if means.device.type == "cpu":
        return fused_mlp_ipe_reference(mlp, means, covs, v_enc,
                                       min_deg=min_deg, max_deg=max_deg)
    lib = kernel_library()
    weights, biases = packed_for(mlp, packed, means.device, lib)
    mc, v = rows_of(means, covs, v_enc, lead)
    out = _FusedMlpIpe.apply(mc, v, weights, biases, (mlp, min_deg),
                             *[p for _, p in mlp.named_parameters()])
    return (out[:, :3].reshape(*lead, 3), out[:, 3:8].reshape(*lead, 5))


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
