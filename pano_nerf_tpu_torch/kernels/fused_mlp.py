"""NerfMLP on encoded rows on the H100, forward and backward (kernel 1).

Replaces the TPU kernel `fused_mlp_apply` of
pano_nerf_tpu/kernels/fused_mlp.py:363 (`_fwd_kernel` :198, `_bwd_kernel`
:238, custom VJP :343-360). One call evaluates the trunk, the density head,
the bottleneck and the view branch on rows of already-encoded features:
x [M, 6 L] (IPE) and the viewdir encoding [M, VF] (96 and 27 for the
shipped 8x256 / 1x128 model; the CUDA library is built per
`fused_mlp_ipe.MlpShape`). The backward
returns the gradient of x and of every weight and bias; the viewdir
encoding gets none. No model path calls it; it is a library function, as
in the JAX package.

What bounds it on an H100: tensor-core operations, as kernel 2 without the
IPE: 611,328 MACs per row forward and 3 x 611,328 backward (recompute,
data and weight gradients), against 192 B of bf16 inputs per row.

Design (csrc/fused_mlp.cu, template variant ENCODED): the row kernels of
kernel 2 with the IPE replaced by a load of the bf16 features (padded
with zeros to XF columns); the backward row pass writes d x (f32)
instead of d moments and the same operand rows, which kernel 2's
weight-gradient pass reduces.

`fused_mlp_apply` is the wrapper: the plain version
`fused_mlp_apply_reference` (NerfMLP on the encoded rows, torch autograd)
for CPU tensors, the CUDA kernels for CUDA tensors, or raise. Its launches
are counted in `fused_mlp_apply.launches` and `.backward_launches` (row
pass and weight-gradient pass, two per backward).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
from pano_nerf_tpu_torch.models.mlp import NerfMLP

Tensor = torch.Tensor


def check_kernel_support(mlp: NerfMLP, device: torch.device) -> None:
    """Raise ValueError unless the kernels cover `mlp` on `device`: kernel
    2's topology and shapes (`fused_mlp_ipe.shape_gaps`, at the IPE
    degrees of its 6 L input features); on the card the 5 density
    channels of the build's output too."""
    want, bad = k2.shape_gaps(mlp, 0, mlp.xyz_dim // 6, device)
    if device.type == "cuda" and mlp.num_density_channels != 5:
        want["num_density_channels"] = (5,)
        bad["num_density_channels"] = mlp.num_density_channels
    if bad:
        raise ValueError(f"fused_mlp_apply supports only the topology "
                         f"and shapes {want}; got {bad}")


def _check_inputs(x_enc: Tensor, v_enc: Tensor, xyz_dim: int,
                  view_dim: int) -> Tuple[int, ...]:
    """Validate [..., xyz_dim] features and a [..., view_dim] viewdir
    encoding of the same rank whose leading dims broadcast against x's;
    returns them."""
    if x_enc.ndim < 2 or x_enc.shape[-1] != xyz_dim:
        raise ValueError(f"fused_mlp_apply: x_enc must be [..., {xyz_dim}], "
                         f"got {tuple(x_enc.shape)}")
    lead = tuple(x_enc.shape[:-1])
    if v_enc.ndim != x_enc.ndim or v_enc.shape[-1] != view_dim or any(
            a not in (1, b) for a, b in zip(v_enc.shape[:-1], lead)):
        raise ValueError(f"fused_mlp_apply: v_enc must be [..., {view_dim}] "
                         f"broadcastable to {lead}, got {tuple(v_enc.shape)}")
    for name, t in (("x_enc", x_enc), ("v_enc", v_enc)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mlp_apply: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_mlp_apply: {name} must be contiguous")
        if t.device != x_enc.device:
            raise ValueError(f"fused_mlp_apply: {name} is on {t.device}, "
                             f"x_enc on {x_enc.device}")
    if x_enc.numel() == 0:
        raise ValueError("fused_mlp_apply: needs at least one row")
    if x_enc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp_apply runs on cpu or cuda tensors, got "
                         f"{x_enc.device}")
    return lead


def launch_forward(xb: Tensor, v: Tensor, weights: Tensor, biases: Tensor,
                   shape: k2.MlpShape = k2.STANDARD) -> Tensor:
    """One forward launch on bf16 features xb [M, XF] and viewdir rows v
    [M, VP] of `shape`; returns the output slab [M, 16]. Not counted."""
    lib = k2.kernel_library(shape)
    out = torch.empty((xb.shape[0], k2.OUT_W), dtype=torch.float32,
                      device=xb.device)
    k2.check_launch(lib, "fused_mlp forward", lib.fused_mlp_encoded_forward(
        xb.data_ptr(), v.data_ptr(), weights.data_ptr(), biases.data_ptr(),
        out.data_ptr(), xb.shape[0],
        torch.cuda.current_stream(xb.device).cuda_stream))
    return out


def run_backward(counter, mlp: NerfMLP, xb: Tensor, v: Tensor,
                 weights: Tensor, biases: Tensor, g: Tensor
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Backward row pass + weight-gradient pass, both counted on `counter`;
    returns (d x [M, XF] f32, {parameter name: gradient})."""
    shape = k2.build_of(mlp)
    lib = k2.kernel_library(shape)
    M = xb.shape[0]
    ops, dw, db = k2.backward_buffers(lib, weights, biases,
                                      k2.tile_rows(lib, M), False)
    dx = torch.empty((M, shape.XF), dtype=torch.float32, device=xb.device)
    launch_backward_rows(xb, v, weights, biases, g, ops, dx, db, shape)
    counter.backward_launches += 1
    return dx, k2.weight_grads(lib, counter, mlp, ops, dw, db)


def launch_backward_rows(xb: Tensor, v: Tensor, weights: Tensor,
                         biases: Tensor, g: Tensor, ops: Tensor, dx: Tensor,
                         db: Tensor, shape: k2.MlpShape = k2.STANDARD
                         ) -> None:
    """One launch of the backward row pass of `shape`'s library: writes d
    x, the operand rows `ops` and the bias gradients into db. Not
    counted."""
    lib = k2.kernel_library(shape)
    part, count = k2.bias_workspace(
        lib.fused_mlp_bias_workspace,
        k2.tile_rows(lib, xb.shape[0]) // lib.fused_mlp_tile_rows(),
        xb.device)
    k2.check_launch(lib, "fused_mlp backward",
                    lib.fused_mlp_encoded_backward_rows(
                        xb.data_ptr(), v.data_ptr(), weights.data_ptr(),
                        biases.data_ptr(), g.data_ptr(), ops.data_ptr(),
                        dx.data_ptr(), db.data_ptr(), part.data_ptr(),
                        count.data_ptr(), xb.shape[0],
                        torch.cuda.current_stream(xb.device).cuda_stream))


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, v, weights, biases, mlp, *params):
        shape = k2.build_of(mlp)
        xb = F.pad(x.detach(), (0, shape.XF - x.shape[-1])).to(
            torch.bfloat16).contiguous()
        out = launch_forward(xb, v, weights, biases, shape)
        fused_mlp_apply.launches += 1
        ctx.mlp = mlp
        ctx.save_for_backward(xb, v, weights, biases)
        return out

    @staticmethod
    def backward(ctx, g):
        xb, v, weights, biases = ctx.saved_tensors
        dx, grads = run_backward(fused_mlp_apply, ctx.mlp, xb, v, weights,
                                 biases, g.contiguous())
        names = [n for n, _ in ctx.mlp.named_parameters()]
        return ((dx[:, :ctx.mlp.xyz_dim], None, None, None, None)
                + tuple(grads[n] for n in names))


def fused_mlp_apply(mlp: NerfMLP, x_enc: Tensor, v_enc: Tensor, *,
                    packed: Optional[Tuple[Tensor, Tensor]] = None
                    ) -> Tuple[Tensor, Tensor]:
    """NerfMLP on encoded rows; differentiable (first order).

    x_enc: [..., mlp.xyz_dim] float32 IPE features; v_enc: [...,
    mlp.view_dim] float32 viewdir encoding of the same rank, broadcastable
    to x's leading dims. `packed` is `fused_render.pack_params(mlp)`,
    computed here when not given. Returns raw_rgb [..., 3] and
    raw_density [..., C], float32 (the kernels take C = 5).
    """
    lead = _check_inputs(x_enc, v_enc, mlp.xyz_dim, mlp.view_dim)
    check_kernel_support(mlp, x_enc.device)
    if x_enc.device.type == "cpu":
        return fused_mlp_apply_reference(mlp, x_enc, v_enc)
    lib = k2.kernel_library(k2.build_of(mlp))
    weights, biases = k2.packed_for(mlp, packed, x_enc.device, lib)
    v = k2.viewdir_rows(v_enc, lead)
    out = _FusedMlp.apply(x_enc.reshape(-1, mlp.xyz_dim), v, weights,
                          biases, mlp, *[p for _, p in mlp.named_parameters()])
    return (out[:, :3].reshape(*lead, 3), out[:, 3:8].reshape(*lead, 5))


fused_mlp_apply.launches = 0
fused_mlp_apply.backward_launches = 0


def fused_mlp_apply_reference(mlp: NerfMLP, x_enc: Tensor, v_enc: Tensor
                              ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version: NerfMLP on the encoded rows, differentiated
    by torch autograd (matmul operands rounded to the compute dtype, f32
    accumulation, as in the kernel)."""
    return mlp(x_enc, v_enc)
