"""IPE + NerfMLP + density gradient on the H100, forward and backward
(kernel 3).

Replaces the TPU kernel `fused_mlp_normals_apply` of
pano_nerf_tpu/kernels/fused_mlp_normals.py:369 (`_sigma_grad_chain` :71,
`_fwd_kernel` :94, `_bwd_kernel` :132-277). The training fine level needs
per sample the MLP outputs and d raw_sigma / d means (the normal
direction). The forward computes the gradient as an explicit chain of
mask-gated products through the ReLU trunk, sz_i = m_i * s_i,
s_{i-1} = sz_i @ W_i, folded through the closed-form IPE Jacobian; the
backward is the hand-written adjoint of that chain plus the standard MLP
backward, so training stays first-order:

    cot_dy = q . sel_y,  cot_gx = cot_dy * att cos(y),  cot_c1 = cot_dy * g_x
    walk forward: c_i = m_i * (c_{i-1} @ W_i^T)   ([c_4 | cot_gx] into W5)
    dW_i += sz_i^T c_{i-1} (beside the standard dz_i^T a_{i-1})
    d Wd[sigma] += sum c_7
    cot_y = dx * c1 - cot_c1 * x,  cot_var = -(dx * x + cot_c1 * c1) / 2

What bounds it on an H100: tensor-core operations. Forward: 611,328 +
507,904 MACs per row; backward: the MLP's data and weight gradients
(2 x 611,328), the chain's recompute, walk and walk weight gradients
(3 x 507,904) and the heads' recompute (101,760). At batch 512 the fine
level is 28,672 rows: ~64 GFLOP forward, ~163 GFLOP backward.

Design (csrc/fused_mlp.cu, template NORMALS): as kernel 2, built for
each `MlpShape` a model asks for, C = 5 or C = 1 density channels among
them (the chain differentiates channel 0); the forward saves the 8 trunk
activations as bf16 [M, 8*W] when a gradient is
needed (as the TPU kernel's `save_residuals`, by TMA stores of the
activation tile), and the backward's row pass loads them back by TMA
(masks built from shared memory) and recomputes the sz-chain from their
ReLU masks instead of storing it. Its operand rows are 8,960 columns
(17.5 KB per row: 514 MB at 28,672 rows, >= 0.153 ms to write and as
much to read back); the weight-gradient pass sums both contributions of
each trunk weight in one accumulator.

`fused_mlp_normals_apply` is the wrapper (plain version for CPU tensors,
the CUDA kernels for CUDA tensors, or raise); its launches are counted in
`fused_mlp_normals_apply.launches` and `.backward_launches`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
from pano_nerf_tpu_torch.models import normals as normals_lib
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.ops import mip

Tensor = torch.Tensor


class _FusedMlpNormals(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mc, v, weights, biases, meta, *params):
        mlp, min_deg, save_acts = meta
        out, dsig, acts = k2.launch_forward(
            k2.kernel_library(k2.build_of(mlp)), mc, v, weights, biases,
            min_deg, normals=True, save_acts=save_acts)
        fused_mlp_normals_apply.launches += 1
        ctx.meta = meta
        if save_acts:
            ctx.save_for_backward(mc, v, weights, biases, acts)
        return out, dsig

    @staticmethod
    def backward(ctx, g, q):
        mlp, min_deg, save_acts = ctx.meta
        if not save_acts:
            raise RuntimeError("fused_mlp_normals ran without saving its "
                               "activations; it cannot be differentiated")
        mc, v, weights, biases, acts = ctx.saved_tensors
        M = mc.shape[0]
        g = mc.new_zeros(M, k2.OUT_W) if g is None else g.contiguous()
        q = mc.new_zeros(M, 3) if q is None else q.contiguous()
        dmc, grads = k2.run_backward(
            k2.kernel_library(k2.build_of(mlp)), fused_mlp_normals_apply,
            mlp, mc, v, weights, biases, g, q, acts, min_deg, normals=True)
        names = [n for n, _ in mlp.named_parameters()]
        return (dmc, None, None, None, None) + tuple(grads[n] for n in names)


def fused_mlp_normals_apply(mlp: NerfMLP, means: Tensor, covs: Tensor,
                            v_enc: Tensor, *, min_deg: int, max_deg: int,
                            packed: Optional[Tuple[Tensor, Tensor]] = None
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """IPE + NerfMLP + d raw_density[..., 0] / d means; differentiable
    (first order).

    Arguments as `fused_mlp_ipe.fused_mlp_ipe_apply`. Returns raw_rgb
    [..., 3], raw_density [..., C] (C = `mlp.num_density_channels`, 5 or
    1 on the card) and d_raw_sigma [..., 3] (of channel 0), float32.
    """
    lead = k2.check_inputs("fused_mlp_normals_apply", means, covs, v_enc,
                           mlp.view_dim)
    k2.check_kernel_support(mlp, min_deg, max_deg, means.device)
    if means.device.type == "cpu":
        return fused_mlp_normals_reference(mlp, means, covs, v_enc,
                                           min_deg=min_deg, max_deg=max_deg)
    C = mlp.num_density_channels
    lib = k2.kernel_library(k2.build_of(mlp))
    weights, biases = k2.packed_for(mlp, packed, means.device, lib)
    mc, v = k2.rows_of(means, covs, v_enc, lead)
    params = [p for _, p in mlp.named_parameters()]
    save_acts = torch.is_grad_enabled() and (
        mc.requires_grad or any(p.requires_grad for p in params))
    out, dsig = _FusedMlpNormals.apply(mc, v, weights, biases,
                                       (mlp, min_deg, save_acts), *params)
    return (out[:, :3].reshape(*lead, 3), out[:, 3:3 + C].reshape(*lead, C),
            dsig.reshape(*lead, 3))


fused_mlp_normals_apply.launches = 0
fused_mlp_normals_apply.backward_launches = 0


def fused_mlp_normals_reference(mlp: NerfMLP, means: Tensor, covs: Tensor,
                                v_enc: Tensor, *, min_deg: int, max_deg: int
                                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version: IPE -> the explicit chain of
    `models/normals.py` (`mlp_with_density_grad`, `density_means_grad`),
    differentiated by torch autograd."""
    x = mip.integrated_pos_enc(means, covs, min_deg, max_deg)
    raw_rgb, raw_density, g_enc = normals_lib.mlp_with_density_grad(
        mlp, x, v_enc)
    return (raw_rgb, raw_density,
            normals_lib.density_means_grad(g_enc, x, min_deg, max_deg))
