"""Explicit density-gradient chain: d raw_sigma / d means without autograd.

Counterpart of pano_nerf_tpu/models/normals.py. The ReLU trunk is
piecewise linear, so d raw_sigma / d encoding is a chain of mask-gated
matmuls over the forward activations, walked back from the density
kernel's sigma row. Through the IPE the chain is closed-form, with the
encoding laid out [sin block | cos block] (degree-major):

    d enc_sin[deg, d] / d mean_d =  2^deg * enc_cos[deg, d]
    d enc_cos[deg, d] / d mean_d = -2^deg * enc_sin[deg, d]

Rounding follows the fused render kernel: each masked cotangent is rounded
to the compute dtype before its matmul, products accumulate in float32.
This is the normal chain of the kernel's plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pano_nerf_tpu_torch.models.mlp import NerfMLP, round_to

Tensor = torch.Tensor


def mlp_with_density_grad(mlp: NerfMLP, x_enc: Tensor, v_enc: Tensor
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """NerfMLP forward plus d raw_density[..., 0] / d x_enc (float32).

    Returns raw_rgb [..., 3], raw_density [..., C], g_enc [..., F].
    """
    dt = mlp.compute_dtype
    trunk_out, acts = mlp.trunk(x_enc)
    raw_rgb, raw_density = mlp.heads(trunk_out, v_enc)
    width = mlp.net_width
    s = round_to(mlp.density_layer.weight[0], dt).expand(trunk_out.shape)
    g_enc = torch.zeros_like(x_enc)
    for i in range(mlp.net_depth - 1, -1, -1):
        if mlp._concat_after(i):
            g_enc = g_enc + s[..., width:]
            s = s[..., :width]
        sz = round_to(torch.where(acts[i] > 0, s, torch.zeros_like(s)), dt)
        s = sz @ round_to(mlp.layers[i][0].weight, dt)
    return raw_rgb, raw_density, g_enc + s


def density_means_grad(g_enc: Tensor, x_enc: Tensor, min_deg: int,
                       max_deg: int) -> Tensor:
    """Fold d raw_sigma / d enc through the IPE to d raw_sigma / d means."""
    L = max_deg - min_deg
    half = 3 * L
    enc_sin, enc_cos = x_enc[..., :half], x_enc[..., half:]
    combined = g_enc[..., :half] * enc_cos - g_enc[..., half:] * enc_sin
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=torch.float32,
                                 device=x_enc.device)
    weighted = combined.reshape(combined.shape[:-1] + (L, 3)) * scales[:, None]
    return torch.sum(weighted, dim=-2)
