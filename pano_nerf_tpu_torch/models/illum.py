"""The illuminant field of Pano-NeRF (`nerf.illum_field`).

Counterpart of the JAX package's `BaseNeRF.init` illum subtree,
`BaseNeRF._illum_chroma` (pano_nerf_tpu/models/base.py:558-606) and
`PanoMipNeRF._apply_illum` (pano_nerf_tpu/models/pano_mip_nerf.py:
116-141). A two-hidden-layer float32 MLP on the positional encoding of
the (detached) surface point emits per-channel coefficients of a real-SH
basis; evaluated at the env directions and softmaxed over the channels,
they give a per-(point, direction) chroma that re-tints the secondary
read under a luma-preserving combine. The output layer starts at zero,
so a fresh field is the identity tint. It runs as plain torch: it is two
small matmuls per surface point, outside every kernel, as in JAX.

The parameters keep JAX's names and [in, out] layout (`w0, b0, w1, b1,
w_out, b_out`), so `utils/params.py` carries the `illum` subtree across
without a transpose.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pano_nerf_tpu_torch.ops import mip
from pano_nerf_tpu_torch.ops.shading import compute_illumination
from pano_nerf_tpu_torch.utils.spherical import sh_basis

Tensor = torch.Tensor

# Seed offset of the field's initializer from the model's (JAX folds 0x111
# into the model key).
SEED_OFFSET = 0x111


def _xavier(fan_in: int, fan_out: int,
            generator: Optional[torch.Generator]) -> nn.Parameter:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(fan_in, fan_out).uniform_(-bound, bound,
                                              generator=generator)
    return nn.Parameter(w)


class IllumField(nn.Module):
    """chroma = softmax_c(sum_k coeffs[c, k](x) Y_k(d)), coeffs from a
    2 x `width` ReLU MLP on pos_enc(x, 0..posenc_deg). `generator` is the
    model's: the field draws its init from a generator of its own,
    seeded from that one's seed + SEED_OFFSET, so the MLP's initial
    weights do not depend on whether the field is on."""

    def __init__(self, sh_deg: int = 2, width: int = 64,
                 posenc_deg: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is not None:
            generator = torch.Generator().manual_seed(
                generator.initial_seed() + SEED_OFFSET)
        self.sh_deg, self.posenc_deg = sh_deg, posenc_deg
        self.n_sh = (sh_deg + 1) ** 2
        in_dim = posenc_deg * 3 * 2 + 3
        self.w0 = _xavier(in_dim, width, generator)
        self.b0 = nn.Parameter(torch.zeros(width))
        self.w1 = _xavier(width, width, generator)
        self.b1 = nn.Parameter(torch.zeros(width))
        self.w_out = nn.Parameter(torch.zeros(width, 3 * self.n_sh))
        self.b_out = nn.Parameter(torch.zeros(3 * self.n_sh))

    def forward(self, surf_origins: Tensor, dirs: Tensor) -> Tensor:
        """Chroma simplex [B, D, 3] at surface points [B, 3] (detached:
        the field reads geometry, it does not steer it) and unit env
        directions [B, D, 3]."""
        x = surf_origins.detach().float()
        enc = mip.pos_enc(x, 0, self.posenc_deg, True)
        h = torch.relu(enc @ self.w0 + self.b0)
        h = torch.relu(h @ self.w1 + self.b1)
        coeffs = (h @ self.w_out + self.b_out).reshape(
            x.shape[:-1] + (3, self.n_sh))                   # [B, 3, K]
        basis = sh_basis(dirs.float(), self.sh_deg)          # [B, D, K]
        raw = torch.sum(coeffs[..., None, :, :] * basis[..., :, None, :],
                        dim=-1)                              # [B, D, 3]
        return torch.softmax(raw, dim=-1)


def apply_illum(env_rgb: Tensor, chroma: Tensor) -> Tensor:
    """The secondary read env_rgb [B, D, 3] tinted by 3 x chroma, then
    rescaled so its luma tracks the untinted read's (eps 0.01: near zero
    luma it degrades to the untinted read)."""
    tinted = env_rgb * (3.0 * chroma)
    c = 0.01
    return (tinted * (compute_illumination(env_rgb) + c)
            / (compute_illumination(tinted) + c))
