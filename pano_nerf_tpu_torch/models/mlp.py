"""The NeRF MLP as an `nn.Module`.

Counterpart of pano_nerf_tpu/models/mlp.py: an 8x256 ReLU trunk whose
input encoding is concatenated back after layer `skip_index` (layer 5 reads
[h4 | x]), a density head, a bottleneck ("extra") layer and a
view-conditioned branch ([bottleneck | viewdir encoding] -> 1x128 -> rgb).
Any depth, width, skip index and view-branch depth; without view
directions (`use_viewdirs=False`, JAX's `view_direction=None`) there is
no bottleneck and no view branch, and the color head reads the trunk.

Parameters use the reference's torch names and [out, in] layout
(`layers.{i}.0`, `density_layer`, `extra_layer`, `view_layers.{i}.0`,
`color_layer`), so `state_dict()` is the reference checkpoint's MLP and
`utils/params.py` bridges it to the JAX tree with a transpose.

`compute_dtype=torch.bfloat16` rounds every matmul operand (activations and
weights) to bf16 and accumulates in float32, adding the float32 bias after
the product: the arithmetic of a tensor-core product. Head outputs are
float32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor


def round_to(x: Tensor, dtype: torch.dtype) -> Tensor:
    """Round float32 values to `dtype` and back (a no-op for float32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def dense(h: Tensor, layer: nn.Linear, dtype: torch.dtype) -> Tensor:
    """h @ W^T + b with `dtype`-rounded operands and float32 accumulation."""
    return round_to(h, dtype) @ round_to(layer.weight, dtype).t() + layer.bias


def _linear(fan_in: int, fan_out: int, generator: Optional[torch.Generator]
            ) -> nn.Linear:
    """Linear layer with Xavier-uniform weights and zero bias."""
    layer = nn.Linear(fan_in, fan_out)
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.zero_()
    return layer


class NerfMLP(nn.Module):
    def __init__(self, xyz_dim: int, view_dim: int, net_depth: int = 8,
                 net_width: int = 256, net_depth_condition: int = 1,
                 net_width_condition: int = 128, skip_index: int = 4,
                 num_rgb_channels: int = 3, num_density_channels: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 use_viewdirs: bool = True):
        super().__init__()
        self.net_depth = net_depth
        self.net_width = net_width
        self.net_depth_condition = net_depth_condition
        self.net_width_condition = net_width_condition
        self.skip_index = skip_index
        self.num_rgb_channels = num_rgb_channels
        self.num_density_channels = num_density_channels
        self.xyz_dim = xyz_dim
        self.view_dim = view_dim
        self.compute_dtype = compute_dtype
        self.use_viewdirs = use_viewdirs

        layers, fan_in = [], xyz_dim
        for i in range(net_depth):
            layers.append(nn.Sequential(
                _linear(fan_in, net_width, generator), nn.ReLU()))
            fan_in = net_width + (xyz_dim if self._concat_after(i) else 0)
        self.layers = nn.ModuleList(layers)
        self.density_layer = _linear(fan_in, num_density_channels, generator)
        vin = fan_in
        if use_viewdirs:
            self.extra_layer = _linear(fan_in, net_width, generator)
            view_layers, vin = [], net_width + view_dim
            for _ in range(net_depth_condition):
                view_layers.append(nn.Sequential(
                    _linear(vin, net_width_condition, generator), nn.ReLU()))
                vin = net_width_condition
            self.view_layers = nn.ModuleList(view_layers)
        self.color_layer = _linear(vin, num_rgb_channels, generator)

    def _concat_after(self, i: int) -> bool:
        return i % self.skip_index == 0 and i > 0

    def trunk(self, x: Tensor) -> Tuple[Tensor, List[Tensor]]:
        """Trunk forward: (post-concat trunk output, [relu(z_i)] per layer)."""
        acts, h = [], x
        for i, seq in enumerate(self.layers):
            a = torch.relu(dense(h, seq[0], self.compute_dtype))
            acts.append(a)
            h = torch.cat([a, x], dim=-1) if self._concat_after(i) else a
        return h, acts

    def heads(self, trunk_out: Tensor, v_enc: Tensor) -> Tuple[Tensor, Tensor]:
        """(raw_rgb, raw_density) from the trunk output and viewdir code
        (ignored without view directions)."""
        dt = self.compute_dtype
        raw_density = dense(trunk_out, self.density_layer, dt)
        if not self.use_viewdirs:
            return dense(trunk_out, self.color_layer, dt), raw_density
        bottleneck = dense(trunk_out, self.extra_layer, dt)
        v = v_enc.expand(bottleneck.shape[:-1] + v_enc.shape[-1:])
        h = torch.cat([bottleneck, v], dim=-1)
        for seq in self.view_layers:
            h = torch.relu(dense(h, seq[0], dt))
        return dense(h, self.color_layer, dt), raw_density

    def forward(self, x: Tensor, v_enc: Tensor) -> Tuple[Tensor, Tensor]:
        """x: [..., xyz_dim] encoded samples; v_enc: [..., view_dim]
        encoded view directions broadcastable against x's leading dims.
        Returns raw_rgb [..., 3], raw_density [..., C], float32."""
        trunk_out, _ = self.trunk(x)
        return self.heads(trunk_out, v_enc)
