"""Reference (PyTorch Lightning) MLP checkpoints as the port's parameters.

Counterpart of pano_nerf_tpu/utils/import_torch.py. All of the reference
implementation's trained state lives in its one shared MLP, held by the
LightningModule at `mip_nerf.mlp`, so a Lightning `.ckpt`'s `state_dict`
carries exactly these tensors:

    <prefix>layers.{i}.0.{weight,bias}         # the ReLU trunk
    <prefix>density_layer.{weight,bias}        # density / material head
    <prefix>extra_layer.{weight,bias}          # bottleneck before the view branch
    <prefix>view_layers.{i}.0.{weight,bias}    # view-conditioned branch
    <prefix>color_layer.{weight,bias}          # radiance head

The port's `NerfMLP` (models/mlp.py) keeps the reference's names and
[out, in] layout, so a conversion is a prefix strip plus a per-tensor
shape check against the target MLP: a topology mismatch fails with every
offending tensor listed, never half-imported. The entry point is
`python -m pano_nerf_tpu_torch.import_reference_ckpt`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from pano_nerf_tpu_torch.models.mlp import NerfMLP

Tensor = torch.Tensor


def find_mlp_prefix(state_dict: Mapping[str, object]) -> str:
    """Locate the MLP inside a state_dict by its first trunk layer: ''
    for a bare MLP state_dict, 'mlp.' for a model-level one,
    'mip_nerf.mlp.' for a Lightning checkpoint."""
    suffix = "layers.0.0.weight"
    prefixes = sorted(k[:-len(suffix)] for k in state_dict
                      if k.endswith(suffix) and "view_" not in k)
    if not prefixes:
        raise ValueError(
            "state_dict contains no '*layers.0.0.weight' key: not a "
            f"reference MLP checkpoint (got {len(state_dict)} keys, e.g. "
            f"{sorted(state_dict)[:3]})")
    if len(prefixes) > 1:
        raise ValueError(f"ambiguous MLP prefixes in state_dict: {prefixes}")
    return prefixes[0]


def convert_mlp_state_dict(state_dict: Mapping[str, object],
                           mlp: NerfMLP) -> Dict[str, Tensor]:
    """A reference state_dict (tensors or numpy arrays) -> `mlp`'s
    parameters by name, float32 on the CPU. `mlp` gives the names and
    shapes only; its values are not read. ValueError lists every missing
    tensor, every shape mismatch and every MLP tensor of the checkpoint
    that the target has no place for."""
    prefix = find_mlp_prefix(state_dict)
    out, problems = {}, []
    for name, param in mlp.named_parameters():
        key = prefix + name
        if key not in state_dict:
            problems.append(f"missing tensor {key!r}")
            continue
        val = torch.as_tensor(state_dict[key]).detach().cpu().float()
        if tuple(val.shape) != tuple(param.shape):
            problems.append(
                f"{key!r} -> {name}: shape {tuple(val.shape)} != expected "
                f"{tuple(param.shape)} (topology mismatch: check nerf.mlp.* "
                "and the heads against the reference run's config)")
            continue
        out[name] = val.clone()
    consumed = {prefix + n for n, _ in mlp.named_parameters()}
    extra = sorted(k for k in state_dict if k.startswith(prefix)
                   and k.endswith((".weight", ".bias")) and k not in consumed)
    if extra:
        problems.append(f"unconsumed reference MLP tensors: {extra} "
                        "(reference model deeper or wider than the target?)")
    if problems:
        raise ValueError("reference checkpoint does not match the target "
                         "model:\n  " + "\n  ".join(problems))
    return out


def export_mlp_state_dict(params: Mapping[str, Tensor],
                          prefix: str = "mip_nerf.mlp.") -> Dict[str, Tensor]:
    """Inverse of `convert_mlp_state_dict`: the MLP's parameters by name
    (an `illum.<leaf>` entry of the port's checkpoints is left out: the
    reference has no illuminant field) under the reference's prefix,
    float32. Round-trips exactly."""
    return {prefix + k: v.detach().cpu().float().clone()
            for k, v in params.items() if not k.startswith("illum.")}
