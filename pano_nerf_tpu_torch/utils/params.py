"""The weight bridge between the JAX parameter tree and the port's MLP.

The JAX package stores NerfMLP parameters as a flax tree
`{"params": {"trunk_0": {"kernel": [in, out], "bias": [out]}, ...}}`; the
port's NerfMLP uses the reference's torch names with [out, in] weights
(the same map as pano_nerf_tpu/utils/import_torch.py, copied here). A
conversion is therefore a rename plus a transpose, exact in both
directions.

On disk the tree is an `.npz` of flattened keys ("trunk_0/kernel", ...),
which a JAX user writes from a trained model with one line:

    np.savez("params.npz", **{f"{m}/{k}": np.asarray(v)
             for m, leaves in params["params"].items()
             for k, v in leaves.items()})
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_STATIC_MAP = {"density": "density_layer", "bottleneck": "extra_layer",
               "color": "color_layer"}
_LEAVES = (("kernel", "weight"), ("bias", "bias"))
# The illuminant field's subtree (`nerf.illum_field`), same name both sides.
ILLUM = "illum"


def _torch_name(flax_name: str) -> str:
    if flax_name in _STATIC_MAP:
        return _STATIC_MAP[flax_name]
    if flax_name.startswith("trunk_"):
        return f"layers.{int(flax_name[6:])}.0"
    if flax_name.startswith("view_"):
        return f"view_layers.{int(flax_name[5:])}.0"
    raise KeyError(f"no NerfMLP counterpart for flax module {flax_name!r}")


def _flax_name(torch_name: str) -> str:
    for flax, tname in _STATIC_MAP.items():
        if torch_name == tname:
            return flax
    kind, idx, _ = torch_name.split(".")
    return {"layers": "trunk", "view_layers": "view"}[kind] + f"_{int(idx)}"


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX tree ({"params": ...} or its inner dict, numpy-able leaves)
    -> NerfMLP state_dict of float32 tensors, plus the illuminant
    field's leaves as `illum.<leaf>` (JAX layout, no transpose) where the
    tree has the `illum` subtree (`NerfModel.load_params` takes both)."""
    inner = tree.get("params", tree)
    out = {}
    for flax_name, leaves in inner.items():
        if flax_name == ILLUM:
            out.update({f"{ILLUM}.{k}": torch.tensor(
                np.asarray(v, dtype=np.float32)) for k, v in leaves.items()})
            continue
        tname = _torch_name(flax_name)
        for jax_leaf, torch_leaf in _LEAVES:
            val = np.asarray(leaves[jax_leaf], dtype=np.float32)
            if jax_leaf == "kernel":
                val = val.T
            out[f"{tname}.{torch_leaf}"] = torch.tensor(val)
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of `params_from_jax`: state_dict (with or without
    `illum.<leaf>` entries) -> {"params": tree}."""
    inner: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in state_dict.items():
        tname, leaf = key.rsplit(".", 1)
        arr = val.detach().cpu().float().numpy()
        if tname == ILLUM:
            inner.setdefault(ILLUM, {})[leaf] = arr
            continue
        jax_leaf = "kernel" if leaf == "weight" else "bias"
        inner.setdefault(_flax_name(tname), {})[jax_leaf] = (
            np.ascontiguousarray(arr.T) if jax_leaf == "kernel" else arr)
    return {"params": inner}


def save_npz(path: str, tree: Mapping) -> None:
    """Write a JAX-layout tree as flattened "module/leaf" npz keys."""
    inner = tree.get("params", tree)
    np.savez(path, **{f"{m}/{k}": np.asarray(v)
                      for m, leaves in inner.items()
                      for k, v in leaves.items()})


def load_npz(path: str) -> Dict:
    """Read a flattened npz back into {"params": tree}."""
    inner: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as data:
        for key in data.files:
            module, leaf = key.split("/")
            inner.setdefault(module, {})[leaf] = data[key]
    return {"params": inner}
