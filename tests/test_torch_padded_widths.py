"""Narrow MLPs in the kernels' builds, zero-padded, on the CPU.

The port's CUDA kernels are built at trunk 128 or 256 and view branch 64
or 128; a narrower model runs in the next build (`kernels/shapes.py`
`build_shape`), its weights zero-padded by `fused_render.pack_params`
block by block (the skip layer's [h4 | x] and the view layer's
[bottleneck | viewdir codes] split at the trunk width). A padded unit has
zero weights in and out and a zero bias, so the build computes the
narrow model exactly and its padded gradient slots are exactly zero.
Here, at P1 (trunk 64, view 32), P2 (200 / 100), 100 / 48 and mip-NeRF's
one density channel at 64 / 32:

- `pack_params` -> `unpack_params` round trips, padded slots zero;
- the packed layout read back as a NerfMLP at the build's width gives
  the narrow model's outputs, moment gradients, density gradients
  (normals) and parameter gradients (f32, atol 1e-5 on each tensor over
  max(1, its largest magnitude): the IPE's 2^15 frequencies put the
  covariance and density gradients near 1e4, whose f32 spacing is 1e-3),
  and exactly zero gradient in every padded slot
  (`fused_render.padded_slots`);
- the narrow model held to JAX's NerfMLP on the same numpy weights;
- `kernel_build_gaps` on the card: every trunk width 1..256 and view
  width 1..128 accepted, 1025 and 2048 trunks and 513 view branches
  (past the widest, 1,024 / 512, build) refused naming the key.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.models.mlp import NerfMLP as JaxMLP
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
from pano_nerf_tpu_torch.kernels import fused_render as fr
from pano_nerf_tpu_torch.kernels import shapes
from pano_nerf_tpu_torch.models import build_model
from pano_nerf_tpu_torch.models.base import kernel_build_gaps
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.utils.params import params_to_jax
import torch_threads  # noqa: F401  (tests/torch_threads.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")

# name -> (density channels, trunk, view branch)
WIDTHS = {"P1": (5, 64, 32), "P2": (5, 200, 100), "W100": (5, 100, 48),
          "C1": (1, 64, 32)}
ATOL = 1e-5


def assert_close(got, want):
    """|got - want| <= ATOL max(1, max |want|) (f32 sums of different
    lengths round apart at the values' own resolution)."""
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= ATOL * scale, (err, scale)


def narrow_mlp(name, seed=0):
    """An f32 NerfMLP of `WIDTHS[name]` (IPE degrees 0..16, deg-4 viewdir
    encoding with identity) whose weights are bf16 values, so that the
    bf16 packing keeps them exactly."""
    C, W, VW = WIDTHS[name]
    mlp = NerfMLP(96, 27, net_width=W, net_width_condition=VW,
                  num_density_channels=C, compute_dtype=torch.float32,
                  generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for n, p in mlp.named_parameters():
            if n.endswith("weight"):
                p.copy_(p.to(torch.bfloat16).float())
    return mlp


def build_mlp(mlp):
    """The packed layout of `mlp` read back as a NerfMLP at its build's
    widths (f32)."""
    b = shapes.build_of(mlp)
    wide = NerfMLP(mlp.xyz_dim, mlp.view_dim, net_width=b.W,
                   net_width_condition=b.VW,
                   num_density_channels=mlp.num_density_channels,
                   compute_dtype=torch.float32)
    weights, biases = fr.pack_params(mlp)
    wide.load_state_dict({k: v.clone() for k, v in fr.unpack_params(
        wide, weights.float(), biases).items()})
    return wide


def inputs(mlp, M=48, seed=1):
    rng = np.random.default_rng(seed)
    means = torch.tensor((rng.normal(size=(M, 3)) * 2).astype(np.float32),
                         requires_grad=True)
    covs = torch.tensor((np.abs(rng.normal(size=(M, 3))) * 0.01).astype(
        np.float32), requires_grad=True)
    v = torch.tensor((rng.normal(size=(M, mlp.view_dim)) * 0.5).astype(
        np.float32))
    return means, covs, v


def _loss(outs):
    loss = torch.sum(torch.sin(outs[0])) + torch.sum(torch.cos(outs[1]))
    if len(outs) == 3:
        loss = loss + torch.sum(torch.sin(0.1 * outs[2]))
    return loss


def run(fn, mlp, seed=1):
    """Outputs, moment gradients and parameter gradients (packed, f32) of
    the plain version `fn` on `mlp`."""
    means, covs, v = inputs(mlp, seed=seed)
    outs = fn(mlp, means, covs, v, min_deg=0, max_deg=16)
    _loss(outs).backward()
    grads = fr.pack_tensors(mlp, {n: p.grad
                                  for n, p in mlp.named_parameters()})
    return [o.detach() for o in outs], (means.grad, covs.grad), grads


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_pack_round_trip_pads_with_zeros(name):
    mlp = narrow_mlp(name)
    b = shapes.build_of(mlp)
    assert b == shapes.build_shape(shapes.shape_of(mlp))
    assert (b.W, b.VW) == ((256, 128) if name == "P2" else (128, 64))
    weights, biases = fr.pack_params(mlp)
    lay = k2.layout(b)
    assert weights.numel() == lay.W_TOTAL
    assert biases.numel() == 8 * b.W + 16 + b.W + b.VW + 16
    back = fr.unpack_params(mlp, weights.float(), biases)
    for n, p in mlp.named_parameters():
        assert torch.equal(back[n], p.detach()), n
    w_pad, b_pad = fr.padded_slots(mlp)
    assert torch.all(weights[w_pad] == 0) and torch.all(biases[b_pad] == 0)
    # Every slot is the model's or padding, none twice.
    assert int((~w_pad).sum()) == sum(
        p.numel() for n, p in mlp.named_parameters() if n.endswith("weight"))
    assert int((~b_pad).sum()) == sum(
        p.numel() for n, p in mlp.named_parameters() if n.endswith("bias"))


@pytest.mark.parametrize("normals", [False, True], ids=["k2", "k3"])
@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_build_width_computes_the_narrow_model(name, normals):
    """Kernels 2 and 3's plain versions on the padded build-width MLP
    against the narrow MLP: outputs, moment and density gradients and
    parameter gradients at `assert_close`; the padded slots' gradients
    exactly zero."""
    fn = (k3.fused_mlp_normals_reference if normals
          else k2.fused_mlp_ipe_reference)
    mlp = narrow_mlp(name)
    wide = build_mlp(mlp)
    outs, dm, g = run(fn, mlp)
    w_outs, w_dm, w_g = run(fn, wide)
    for a, b in zip(outs + list(dm), w_outs + list(w_dm)):
        assert_close(b, a)
    w_pad, b_pad = fr.padded_slots(mlp)
    for got, want, pad in zip(w_g, g, (w_pad, b_pad)):
        assert torch.count_nonzero(got[pad]) == 0
        assert_close(got[~pad], want[~pad])


@pytest.mark.parametrize("name", ["P1", "P2"])
def test_narrow_model_matches_jax(name):
    """The narrow NerfMLP (f32) against JAX's on the same numpy weights:
    raw rgb and density at atol 1e-5."""
    mlp = narrow_mlp(name)
    C, W, VW = WIDTHS[name]
    params = jax.tree.map(jnp.asarray, params_to_jax(dict(
        mlp.named_parameters())))
    jmlp = JaxMLP(net_width=W, net_width_condition=VW,
                  num_density_channels=C, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 7, 96)).astype(np.float32)
    v = rng.normal(size=(5, 1, 27)).astype(np.float32)
    want = jmlp.apply(params, jnp.asarray(x), jnp.asarray(v))
    with torch.no_grad():
        got = mlp(torch.tensor(x), torch.tensor(v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


@pytest.fixture(scope="module")
def cfg():
    return build_model(load_config(CONFIG)).cfg


def test_every_width_up_to_the_builds_runs_on_the_card(cfg):
    cuda = torch.device("cuda")
    for w in range(1, 257):
        c = dataclasses.replace(cfg, mlp_net_width=w)
        assert kernel_build_gaps(c, cuda) == [], w
        assert shapes.build_shape(shapes.MlpShape(W=w)).W == (
            128 if w <= 128 else 256)
    for vw in range(1, 129):
        c = dataclasses.replace(cfg, mlp_net_width_condition=vw)
        assert kernel_build_gaps(c, cuda) == [], vw
        assert shapes.build_shape(shapes.MlpShape(VW=vw)).VW == (
            64 if vw <= 64 else 128)


@pytest.mark.parametrize("key,value", [
    ("mlp_net_width", 1025), ("mlp_net_width", 2048),
    ("mlp_net_width_condition", 513)])
def test_widths_past_the_builds_are_refused_naming_the_key(cfg, key, value):
    c = dataclasses.replace(cfg, **{key: value})
    name = {"mlp_net_width": "nerf.mlp.net_width",
            "mlp_net_width_condition": "nerf.mlp.net_width_condition"}[key]
    assert kernel_build_gaps(c, torch.device("cuda")) == [f"{name} {value}"]
    assert kernel_build_gaps(c, torch.device("cpu")) == []
    field = "W" if key == "mlp_net_width" else "VW"
    with pytest.raises(ValueError, match="no kernel build"):
        shapes.build_shape(shapes.MlpShape(**{field: value}))
