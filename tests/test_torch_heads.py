"""Pano-NeRF's emissive and chroma heads of the port against the JAX
package, on the CPU.

`nerf.emissive_head` appends 3 self-emission channels to the density head
(softplus with `nerf.emission_bias`), added to the radiance of every
query, composited into the `emission` product and the surface render and
held sparse by `loss.emission_sparsity`; `nerf.chroma_head` appends 3
chroma channels after them (a softmax simplex that multiplies 3
softplus(mean raw_rgb)). JAX sends either head to XLA, the port to the
plain route (tests/test_torch_plain_route.py). Each head alone and both:
the render (f32 atol 1e-4, the `emission` product among the products)
and one f32 train step (loss parts rel 1e-5, gradients rel-norm 1e-4 per
leaf); the emissive head's normals from the explicit chain, which JAX
requires of it; the parameters JAX -> port -> JAX bit for bit at 8 and 11 density
channels.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pano_nerf_tpu.core.rays import Rays as JaxRays
from pano_nerf_tpu_torch.core.rays import rays_to_tensors
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax

from test_torch_env_modes import systems
from test_torch_plain_route import check_render, check_step_f64
from test_torch_train_step import _batch, _leaves
import torch_threads  # noqa: F401  (tests/torch_threads.py)

HEADS = {"emissive": ["nerf.emissive_head", "True"],
         "chroma": ["nerf.chroma_head", "True"],
         "both": ["nerf.emissive_head", "True", "nerf.chroma_head", "True"]}


@pytest.mark.parametrize("heads", list(HEADS))
def test_render_matches_jax(heads):
    got, want = check_render(HEADS[heads])
    assert ("emission" in got) == (heads != "chroma")


@pytest.mark.parametrize("heads", list(HEADS))
def test_train_step_matches_jax_in_f32(heads):
    emissive = heads != "chroma"
    parts = check_step_f64(HEADS[heads],
                           names=("emission",) if emissive else ())
    if emissive:
        assert float(parts["emission"]) > 0


def test_emissive_head_normals_come_from_the_explicit_chain(monkeypatch):
    """JAX raises at its vjp-normals fine level (pano_mip_nerf.py:392-396)
    and takes the emissive head with explicit normals only; the port has
    no other normals (no `normals_impl`), so its emissive step computes
    the fine level's normals by the explicit chain, once per step."""
    from pano_nerf_tpu_torch.models import normals
    jsys, params, psys = systems(HEADS["emissive"])
    rays_np, rgbs_np = _batch()
    vjp = dataclasses.replace(jsys.model, normals_impl="vjp")
    with pytest.raises(NotImplementedError, match="emissive_head requires"):
        vjp(params, jax.random.PRNGKey(0), JaxRays(*rays_np), jsys.env_rays,
            randomized=True, white_bkgd=False, enable_surf=True,
            use_ort_loss=True)
    assert not hasattr(psys.model.cfg, "normals_impl")
    calls = []
    chain = normals.mlp_with_density_grad

    def counted(*a, **k):
        calls.append(1)
        return chain(*a, **k)

    monkeypatch.setattr(normals, "mlp_with_density_grad", counted)
    parts = psys.make_train_step(True)(
        psys.create_state(), rays_to_tensors(rays_np, torch.device("cpu")),
        torch.tensor(rgbs_np), psys.make_draws(len(rgbs_np),
                                               torch.Generator()))
    assert len(calls) == 1 and float(parts["ort"]) > 0


@pytest.mark.parametrize("heads,channels", [("emissive", 8), ("both", 11)])
def test_parameters_round_trip_jax_port_jax(heads, channels):
    jsys, params, psys = systems(HEADS[heads])
    want = _leaves(params)
    assert want["density/kernel"].shape == (64, channels)
    assert tuple(psys.model.mlp.density_layer.weight.shape) == (channels, 64)
    psys.model.load_params(params_from_jax(params))
    back = _leaves(params_to_jax(psys.model.param_state()))
    assert want.keys() == back.keys()
    for k in want:
        assert back[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    torch.testing.assert_close(psys.model.mlp.density_layer.weight,
                               torch.tensor(want["density/kernel"].T),
                               rtol=0, atol=0)
