"""The last refused model and system keys of the port against the JAX
package, on the CPU.

- `nerf.disable_integration`: covariances zeroed before every MLP query,
  on every route (JAX `_raw_outputs` :652, `_raw_outputs_density_grad`
  :737, `_point_normal` :798). JAX's kernel route on a TPU hands kernels
  4 and 5 the frustums' covariances all the same (its `_sample_level`
  does not zero them); the port follows JAX's documented semantics,
  which its CPU route computes, and is held to that here.
- `nerf.ray_shape`: JAX stores it and casts a cone whatever it says
  (ops/mip.py:85-102); the port accepts it and casts a cone.
- `train.randomized: false`: evenly placed samples, no resampling
  jitter, no density noise (so kernel 5 takes its levels again), the
  fixed env set, and none of the randomized products (distortion loss,
  view consistency, the distills).
- `val.randomized`: every eval chunk randomized by the same numbers
  (JAX renders each chunk with `PRNGKey(0)`), replayed here from JAX's
  key schedule and injected; through kernel 4 without density noise on
  the fixed env set, else through the standard route (JAX's gate).
- `nerf.mlp.num_rgb_channels` other than 3 stays refused: JAX's own
  train step and Pano-NeRF render raise on it.

f32 train steps at the tolerances of tests/test_torch_levels.py (loss
parts rel 1e-5 against JAX's forward, gradients rel-norm 1e-4 per leaf
or twice JAX's own change under 1e-6 ray shifts), renders at f32 atol
1e-4 (mip-NeRF's normal 1e-3), on the small model of
tests/test_torch_train_step.py (kernel 4's plain version at full width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.core.rays import Rays as JaxRays
from pano_nerf_tpu.engine import losses as jax_losses
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.core.rays import rays_to_tensors
from pano_nerf_tpu_torch.models.base import NerfConfig

from test_torch_env_modes import CONFIG, WIDE, systems
from test_torch_levels import (CPU, KEY5, check_pano_step, check_parts,
                               port_step, replay)
from test_torch_mip_nerf import _batch as mip_batch
from test_torch_mip_nerf import _systems as mip_systems
from test_torch_plain_route import check_render, check_step_f64
from test_torch_presets import _check_grads
from test_torch_train_step import B, D, _batch, _leaves, _rel
from pano_nerf_tpu_torch.utils.params import params_to_jax


def _pano_render(extra, draws_of=None):
    """The eval render of both Pano-NeRF systems with `extra` opts on
    the second test batch (the port given `draws_of(JAX model)` where
    set): (port products, JAX products, port system)."""
    jsys, params, psys = systems(extra)
    rays_np, _ = _batch(1)
    want = jsys.make_render_image(enable_surf=True)(params,
                                                    JaxRays(*rays_np))
    draws = None if draws_of is None else draws_of(jsys.model)
    got = psys.make_render_image(True, draws=draws)(
        None, rays_to_tensors(rays_np, CPU))
    return got, want, psys


def _close(got, want, normal_atol=1e-4):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]),
            atol=normal_atol if k == "normal" else 1e-4, err_msg=k)


NO_INT = ["nerf.disable_integration", "True"]
# Without integration every IPE degree reaches the MLP unattenuated: at
# degree 15 a phase is 2^15 x a coordinate, so the f32 rounding of a
# sample's position (the frameworks order their sums apart) moves the
# features, and the normals built from their derivatives, by percents in
# either framework (the test rays reach 10 units from the origin; at 10
# degrees the port's f32 render already moves 1e-3 from its f64 one).
# The port is held to JAX at 6 degrees on the plain route (with the
# float64 arbiter of tests/test_torch_plain_route.py, as its other
# encodings are); at the kernels' 16 its kernel route is held to its
# plain route, which places every sample bit for bit alike.
DEG6 = ["nerf.max_deg_point", "6"]


def test_disable_integration_render_and_step_match_jax():
    """The plain route with zero covariances at 6 degrees: the f32
    render (atol 1e-4) and one f32 step against JAX's."""
    check_render(NO_INT + DEG6)
    check_step_f64(NO_INT + DEG6)


def _zero_covs_seen(monkeypatch):
    """Count the largest covariance each kernel's plain version gets."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    from pano_nerf_tpu_torch.kernels import fused_render as k4
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    seen = {}
    for mod, name in ((k2, "fused_mlp_ipe_reference"),
                      (k3, "fused_mlp_normals_reference"),
                      (k4, "fused_render_level_reference"),
                      (k5, "fused_render_train_reference")):
        def wrap(plain, key=name):
            def fn(mlp, means, covs, *a, **k):
                seen[key] = max(seen.get(key, 0.0),
                                float(covs.abs().max()))
                return plain(mlp, means, covs, *a, **k)
            return fn
        monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    return seen


def test_disable_integration_kernel_route_is_the_plain_route(monkeypatch):
    """At the kernels' 16 degrees, key on: kernels 2, 3 and 5 (their
    plain versions) get zero covariances, and the step equals the plain
    route's (loss parts rel 1e-5, gradients rel-norm 1e-4 per leaf)."""
    seen = _zero_covs_seen(monkeypatch)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    runs = []
    for on_kernels in (True, False):
        jsys, _, psys = systems(NO_INT + KEY5, on_kernels=on_kernels)
        assert psys.model.kernels == on_kernels
        runs.append(port_step(psys, jsys.model, key))
    assert seen == {"fused_mlp_ipe_reference": 0.0,
                    "fused_mlp_normals_reference": 0.0,
                    "fused_render_train_reference": 0.0}
    (k_parts, k_grads), (p_parts, p_grads) = runs
    check_parts(k_parts, p_parts)
    for k in p_grads:
        assert _rel(k_grads[k], p_grads[k]) < 1e-4, k


def test_disable_integration_render_kernel_route_is_the_plain_route(
        monkeypatch):
    """Kernel 4 (its plain version) on zero covariances at every level
    renders what the plain route renders (f32 atol 1e-4)."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    seen = _zero_covs_seen(monkeypatch)
    rays = rays_to_tensors(_batch(1)[0], CPU)
    renders = [systems(NO_INT + WIDE, on_kernels=k)[2].make_render_image(
        True)(None, rays) for k in (True, False)]
    assert seen == {"fused_render_level_reference": 0.0}
    for k in renders[1]:
        np.testing.assert_allclose(renders[0][k].numpy(),
                                   renders[1][k].numpy(), atol=1e-4,
                                   err_msg=k)


def test_cylinder_is_cast_as_a_cone_as_in_jax(monkeypatch):
    """`nerf.ray_shape: cylinder` renders what `cone` renders, in JAX
    and in the port (mip-NeRF's eval, which reads no other switch)."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    renders = {}
    for shape in ("cone", "cylinder"):
        jsys, state, psys = mip_systems("f32",
                                        ["nerf.ray_shape", f"'{shape}'"])
        assert jsys.model.ray_shape == shape
        rays_np, _ = mip_batch(1)
        renders[shape] = (
            psys.make_render_image()(None, rays_to_tensors(rays_np, CPU)),
            jsys.make_render_image()(state.params, JaxRays(*rays_np)))
    (p_cone, j_cone), (p_cyl, j_cyl) = renders["cone"], renders["cylinder"]
    for k in j_cone:
        np.testing.assert_array_equal(np.asarray(j_cyl[k]),
                                      np.asarray(j_cone[k]), err_msg=k)
        assert torch.equal(p_cyl[k], p_cone[k]), k
    _close(p_cyl, j_cyl, normal_atol=1e-3)


DETERMINISTIC = ["train.randomized", "False", "nerf.density_noise", "1.0",
                 "nerf.env_sampling", "stratified",
                 "nerf.env_distill_samples", "4"] + KEY5


def test_deterministic_train_step_matches_jax(monkeypatch):
    """`train.randomized: false` with density noise, stratified env
    directions, an env distill and the key on: no draws at all, kernel 5
    back on the coarse level and the fixed env set (JAX's gate), and
    only the unrandomized loss terms."""
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    calls, plain = [], k5.fused_render_train_reference

    def counted(mlp, means, *a, **k):
        calls.append(tuple(means.shape))
        return plain(mlp, means, *a, **k)

    monkeypatch.setattr(k5, "fused_render_train_reference", counted)
    parts = check_pano_step(DETERMINISTIC)[0]
    assert calls == [(B, 8, 3), (B * D, 4, 3)]
    assert not {"dist", "vc", "env_distill"} & set(parts)


def test_deterministic_mip_step_matches_jax(monkeypatch):
    """mip-NeRF's step without randomness: no noise, even placement."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    extra = ["train.randomized", "False", "nerf.density_noise", "1.0",
             "loss.ort_loss", "0.1"]
    jsys, state, psys = mip_systems("f32", extra)
    assert not psys.train_randomized
    rays_np, rgbs_np = mip_batch()
    hp_j = jsys.hparams

    def loss_fn(p):
        outs = jsys.model(p, jax.random.PRNGKey(7), JaxRays(*rays_np),
                          randomized=False, white_bkgd=False,
                          use_ort_loss=True)
        parts = jax_losses.mipnerf_losses(
            outs, jnp.asarray(rgbs_np), jnp.asarray(rays_np.lossmult), hp_j)
        return parts["loss"], parts

    j_parts = jax.jit(loss_fn)(state.params)[1]
    j_grads = jax.jit(jax.grad(lambda p: loss_fn(p)[0]))(state.params)
    parts = psys.make_train_step(False)(
        psys.create_state(), rays_to_tensors(rays_np, CPU),
        torch.tensor(rgbs_np), None)
    check_parts(parts, j_parts)
    _check_grads(_leaves(params_to_jax(
        {n: p.grad for n, p in psys.model.mlp.named_parameters()})),
        _leaves(jax.tree.map(np.asarray, j_grads)))


def _eval_draws(model, chunk):
    return replay(model, jax.random.PRNGKey(0), batch=chunk,
                  eval_counts=True)


RANDOMIZED = {"kernel4": ["val.randomized", "True"] + WIDE,
              "standard": ["val.randomized", "True", "nerf.density_noise",
                           "1.0", "val.chunk_size", "8"]}


@pytest.mark.parametrize("route", sorted(RANDOMIZED))
def test_randomized_render_matches_jax(route, monkeypatch):
    """`val.randomized`: JAX's draws of `PRNGKey(0)` at the eval counts,
    the same for every chunk, injected: through kernel 4 (its plain
    version), or with density noise through the standard route (kernels
    2 and 3). Without injected draws the port draws them once from a
    generator seeded with 0: two renders agree."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    from pano_nerf_tpu_torch.kernels import fused_render as k4
    calls, plain = [], k4.fused_render_level_reference

    def counted(mlp, means, *a, **k):
        calls.append(tuple(means.shape))
        return plain(mlp, means, *a, **k)

    monkeypatch.setattr(k4, "fused_render_level_reference", counted)
    got, want, psys = _pano_render(RANDOMIZED[route],
                                   lambda m: _eval_draws(m, 8))
    _close(got, want)
    assert bool(calls) == (route == "kernel4")
    rays = rays_to_tensors(_batch(1)[0], CPU)
    render = psys.make_render_image(True)
    first, second = render(None, rays), render(None, rays)
    for k in first:
        assert torch.equal(first[k], second[k]), k
    assert not torch.equal(first["rgb_fine"], got["rgb_fine"])


def test_randomized_mip_render_matches_jax(monkeypatch):
    """mip-NeRF's randomized eval with density noise on both levels."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    jsys, state, psys = mip_systems(
        "f32", ["val.randomized", "True", "nerf.density_noise", "1.0"])
    rays_np, _ = mip_batch(1)
    want = jsys.make_render_image()(state.params, JaxRays(*rays_np))
    got = psys.make_render_image(draws=_eval_draws(jsys.model, 12))(
        None, rays_to_tensors(rays_np, CPU))
    _close(got, want, normal_atol=1e-3)


def test_rgb_channels_stay_refused_as_jax_cannot_run_them():
    """At 4 rgb channels JAX's Pano-NeRF step and render and its
    mip-NeRF step raise (3-channel albedo and irradiance in the surface
    render, ops/shading.py:127; 3-channel targets in the losses,
    engine/losses.py:71); the port refuses the key naming them."""
    rgb4 = ["nerf.mlp.num_rgb_channels", "4"]
    with pytest.raises(NotImplementedError, match=r"shading\.py:127"):
        NerfConfig.from_hparams(load_config(CONFIG, rgb4))
    from pano_nerf_tpu.core.config import load_config as jax_load_config
    from pano_nerf_tpu.data.pano_dataset import generate_lit_rays as jax_lit
    from pano_nerf_tpu.engine.system import MipNeRFSystem, PanoNeRFSystem
    from test_torch_env_modes import SMALL
    from test_torch_mip_nerf import CONFIG as MIP, OPTS as MIP_OPTS
    rays_np, rgbs_np = _batch()
    batch = (JaxRays(*rays_np), jnp.asarray(rgbs_np))
    for cls, config, opts in ((PanoNeRFSystem, CONFIG, SMALL),
                              (MipNeRFSystem, MIP, MIP_OPTS)):
        jsys = cls(jax_load_config(config, opts + rgb4))
        state = jsys.create_state(jax.random.PRNGKey(0))
        if cls is PanoNeRFSystem:
            jsys.set_env_rays(jax_lit(num=D, far=10.0))
            with pytest.raises(TypeError):
                jsys.make_render_image(True)(state.params, batch[0])
        with pytest.raises(TypeError):
            jsys.make_train_step(True)(state, batch, jax.random.PRNGKey(7))
