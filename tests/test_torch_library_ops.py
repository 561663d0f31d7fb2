"""The port's 360 ops, extra shading functions, metrics family and
profiling against the JAX package, on the CPU.

Seeded numpy inputs go through JAX's function and the port's; f32
results agree at rtol 1e-5 (atol 1e-6 for entries near zero):

- `ops/mip.py`: `sample_along_rays_360` (JAX's stratification uniforms
  injected), `contract`, `integrated_pos_enc_360` and
  `volumetric_lighting_composing`;
- `ops/shading.py`: `microfacet_brdf`, `blinn_phong_brdf`,
  `surface_rendering_wlit`, `surface_rendering_hemi`, `wrap_sg_lit` and
  `surface_rendering_point_lit`;
- `utils/metrics.py`: mse, rmse, l1, psnr, mean_angular_error, ws_mse,
  ws_rmse, ws_l1, ws_cos_similarity, eval_errors and summarize_metrics;
- `utils/profiling.py`: `trace` writes a Chrome trace that holds the
  range `annotate` names.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.ops import mip as jax_mip
from pano_nerf_tpu.ops import shading as jax_shading
from pano_nerf_tpu.utils import metrics as jax_metrics
from pano_nerf_tpu_torch.ops import mip, shading
from pano_nerf_tpu_torch.utils import metrics, profiling

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, atol=ATOL):
    got = [got] if not isinstance(got, (tuple, list)) else got
    want = [want] if not isinstance(want, (tuple, list)) else want
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                                   atol=atol)


def rays(B=5, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    return dict(origins=rng.normal(size=(B, 3)).astype(np.float32) * 0.3,
                directions=d,
                radii=(np.abs(rng.normal(size=(B, 1))) * 0.01 + 1e-3
                       ).astype(np.float32),
                near=np.full((B, 1), 0.5, np.float32),
                far=np.full((B, 1), 6.0, np.float32))


@pytest.mark.parametrize("randomized", [False, True])
def test_sample_along_rays_360(randomized):
    r, N = rays(), 7
    key = jax.random.PRNGKey(3)
    t_inv, (means, covs) = jax_mip.sample_along_rays_360(
        key, *(jnp.asarray(r[k]) for k in ("origins", "directions",
                                           "radii")),
        N, jnp.asarray(r["near"]), jnp.asarray(r["far"]), randomized)
    u = (torch.tensor(np.asarray(jax.random.uniform(key, (5, N + 1))))
         if randomized else None)
    got = mip.sample_along_rays_360(
        *(torch.tensor(r[k]) for k in ("origins", "directions", "radii")),
        N, torch.tensor(r["near"]), torch.tensor(r["far"]), t_rand=u)
    assert got[1][1].shape == (5, N, 3, 3)
    close([got[0], *got[1]], [t_inv, means, covs])


def test_contract_and_ipe_360():
    r = rays(B=6, seed=1)
    r["far"] *= 4
    _, (means, covs) = jax_mip.sample_along_rays_360(
        None, *(jnp.asarray(r[k]) for k in ("origins", "directions",
                                           "radii")),
        9, jnp.asarray(r["near"]), jnp.asarray(r["far"]), False)
    means, covs = np.asarray(means), np.asarray(covs)
    assert (np.linalg.norm(means, axis=-1) > 1).any()
    assert (np.linalg.norm(means, axis=-1) < 1).any()
    far = means[np.linalg.norm(means, axis=-1) > 1]
    close(mip.contract(torch.tensor(far)), jax_mip.contract(jnp.asarray(far)))
    got = mip.integrated_pos_enc_360(torch.tensor(means), torch.tensor(covs))
    assert got.shape == (6, 9, 42)
    close(got, jax_mip.integrated_pos_enc_360(jnp.asarray(means),
                                              jnp.asarray(covs)))


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_volumetric_lighting_composing(white_bkgd):
    rng = np.random.default_rng(4)
    B, S = 4, 6
    rgb = rng.uniform(size=(B, S, 3)).astype(np.float32)
    density = rng.uniform(0, 3, size=(B, S, 1)).astype(np.float32)
    t = np.sort(rng.uniform(0.5, 5, size=(B, S + 1)), -1).astype(np.float32)
    dirs = rng.normal(size=(B, 3)).astype(np.float32)
    want = jax_mip.volumetric_lighting_composing(
        *(jnp.asarray(x) for x in (rgb, density, t, dirs)), white_bkgd)
    got = mip.volumetric_lighting_composing(
        *(torch.tensor(x) for x in (rgb, density, t, dirs)), white_bkgd)
    close(got, want)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def surf():
    rng = np.random.default_rng(5)
    B, D, K, N = 6, 10, 3, 4
    return dict(
        albedo=rng.uniform(size=(B, 3)).astype(np.float32),
        normal=_unit(rng.normal(size=(B, 3))),
        roughness=rng.uniform(0.1, 1, size=(B, 1)).astype(np.float32),
        l=_unit(rng.normal(size=(B, D, 3))),
        v=_unit(rng.normal(size=(B, 3))),
        env=rng.uniform(size=(B, K, D, 3)).astype(np.float32),
        env_weight=rng.uniform(size=(B, K)).astype(np.float32),
        solid_angle=rng.uniform(0.1, 1, size=(D, 1)).astype(np.float32),
        n_dot_l=rng.uniform(size=(D, 1)).astype(np.float32),
        lights=np.concatenate([
            rng.uniform(size=(N, 3)), _unit(rng.normal(size=(N, 3))),
            rng.uniform(1, 3, size=(N, 1)), rng.uniform(0.1, 1, size=(N, 1))],
            -1).astype(np.float32),
        position=rng.normal(size=(B, 3)).astype(np.float32))


def _both(surf, names):
    return ([jnp.asarray(surf[n]) for n in names],
            [torch.tensor(surf[n]) for n in names])


@pytest.mark.parametrize("name", ["microfacet_brdf", "blinn_phong_brdf"])
def test_brdfs(surf, name):
    j, t = _both(surf, ("albedo", "normal", "roughness", "l", "v"))
    close(getattr(shading, name)(*t), getattr(jax_shading, name)(*j))


def test_surface_rendering_variants(surf):
    j, t = _both(surf, ("env", "env_weight", "albedo", "normal", "l",
                        "solid_angle"))
    want = jax_shading.surface_rendering_wlit(*j[:4], None, j[4], None, j[5])
    close(shading.surface_rendering_wlit(*t), want)
    j, t = _both(surf, ("env", "env_weight", "albedo", "n_dot_l",
                        "solid_angle"))
    close(shading.surface_rendering_hemi(*t),
          jax_shading.surface_rendering_hemi(*j))
    j, t = _both(surf, ("lights", "position"))
    close(shading.wrap_sg_lit(*t), jax_shading.wrap_sg_lit(*j))
    j, t = _both(surf, ("lights", "albedo", "normal", "position"))
    close(shading.surface_rendering_point_lit(*t),
          jax_shading.surface_rendering_point_lit(*j))


def test_metrics_family():
    rng = np.random.default_rng(6)
    a = rng.uniform(size=(8, 16, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1).astype(np.float32)
    n1, n2 = rng.normal(size=(2, 8, 16, 3)).astype(np.float32)
    for name, x, y in (("mse", a, b), ("rmse", a, b), ("l1", a, b),
                       ("psnr", a, b), ("mean_angular_error", n1, n2),
                       ("ws_mse", a, b), ("ws_rmse", a, b), ("ws_l1", a, b),
                       ("ws_cos_similarity", n1, n2)):
        got = getattr(metrics, name)(x, y)
        assert isinstance(got, float), name
        close(got, getattr(jax_metrics, name)(jnp.asarray(x), jnp.asarray(y)))
    got = metrics.eval_errors(a, b)
    want = jax_metrics.eval_errors(jnp.asarray(a), jnp.asarray(b))
    assert set(got) == set(want) == {"psnr", "ssim"}
    close([got["psnr"], got["ssim"]], [want["psnr"], want["ssim"]])
    records = [dict(psnr=1.0, ssim=0.5, tag="x"), dict(psnr=3.0)]
    assert metrics.summarize_metrics(records) == \
        jax_metrics.summarize_metrics(records) == dict(psnr=2.0, ssim=0.5)


def test_trace_holds_the_annotated_range(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        with profiling.annotate("pano_range"):
            torch.ones(64).cumsum(0)
    assert prof is not None
    with open(tmp_path / "prof" / "trace.json") as fp:
        events = json.load(fp)["traceEvents"]
    assert any(e.get("name") == "pano_range" for e in events)
    with profiling.trace(None) as prof:
        assert prof is None
    assert not os.path.exists(tmp_path / "None")
