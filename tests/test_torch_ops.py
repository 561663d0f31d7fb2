"""The port's mip / shading / data / metric helpers against the JAX package.

Inputs are made with numpy from a seed and handed to both; float32 results
agree at atol 1e-5 / rtol 1e-5 (summation order and transcendental
implementations differ between the frameworks by a few ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.data import io_exr as jax_exr
from pano_nerf_tpu.data import pano_dataset as jax_data
from pano_nerf_tpu.ops import mip as jmip
from pano_nerf_tpu.ops import shading as jshade
from pano_nerf_tpu.utils import metrics as jmetrics
from pano_nerf_tpu_torch.data import io_exr as port_exr
from pano_nerf_tpu_torch.data import pano_dataset as port_data
from pano_nerf_tpu_torch.ops import mip as tmip
from pano_nerf_tpu_torch.ops import shading as tshade
from pano_nerf_tpu_torch.utils import metrics as tmetrics
from pano_nerf_tpu_torch.utils.vis import write_png
import torch_threads  # noqa: F401  (tests/torch_threads.py)

TOL = dict(atol=1e-5, rtol=1e-5)


def close(got, want, **kw):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(kw or TOL))


def T(x):
    return torch.tensor(np.asarray(x, np.float32))


@pytest.fixture()
def rays():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    o = rng.uniform(-0.5, 0.5, (16, 3)).astype(np.float32)
    return dict(o=o, d=d, radii=np.full((16, 1), 0.01, np.float32),
                near=np.full((16, 1), 0.1, np.float32),
                far=np.full((16, 1), 6.0, np.float32))


@pytest.mark.parametrize("disparity", [False, True])
def test_sample_along_rays(rays, disparity):
    t_j, (m_j, c_j) = jmip.sample_along_rays(
        None, rays["o"], rays["d"], rays["radii"], 8, rays["near"],
        rays["far"], False, disparity)
    t_t, (m_t, c_t) = tmip.sample_along_rays(
        T(rays["o"]), T(rays["d"]), T(rays["radii"]), 8, T(rays["near"]),
        T(rays["far"]), disparity)
    close(t_t, t_j)
    close(m_t, m_j)
    close(c_t, c_j)


def test_sample_env_rays(rays):
    env = jax_data.generate_lit_rays(num=4, far=10.0)
    t_j, (m_j, c_j), d_j = jmip.sample_env_rays(
        None, rays["o"], env.directions, 4, env.near, env.far, env.radii,
        False)
    t_t, (m_t, c_t), d_t = tmip.sample_env_rays(
        T(rays["o"]), T(env.directions), 4, T(env.near), T(env.far),
        T(env.radii))
    for g, w in ((t_t, t_j), (m_t, m_j), (c_t, c_j), (d_t, d_j)):
        close(g, w)


@pytest.mark.parametrize("num_samples", [None, 5])
def test_resample_along_rays(rays, num_samples):
    rng = np.random.default_rng(1)
    t, _ = jmip.sample_along_rays(None, rays["o"], rays["d"], rays["radii"],
                                  8, rays["near"], rays["far"], False)
    w = rng.uniform(0, 1, (16, 8)).astype(np.float32) ** 4
    w[3] = 0.0   # an empty ray exercises the padding branch
    t_j, (m_j, c_j) = jmip.resample_along_rays(
        None, rays["o"], rays["d"], rays["radii"], t, w, False, True, 0.01,
        num_samples=num_samples)
    t_t, (m_t, c_t) = tmip.resample_along_rays(
        T(rays["o"]), T(rays["d"]), T(rays["radii"]), T(t), T(w), 0.01,
        num_samples=num_samples)
    close(t_t, t_j)
    close(m_t, m_j, atol=1e-5, rtol=1e-4)
    close(c_t, c_j, atol=1e-5, rtol=1e-4)


def test_sorted_piecewise_constant_pdf():
    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(0, 5, (10, 9)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (10, 8)).astype(np.float32)
    close(tmip.sorted_piecewise_constant_pdf(T(bins), T(w), 12),
          jmip.sorted_piecewise_constant_pdf(None, bins, w, 12, False))


@pytest.mark.parametrize("repeats", [False, True])
def test_resample_gather_backward_sums_like_torch_gather(repeats):
    """The inverse CDF's gather, whose backward sums in a fixed order: its
    values and gradient against `torch.gather`'s (a scatter-add), bit for
    bit where no index repeats, within f32 rounding where many do (every
    sample of a bin, as in a peaked PDF), and a non-finite cotangent
    reaches only its own element."""
    rng = np.random.default_rng(6)
    x = T(rng.normal(size=(4, 3, 9)).astype(np.float32))
    if repeats:
        idx = np.sort(rng.integers(2, 5, (4, 3, 17)), -1)
    else:
        idx = np.stack([np.stack([rng.permutation(9)[:7] for _ in range(3)])
                        for _ in range(4)])
    idx = torch.from_numpy(idx)
    g = T(rng.normal(size=tuple(idx.shape)).astype(np.float32))
    got_x, want_x = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = tmip._GatherLast.apply(got_x, idx)
    want = want_x.gather(-1, idx)
    assert torch.equal(got, want)
    got.backward(g)
    want.backward(g)
    if repeats:
        close(got_x.grad, want_x.grad, atol=1e-6, rtol=1e-6)
    else:
        assert torch.equal(got_x.grad, want_x.grad)
    g[0, 0, 0] = float("inf")
    inf_x = x.clone().requires_grad_()
    tmip._GatherLast.apply(inf_x, idx).backward(g)
    bad = ~torch.isfinite(inf_x.grad)
    assert bad.sum() == 1 and bad[0, 0, idx[0, 0, 0]]


def test_integrated_pos_enc_and_pos_enc():
    rng = np.random.default_rng(3)
    means = rng.uniform(-3, 3, (6, 7, 3)).astype(np.float32)
    covs = rng.uniform(0, 1e-3, (6, 7, 3)).astype(np.float32)
    close(tmip.integrated_pos_enc(T(means), T(covs), 0, 16),
          jmip.integrated_pos_enc(means, covs, 0, 16))
    v = rng.normal(size=(6, 3)).astype(np.float32)
    for ident in (True, False):
        close(tmip.pos_enc(T(v), 0, 4, ident), jmip.pos_enc(v, 0, 4, ident))


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_volumetric_rendering(white_bkgd):
    rng = np.random.default_rng(4)
    rgb = rng.uniform(0, 2, (9, 8, 3)).astype(np.float32)
    density = rng.uniform(0, 3, (9, 8, 1)).astype(np.float32)
    t = np.sort(rng.uniform(0, 6, (9, 9)), -1).astype(np.float32)
    d = rng.normal(size=(9, 3)).astype(np.float32)
    got = tmip.volumetric_rendering(T(rgb), T(density), T(t), T(d),
                                    white_bkgd)
    want = jmip.volumetric_rendering(rgb, density, t, d, white_bkgd)
    for g, w in zip(got, want):
        close(g, w)


def test_conical_frustum_and_safe_normalize():
    rng = np.random.default_rng(5)
    d = rng.normal(size=(5, 3)).astype(np.float32)
    t0 = rng.uniform(0, 3, (5, 6)).astype(np.float32)
    t1 = t0 + rng.uniform(0.01, 0.5, (5, 6)).astype(np.float32)
    r = np.full((5, 1), 0.02, np.float32)
    for g, w in zip(tmip.conical_frustum_to_gaussian(T(d), T(t0), T(t1), T(r)),
                    jmip.conical_frustum_to_gaussian(d, t0, t1, r)):
        close(g, w)
    x = rng.normal(size=(7, 3)).astype(np.float32)
    x[2] = 0.0
    close(tmip.safe_normalize(T(x)), jmip.safe_normalize(x))


def test_shading():
    rng = np.random.default_rng(6)
    env = rng.uniform(0, 3, (8, 4, 3)).astype(np.float32)
    albedo = rng.uniform(0, 1, (8, 3)).astype(np.float32)
    normal = np.asarray(jmip.safe_normalize(
        rng.normal(size=(8, 3)).astype(np.float32)))
    lit = jax_data.generate_lit_rays(num=4)
    l = np.broadcast_to(lit.directions, (8, 4, 3)).astype(np.float32)
    v = rng.normal(size=(8, 3)).astype(np.float32)
    got = tshade.surface_rendering(T(env), T(albedo), T(normal), T(l),
                                   T(lit.lossmult))
    want = jshade.surface_rendering(env, albedo, normal, None, l, v,
                                    lit.lossmult)
    for g, w in zip(got, want):
        close(g, w)
    for g, w in zip(tshade.lambertian_brdf(T(albedo), T(normal), T(l)),
                    jshade.lambertian_brdf(albedo, normal, l)):
        close(g, w)
    close(tshade.compute_illumination(T(env)),
          jshade.compute_illumination(jnp.asarray(env)))
    np.testing.assert_array_equal(tshade.solid_angle_refinement(8, 16),
                                  jshade.solid_angle_refinement(8, 16))


@pytest.mark.parametrize("quantize", [False, True])
def test_hdr_to_ldr(quantize):
    hdr = np.random.default_rng(7).uniform(0, 8, (6, 5, 3)).astype(np.float32)
    want = np.asarray(jshade.hdr_to_ldr(hdr, quantize=quantize))
    close(tshade.hdr_to_ldr(hdr, quantize=quantize), want)
    close(tshade.hdr_to_ldr(T(hdr), quantize=quantize),
          jshade.hdr_to_ldr(jnp.asarray(hdr), quantize=quantize))


def test_equirect_geometry_and_env_rays():
    dirs_t, noise_t = port_data.equirect_camera_dirs(8, 16)
    dirs_j, noise_j = jax_data.equirect_camera_dirs(8, 16)
    np.testing.assert_array_equal(dirs_t, dirs_j)
    np.testing.assert_array_equal(noise_t, noise_j)
    np.testing.assert_array_equal(port_data.equirect_radii(dirs_t),
                                  jax_data.equirect_radii(dirs_j))
    for a, b in zip(port_data.generate_lit_rays(10, 0.0, 10.0, 0.02),
                    jax_data.generate_lit_rays(10, 0.0, 10.0, 0.02)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_data.bld_to_wd(),
                                  jax_data.bld_to_wd())
    img = np.random.default_rng(8).uniform(size=(8, 12, 3))
    np.testing.assert_array_equal(port_data._resize_area(img, 4),
                                  jax_data._resize_area(img, 4))


def test_metrics_match_jax():
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (16, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    tol = dict(rtol=1e-4, atol=1e-5)
    close(tmetrics.ws_psnr(a, b), jmetrics.ws_psnr(jnp.asarray(a),
                                                   jnp.asarray(b)), **tol)
    close(tmetrics.ssim(a, b), jmetrics.ssim(jnp.asarray(a), jnp.asarray(b)),
          **tol)
    close(tmetrics.ws_mae(a - 0.5, b - 0.5),
          jmetrics.ws_mae(jnp.asarray(a - 0.5), jnp.asarray(b - 0.5)),
          rtol=1e-4, atol=1e-3)
    close(tmetrics.scale_invariant_mse(a, b),
          jmetrics.scale_invariant_mse(jnp.asarray(a), jnp.asarray(b)), **tol)
    pd = rng.uniform(0.5, 5, (16, 32)).astype(np.float32)
    gd = rng.uniform(0.5, 5, (16, 32)).astype(np.float32)
    mask = np.ones_like(gd)
    want = jmetrics.depth_metrics(jnp.asarray(pd), jnp.asarray(gd),
                                  jnp.asarray(mask))
    got = tmetrics.depth_metrics(pd, gd, mask)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], **tol)


@pytest.mark.parametrize("pixel_type", ["half", "float"])
def test_exr_round_trips_across_packages(tmp_path, pixel_type):
    img = np.random.default_rng(10).uniform(0, 20, (19, 13, 3)).astype(
        np.float32)
    jax_exr.write_exr(str(tmp_path / "j.exr"), img, pixel_type=pixel_type)
    port_exr.write_exr(str(tmp_path / "t.exr"), img, pixel_type=pixel_type)
    assert (tmp_path / "j.exr").read_bytes() == (tmp_path / "t.exr").read_bytes()
    np.testing.assert_array_equal(port_exr.read_exr(str(tmp_path / "j.exr")),
                                  jax_exr.read_exr(str(tmp_path / "j.exr")))


def test_png_writer_decodes(tmp_path):
    from PIL import Image
    rgb = np.random.default_rng(11).integers(0, 256, (7, 9, 3), np.uint8)
    write_png(tmp_path / "x.png", rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png")),
                                  rgb)
