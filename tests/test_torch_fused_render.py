"""The fused render kernel's plain version against the JAX Pallas kernel.

`fused_render_level_reference` (what the port's wrapper runs on CPU
tensors) is held against `pano_nerf_tpu.kernels.fused_render.
fused_render_level` run in Pallas interpret mode, on the same bridged
parameters and the same numpy-made inputs, at the kernel-vs-plain
tolerances of tests/test_fused_render.py. The CUDA kernel itself is held
against the plain version in tests/test_torch_cuda.py (on the card) and by
`chip_smoke.py` at the main path's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.core.rays import Rays as JaxRays
from pano_nerf_tpu.kernels.fused_render import (
    fused_render_level as jax_fused_render_level)
from pano_nerf_tpu.models.pano_mip_nerf import PanoMipNeRF as JaxPanoMipNeRF
from pano_nerf_tpu_torch.kernels import fused_render as fr
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.utils.params import params_from_jax

KW = dict(min_deg=0, max_deg=16, deg_view=4, density_bias=-1.0,
          rgb_padding=0.0)


@pytest.fixture(scope="module")
def setup():
    model = JaxPanoMipNeRF(num_samples=8, num_env_samples=4,
                           compute_dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    mlp = NerfMLP(96, 27, num_density_channels=5,
                  compute_dtype=torch.bfloat16)
    mlp.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(5)
    d = rng.normal(size=(12, 3)).astype(np.float32)
    n = np.ones((12, 1), np.float32)
    rays = JaxRays(origins=np.zeros((12, 3), np.float32), directions=d,
                   viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
                   radii=n * 0.01, lossmult=n, near=n * 0.0, far=n * 10.0,
                   noise_var=n * 0.0)
    t, (m, c) = model._sample_level(jax.random.PRNGKey(0), rays, 0, None,
                                    None, False)
    inputs = [np.asarray(a, np.float32) for a in
              (m, c, rays.viewdirs, t, rays.directions)]
    return params, mlp, inputs


@pytest.mark.parametrize("need_normals", [False, True])
def test_plain_version_matches_pallas_kernel(monkeypatch, setup,
                                             need_normals):
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")
    params, mlp, inputs = setup
    want = jax_fused_render_level(
        params, *inputs, 5, 0, 16, 4, -1.0, 0.0, False, need_normals,
        need_normals)
    with torch.no_grad():
        got = fr.fused_render_level(
            mlp, *(torch.tensor(a) for a in inputs), white_bkgd=False,
            need_normals=need_normals, need_extras=need_normals, **KW)
    want = {k: None if v is None else np.asarray(v) for k, v in want.items()}
    np.testing.assert_allclose(got["rgb"].numpy(), want["rgb"], atol=2e-2)
    np.testing.assert_allclose(got["distance"].numpy(), want["distance"],
                               atol=2e-2)
    np.testing.assert_allclose(got["acc"].numpy(), want["acc"], atol=1e-2)
    np.testing.assert_allclose(got["weights"].numpy(), want["weights"],
                               atol=1e-2)
    if not need_normals:
        assert got["normal"] is None and got["albedo"] is None
        return
    cos = np.sum(got["normal"].numpy() * want["normal"], -1)
    assert np.median(cos) > 0.998, np.median(cos)
    assert np.all(cos > 0.85), cos.min()
    np.testing.assert_allclose(got["albedo"].numpy(), want["albedo"],
                               atol=2e-2)
    np.testing.assert_allclose(got["roughness"].numpy(), want["roughness"],
                               atol=2e-2)
    np.testing.assert_allclose(got["ort"].numpy(), want["ort"], atol=2e-2)


def _inputs(R=4, S=8):
    g = torch.Generator().manual_seed(0)
    t = torch.sort(torch.rand(R, S + 1, generator=g) * 5, -1).values
    d = torch.randn(R, 3, generator=g)
    return [torch.randn(R, S, 3, generator=g),
            torch.rand(R, S, 3, generator=g) * 1e-3,
            d / torch.linalg.norm(d, dim=-1, keepdim=True), t, d]


def _call(mlp, args, **kw):
    return fr.fused_render_level(mlp, *args, white_bkgd=False,
                                 need_normals=True, need_extras=True,
                                 **{**KW, **kw})


@pytest.fixture(scope="module")
def mlp256():
    return NerfMLP(96, 27, num_density_channels=5,
                   generator=torch.Generator().manual_seed(1))


def test_wrapper_rejects_non_contiguous_input(mlp256):
    args = _inputs()
    args[0] = torch.randn(3, 4, 8).permute(1, 2, 0)
    with pytest.raises(ValueError, match="contiguous"):
        _call(mlp256, args)


def test_wrapper_rejects_wrong_dtype(mlp256):
    args = _inputs()
    args[1] = args[1].double()
    with pytest.raises(TypeError, match="float32"):
        _call(mlp256, args)


@pytest.mark.parametrize("S", [65, 80])
def test_wrapper_rejects_unsupported_sample_count(mlp256, S):
    with pytest.raises(ValueError, match="samples"):
        _call(mlp256, _inputs(S=S))


@pytest.mark.parametrize("change", [
    dict(net_width=640), dict(skip_index=3), dict(num_density_channels=8),
    dict(net_width_condition=320)])
def test_wrapper_rejects_unsupported_topology(change):
    """A topology kernel 4 does not take is refused on every device; a
    width no CUDA build takes (trunk above 512, view branch above 256) on
    the card only: the plain version on the CPU takes any width, and a
    narrower one runs padded in the next build."""
    mlp = NerfMLP(96, 27, **{"num_density_channels": 5, **change})
    cuda = torch.device("cuda")
    if "net_width" in change or "net_width_condition" in change:
        _call(mlp, _inputs())
        with pytest.raises(ValueError, match="topology"):
            fr.check_kernel_support(mlp, 8, 0, 16, 4, cuda)
        narrow = {k: v // 5 for k, v in change.items()}
        fr.check_kernel_support(NerfMLP(96, 27, num_density_channels=5,
                                        **narrow), 8, 0, 16, 4, cuda)
    else:
        with pytest.raises(ValueError, match="topology"):
            _call(mlp, _inputs())


def test_wrapper_rejects_unsupported_encoding_degrees(mlp256):
    """deg_view 2 for an MLP of the deg-4 encoding (27 wide) is refused;
    deg_view 5, beyond the builds' 1..4, on the card only (the plain
    version on the CPU takes it, as JAX's kernel does)."""
    with pytest.raises(ValueError, match="topology"):
        _call(mlp256, _inputs(), deg_view=2)
    mlp5 = NerfMLP(96, 33, num_density_channels=5)
    with pytest.raises(ValueError, match="topology"):
        fr.check_kernel_support(mlp5, 8, 0, 16, 5, torch.device("cuda"))
    assert _call(mlp5, _inputs(), deg_view=5)["rgb"].shape == (4, 3)


def test_wrapper_rejects_shape_mismatch(mlp256):
    args = _inputs()
    args[3] = args[3][:, :-1].contiguous()
    with pytest.raises(ValueError, match="t_samples"):
        _call(mlp256, args)


def test_wrapper_rejects_an_empty_batch_naming_the_kernel(mlp256):
    with pytest.raises(ValueError,
                       match="fused_render_level needs at least one ray"):
        _call(mlp256, _inputs(R=0))


def test_cpu_tensors_take_the_plain_version_without_launching(mlp256):
    before = fr.fused_render_level.launches
    with torch.no_grad():
        out = _call(mlp256, _inputs())
    assert fr.fused_render_level.launches == before
    assert out["rgb"].shape == (4, 3) and out["weights"].shape == (4, 8)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_pack_params_layout(mlp256):
    w, b = fr.pack_params(mlp256)
    assert w.dtype == torch.bfloat16 and w.shape == (616_448,)
    assert b.dtype == torch.float32 and b.shape == (2_464,)
    off_wd = 256 * 96 + 4 * 256 * 256 + 256 * 352 + 2 * 256 * 256
    wd = w[off_wd:off_wd + 16 * 256].reshape(16, 256)
    assert torch.equal(wd[:5], mlp256.density_layer.weight.bfloat16())
    assert not wd[5:].any()
    off_wv = off_wd + 16 * 256 + 256 * 256
    wv = w[off_wv:off_wv + 128 * 288].reshape(128, 288)
    assert torch.equal(wv[:, :283], mlp256.view_layers[0][0].weight.bfloat16())
    assert not wv[:, 283:].any()
    assert torch.equal(b[8 * 256:8 * 256 + 5], mlp256.density_layer.bias)


@pytest.mark.parametrize("S", [56, 5, 64, 1])
@pytest.mark.parametrize("extra", [0, 1, -1])
def test_tile_plan_covers_every_ray_once_in_whole_rays(S, extra):
    """The kernel's tiling (csrc/fused_render.cu, checked against the
    library once when it is loaded): whole rays only, at most 128 rows per
    tile, every ray in exactly one tile, only the last tile short."""
    per = fr.TILE_ROWS // S
    R = 7 * per + extra
    plan = fr.plan_tiles(R, S)
    assert plan.rays_per_tile == per
    assert plan.rays_per_tile * S <= fr.TILE_ROWS
    assert (plan.rays_per_tile + 1) * S > fr.TILE_ROWS
    seen = []
    for t in range(plan.num_tiles):
        first, end = plan.rays(t)
        assert 0 < end - first <= plan.rays_per_tile
        if t < plan.num_tiles - 1:
            assert end - first == plan.rays_per_tile
        seen.extend(range(first, end))
    assert seen == list(range(R))
    with pytest.raises(IndexError):
        plan.rays(plan.num_tiles)


def test_tile_plan_at_the_eval_shapes():
    """Coarse and fine levels of a 1024-ray chunk at S = 56 (2 rays,
    112 of 128 rows) and its env queries, 10,240 x 5 (25 rays, 125 rows),
    and their ragged twins."""
    assert fr.plan_tiles(1024, 56)[:2] == (2, 512)
    assert fr.plan_tiles(1023, 56)[:2] == (2, 512)
    assert fr.plan_tiles(10240, 5)[:2] == (25, 410)
    assert fr.plan_tiles(10239, 5)[:2] == (25, 410)
    assert fr.plan_tiles(10239, 5).rays(409) == (10225, 10239)


@pytest.mark.parametrize("R, S", [(0, 5), (10, 0), (10, 65)])
def test_tile_plan_rejects_what_the_kernel_does_not_take(R, S):
    with pytest.raises(ValueError):
        fr.plan_tiles(R, S)


class _FakeLibrary:
    """Stands in for the built library: only what `kernel_library` asks."""

    def __init__(self, tile_rows):
        # Functions, not methods: `kernel_library` sets their argtypes.
        self.fused_render_level_launch = lambda *a: 0
        self.fused_render_error_string = lambda code: b""
        self.fused_render_weight_count = lambda: 0
        self.fused_render_bias_count = lambda: 0
        self.fused_render_tile_rays = lambda S: tile_rows // S
        self.fused_render_shape = lambda out: out.__setitem__(
            slice(0, 5), list(fr.shapes.STANDARD))


@pytest.mark.parametrize("tile_rows, ok", [(fr.TILE_ROWS, True), (64, False)])
def test_kernel_library_refuses_a_library_that_tiles_otherwise(
        monkeypatch, tile_rows, ok):
    """The library's own tiling (`fused_render_tile_rays`) is checked
    against `plan_tiles` at every S once, when the library is loaded;
    64-row tiles (the earlier kernel's) are refused."""
    lib = _FakeLibrary(tile_rows)
    monkeypatch.setattr(fr.build, "load_library", lambda source: lib)
    if ok:
        assert fr.kernel_library() is lib
        assert fr.kernel_library() is lib
    else:
        with pytest.raises(RuntimeError, match="cuts tiles unlike"):
            fr.kernel_library()


def test_weight_bytes_per_tile_counts_whole_boxes(mlp256):
    """The MLP's 160 TMA boxes of 8 KB per tile (1.233 MB of weights,
    padded to whole boxes) and the chain's 128 more on the fine level."""
    w, _ = fr.pack_params(mlp256)
    assert fr.weight_bytes_per_tile(False) == 160 * 8192
    assert fr.weight_bytes_per_tile(True) == 288 * 8192
    assert fr.weight_bytes_per_tile(False) >= w.numel() * 2
