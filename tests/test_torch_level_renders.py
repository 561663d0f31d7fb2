"""The eval renders of JAX's level loop and of `val.randomized` in the
port against the JAX package, on the CPU: f32 renders at atol 1e-4
(mip-NeRF's normal 1e-3) and bf16 kernel-route renders at the kernel
tolerances of tests/test_torch_render.py. Kernel 4's plain version
takes the full width (`test_torch_env_modes.WIDE`); JAX's draws of
`PRNGKey(0)` at the eval counts are replayed and injected
(`test_torch_levels.replay`).
"""

import jax
import numpy as np
import pytest

from pano_nerf_tpu.core.rays import Rays as JaxRays
from pano_nerf_tpu_torch.core.rays import rays_to_tensors

from test_torch_env_modes import WIDE, systems
from test_torch_levels import CPU, LEVELS, replay
from test_torch_mip_nerf import _batch as mip_batch
from test_torch_mip_nerf import _systems as mip_systems
from test_torch_train_step import D, _batch


def _eval_draws(model, chunk):
    return replay(model, jax.random.PRNGKey(0), batch=chunk,
                  eval_counts=True)


def test_pano_render_matches_jax_at_three_levels(monkeypatch):
    """The eval render through kernel 4 (its plain version): three
    launches per chunk before the env march (levels 0, 1 and the fine
    one), against JAX's standard first-order path at f32 atol 1e-4."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    from pano_nerf_tpu_torch.kernels import fused_render as k4
    calls, plain = [], k4.fused_render_level_reference

    def counted(mlp, means, *a, **k):
        calls.append(tuple(means.shape))
        return plain(mlp, means, *a, **k)

    monkeypatch.setattr(k4, "fused_render_level_reference", counted)
    jsys, params, psys = systems(LEVELS["3"] + WIDE)
    rays_np, _ = _batch(1)
    want = jsys.make_render_image(enable_surf=True)(params,
                                                    JaxRays(*rays_np))
    got = psys.make_render_image(True)(None, rays_to_tensors(rays_np, CPU))
    assert calls[:4] == [(8, 8, 3)] * 3 + [(8 * D, 4, 3)]
    assert len(calls) == 8
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("levels", ["1", "3"])
def test_mip_render_matches_jax_at_num_levels(levels, monkeypatch):
    """mip-NeRF's eval at one level (the one level carries the normal,
    through kernel 3's forward) and three (levels 0, 1 through kernel 2,
    the normal placeholder of ones on them)."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    jsys, state, psys = mip_systems("f32", ["nerf.num_levels", levels])
    rays_np, _ = mip_batch(1)
    want = jsys.make_render_image()(state.params, JaxRays(*rays_np))
    got = psys.make_render_image()(None, rays_to_tensors(rays_np, CPU))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3 if k == "normal" else 1e-4,
                                   err_msg=k)


BF16 = {"levels3": ["nerf.num_levels", "3"],
        "val_randomized": ["val.randomized", "True"]}


@pytest.mark.parametrize("case", sorted(BF16))
def test_bf16_kernel_route_render_tracks_jax(case, monkeypatch):
    """bf16 renders of 100 rays through kernel 4 (its plain version) at
    three levels and under `val.randomized` (JAX's draws injected)
    against JAX's bf16 render (its XLA route here; bf16 rounds at other
    places in the two), at the kernel tolerances of
    tests/test_torch_render.py: products at atol 2e-2, the normals'
    cosine median above 0.998 and every ray's above 0.85 unless bf16
    turns JAX's own normal there (its cosine to the f32 normal, the
    port's f32 render, below 0.99: at random init a ray's expected
    normal can average nearly cancelling per-sample gradients, which a
    rounding on the other side of a ReLU turns)."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    rays_np, _ = mip_batch(1, num=100)
    rays = rays_to_tensors(rays_np, CPU)
    renders = {}
    for precision in ("bf16", "f32"):
        jsys, params, psys = systems(BF16[case] + WIDE, precision)
        assert psys.model.kernels
        draws = _eval_draws(jsys.model, 8) if psys.val_randomized else None
        renders[precision] = psys.make_render_image(True, draws=draws)(
            None, rays)
    jsys, params, _ = systems(BF16[case] + WIDE, "bf16")
    want = jsys.make_render_image(enable_surf=True)(params,
                                                    JaxRays(*rays_np))
    got = renders["bf16"]
    for k in ("rgb_coarse", "dep_coarse", "rgb_fine", "dep_fine", "albedo",
              "roughness"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-2, err_msg=k)
    j_normal = np.asarray(want["normal"])
    cos = np.sum(got["normal"].numpy() * j_normal, -1)
    jax_turn = np.sum(renders["f32"]["normal"].numpy() * j_normal, -1)
    assert np.median(cos) > 0.998, np.median(cos)
    off = cos <= 0.85
    assert np.all(jax_turn[off] < 0.99), (cos[off], jax_turn[off])
