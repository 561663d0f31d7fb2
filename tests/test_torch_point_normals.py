"""Point normals (`nerf.point_normals`) of the port against the JAX
package, on the CPU.

In training the fine level runs without the per-sample density gradient
(kernel 2) and the normal is one density-gradient query per ray at the
detached expected Gaussian (kernel 3 at S = 1, JAX `_point_normal`,
models/base.py:772-819); eval keeps the per-sample normals. Held here:
`_point_normal` and the gradient of a loss on it (rel 1e-5 / rel-norm
1e-4), one f32 train step (alone, and with stratified env directions
through kernel 5 as `chip_smoke.py` phase 13 runs it), which kernel
takes which rows, and the eval render's independence of the key. The
small model of tests/test_torch_train_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pano_nerf_tpu_torch.core.rays import rays_to_tensors
from pano_nerf_tpu_torch.utils.params import params_to_jax

from test_torch_env_modes import (MODES, WIDE, check_step, step_both,
                                  systems)
from test_torch_train_step import B, N, _batch, _leaves, _rel

POINT = ["nerf.point_normals", "True"]


def test_point_normal_matches_jax():
    jsys, params, psys = systems(POINT)
    rng = np.random.default_rng(4)
    means = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    covs = rng.uniform(1e-4, 1e-2, (B, N, 3)).astype(np.float32)
    w = rng.uniform(0, 0.3, (B, N)).astype(np.float32)
    rays_np, _ = _batch()

    def j_loss(p):
        n, ort = jsys.model._point_normal(
            p, jnp.asarray(means), jnp.asarray(covs),
            jnp.asarray(rays_np.viewdirs), jnp.asarray(w),
            jnp.asarray(rays_np.directions), True)
        return jnp.sum(jnp.sin(3 * n)) + 10 * ort, (n, ort)

    (_, (want_n, want_ort)), j_grads = jax.value_and_grad(
        j_loss, has_aux=True)(params)
    model = psys.model
    normal, ort = model._point_normal(
        torch.tensor(means), torch.tensor(covs),
        model._venc(torch.tensor(rays_np.viewdirs)), torch.tensor(w),
        torch.tensor(rays_np.directions), True, None)
    np.testing.assert_allclose(normal.detach().numpy(), np.asarray(want_n),
                               rtol=1e-5, atol=1e-6)
    got_ort = float(ort.detach())
    assert abs(got_ort - float(want_ort)) <= 1e-5 * abs(float(want_ort))
    (torch.sum(torch.sin(3 * normal)) + 10 * ort).backward()
    # The view branch gets no gradient from a normal (JAX's: zeros).
    pg = _leaves(params_to_jax({
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in model.named_params()}))
    jg = _leaves(jax.tree.map(np.asarray, j_grads))
    for k in jg:
        assert _rel(pg[k], jg[k]) < 1e-4, (k, _rel(pg[k], jg[k]))


def _counting(monkeypatch):
    """Record the means' shapes reaching the plain versions of kernels 2
    and 3."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    calls = []
    for mod, name in ((k2, "fused_mlp_ipe_reference"),
                      (k3, "fused_mlp_normals_reference")):
        plain = getattr(mod, name)

        def counted(mlp, means, *a, _plain=plain, _name=name, **k):
            calls.append((_name.split("_reference")[0], tuple(means.shape)))
            return _plain(mlp, means, *a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


def test_train_step_matches_jax_in_f32(monkeypatch):
    """The fine level on kernel 2, the normal from one kernel-3 row per
    ray; loss parts and gradients as JAX's."""
    calls = _counting(monkeypatch)
    check_step(*step_both(POINT)[:4])
    assert calls[:3] == [("fused_mlp_ipe", (B, N, 3)),
                         ("fused_mlp_ipe", (B, N, 3)),
                         ("fused_mlp_normals", (B, 1, 3))]
    assert sum(c[0] == "fused_mlp_normals" for c in calls) == 1


def test_stratified_kernel5_step_matches_jax_in_f32():
    """`chip_smoke.py` phase 13's switches: stratified env directions
    through kernel 5 (its plain version) beside point normals."""
    check_step(*step_both(POINT + MODES["stratified"] + [
        "nerf.use_train_render_kernel", "True"])[:4])


def test_eval_keeps_per_sample_normals():
    rays = rays_to_tensors(_batch(1)[0], torch.device("cpu"))
    on, off = (systems(extra + WIDE)[2].make_render_image(True)(None, rays)
               for extra in (POINT, []))
    for k in off:
        torch.testing.assert_close(on[k], off[k], rtol=0, atol=0)
