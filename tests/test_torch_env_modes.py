"""The env-direction estimators, the second env march and density noise
of the port against the JAX package, on the CPU.

`nerf.env_sampling` rotated / stratified / importance (and the legacy
booleans `env_rotation`, `env_importance`), `nerf.env_resample` and
`nerf.density_noise`: the pieces (`rotation.random_rotations`, the
spherical helpers, `mip.importance_env_directions` and
`stratified_env_directions`) on identical draws at 1e-6, then one f32
train step per mode (loss parts rel 1e-5, gradients rel-norm 1e-4 per
leaf) and the eval render with `env_resample` (f32 atol 1e-4). JAX draws
inside its forward; `replay_draws` replays its key schedule
(pano_mip_nerf.py :310-311, :522-567 and :77-114, mip.py :600-615 and
:679-683, `_resample_env`'s fold_in 0xE5, base.py `_density_noise`) into
the port's `TrainDraws`. The small model of tests/test_torch_train_step.py
(width 64, 16 rays, 8 + 8 samples, 4 env directions x 4 samples; probes
8 cells x 3 samples).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.core.config import load_config as jax_load_config
from pano_nerf_tpu.core.rays import Rays as JaxRays
from pano_nerf_tpu.data.pano_dataset import generate_lit_rays as jax_lit
from pano_nerf_tpu.engine import losses as jax_losses
from pano_nerf_tpu.engine.system import PanoNeRFSystem as JaxSystem
from pano_nerf_tpu.ops import mip as jax_mip
from pano_nerf_tpu.utils import rotation as jax_rotation
from pano_nerf_tpu.utils import spherical as jax_spherical
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.core.rays import rays_to_tensors
from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
from pano_nerf_tpu_torch.engine.system import PanoNeRFSystem
from pano_nerf_tpu_torch.models.pano_mip_nerf import TrainDraws
from pano_nerf_tpu_torch.ops import mip
from pano_nerf_tpu_torch.utils import rotation, spherical
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax

from test_torch_train_step import (B, D, N, OPTS, S, _batch, _leaves, _rel,
                                   f32_on_the_kernels)
import torch_threads  # noqa: F401  (tests/torch_threads.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
DP, SP, SF = 8, 3, 3
SMALL = OPTS + ["nerf.env_probe_dirs", str(DP), "nerf.env_probe_samples",
                str(SP), "nerf.num_env_fine_samples", str(SF)]
T = torch.tensor
# Kernel 4's plain version takes the full width only (the eval route).
WIDE = ["nerf.mlp.net_width", "256", "nerf.mlp.net_width_condition", "128",
        "val.chunk_size", "8"]


def _np(x):
    return np.asarray(x)


def replay_draws(model, step_key, distill_samples=0):
    """The port's TrainDraws of the JAX `model`'s randomized forward at
    `step_key`: every draw JAX takes for the model's switches."""
    keys = jax.random.split(step_key, 5)
    u = lambda k, shape: T(_np(jax.random.uniform(k, shape)))
    n = lambda k, shape: T(_np(jax.random.normal(k, shape)))
    nc = min(model.num_coarse_samples or model.num_samples,
             model.num_samples)
    d = dict(t_coarse=u(keys[0], (B, nc + 1)), u_fine=u(keys[2], (B, N + 1)),
             d_alt=n(jax.random.fold_in(step_key, 0x5C), (B, 3)))
    if model.density_noise > 0:
        d.update(noise_coarse=n(keys[1], (B, nc, 1)),
                 noise_fine=n(keys[3], (B, N, 1)))
    k_env, mode = keys[4], model._env_mode()
    if mode in ("rotated", "stratified"):
        k_env, k_rot, k_jit = jax.random.split(k_env, 3)
        d["q_rot"] = n(k_rot, (B, 4))
        if mode == "stratified":
            k_cos, k_phi = jax.random.split(k_jit)
            d.update(u_cos=u(k_cos, (B, D, 1)), u_phi=u(k_phi, (B, D, 1)))
    elif mode == "importance":
        dp, sp = model.env_probe_dirs, model.env_probe_samples
        k_env, k_rot, k_probe, k_pick = jax.random.split(k_env, 4)
        k_cell, k_cos, k_phi = jax.random.split(k_pick, 3)
        d.update(q_rot=n(k_rot, (B, 4)), t_probe=u(k_probe, (B, dp, sp + 1)),
                 gumbel=T(_np(jax.random.gumbel(k_cell, (B, D, dp)))),
                 u_cos=u(k_cos, (B, D, 1)), u_phi=u(k_phi, (B, D, 1)))
    d["t_env"] = u(k_env, (B, D, S + 1))
    if model.env_resample:
        d["u_resample"] = u(jax.random.fold_in(k_env, 0xE5),
                            (B * D, model.num_env_fine_samples + 1))
    if distill_samples:
        k_sel, k_mar = jax.random.split(jax.random.fold_in(step_key, 0xED))
        d.update(ed_idx=T(_np(jax.random.randint(k_sel, (B, 1), 0, D)),
                          dtype=torch.int64),
                 t_ed=u(k_mar, (B, 1, distill_samples + 1)))
    return TrainDraws(**d)


def systems(extra, precision="f32", perturb_illum=False, on_kernels=True,
            jit_init=False):
    """JAX and port systems of the small model with `extra` opts, on the
    same parameters: (JAX system, JAX params, port system). With
    `on_kernels` an f32 port system of the kernels' topology takes the
    kernel route (`test_torch_train_step.f32_on_the_kernels`). With
    `perturb_illum` the illuminant field's output layer (zero at init, so
    that its hidden layers get no gradient) is drawn from a numpy seed,
    N(0, 0.1^2), beside JAX's Xavier hidden layers. `jit_init` compiles
    JAX's initialiser whole (the same parameters bit for bit; quicker
    than op by op at wide trunks, slower where the ops are cached)."""
    opts = SMALL + ["train.precision", f"'{precision}'", *extra]
    jsys = JaxSystem(jax_load_config(CONFIG, opts))
    jsys.set_env_rays(jax_lit(num=D, far=10.0))
    init = jax.jit(jsys.model.init) if jit_init else jsys.model.init
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    if perturb_illum:
        rng = np.random.default_rng(5)
        illum = params["params"]["illum"]
        for k in ("w_out", "b_out"):
            illum[k] = (0.1 * rng.normal(size=illum[k].shape)).astype(
                np.float32)
    psys = PanoNeRFSystem(load_config(CONFIG, opts), device="cpu")
    if on_kernels:
        f32_on_the_kernels(psys)
    psys.model.load_params(params_from_jax(params))
    psys.set_env_rays(generate_lit_rays(D, 0.0, 10.0))
    return jsys, params, psys


def step_both(extra, step=0, perturb_illum=False):
    """One f32 train step of both at `step` on the test batch: (port loss
    parts, JAX loss parts, port grads, JAX grads masked and clipped as
    JAX's step does, port system)."""
    jsys, params, psys = systems(extra, perturb_illum=perturb_illum)
    rays_np, rgbs_np = _batch()
    key = jax.random.fold_in(jax.random.PRNGKey(7), step)
    hp_j = jsys.hparams

    def loss_fn(p):
        outs = jsys.model(p, key, JaxRays(*rays_np), jsys.env_rays,
                          randomized=True, white_bkgd=False,
                          enable_surf=True, use_ort_loss=True,
                          use_vc_loss=True)
        parts = jax_losses.pano_losses(outs, jnp.asarray(rgbs_np),
                                       jnp.asarray(rays_np.lossmult), hp_j,
                                       True, step=jnp.int32(step))
        return parts["loss"], parts

    (_, j_parts), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    state = psys.create_state()
    state.step = step
    parts = psys.make_train_step(True)(
        state, rays_to_tensors(rays_np, torch.device("cpu")),
        torch.tensor(rgbs_np), replay_draws(jsys.model, key))
    grads = params_to_jax({n: p.grad for n, p in
                           psys.model.named_params()})
    # The port's gradients are read after its step's illum freeze and
    # global-norm clip: JAX's (engine/system.py `_freeze_illum_grads`,
    # `clip_by_global_norm`) on JAX's.
    j_grads = jsys._freeze_illum_grads(j_grads, jnp.int32(step))
    jg = _leaves(jax.tree.map(np.asarray, j_grads))
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in jg.values()))
    clip = float(hp_j["optimizer.grad_clip"])
    jg = {k: g * np.float32(clip / max(norm, clip)) for k, g in jg.items()}
    return parts, j_parts, _leaves(grads), jg, psys


def check_step(parts, j_parts, pg, jg, names=()):
    """Loss parts at rel 1e-5, gradients at rel-norm 1e-4 per leaf."""
    names = {"loss", "vol_coarse", "vol_fine", "vol_surface", "chrom",
             "ort", "dist", "sat", "vc", *names}
    assert set(parts) == names
    for k in names:
        want, got = float(j_parts[k]), float(parts[k])
        assert abs(got - want) <= 1e-5 * abs(want) + 1e-9, (k, got, want)
    assert jg.keys() == pg.keys()
    for k in jg:
        assert _rel(pg[k], jg[k]) < 1e-4, (k, _rel(pg[k], jg[k]))


# ---- the pieces, on identical draws ----

def test_random_rotations_match_jax():
    key = jax.random.PRNGKey(3)
    q = jax.random.normal(key, (7, 4))
    want = _np(jax_rotation.random_rotations(key, (7,)))
    got = rotation.random_rotations(T(_np(q))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    dirs = jax_spherical.sample_dir_by_uniform(5)
    np.testing.assert_allclose(
        rotation.rotate(T(got), T(dirs)).numpy(),
        _np(jnp.einsum("bij,dj->bdi", want, dirs)), atol=1e-6)
    rrt = np.einsum("bij,bij->b", got, got)   # orthonormal: trace(R R^T)
    np.testing.assert_allclose(rrt, 3.0, atol=1e-5)


def test_rot_to_target_matches_jax():
    rng = np.random.default_rng(1)
    t = rng.normal(size=(6, 3))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    t[0] = [0.0, -1.0, 0.0]   # the antipode's fallback
    np.testing.assert_array_equal(rotation.batched_rot_to_target(t),
                                  jax_rotation.batched_rot_to_target(t))
    for v in t:
        np.testing.assert_array_equal(rotation.rot_to_target(v),
                                      jax_rotation.rot_to_target(v))
    np.testing.assert_array_equal(rotation.RotToTarget().rot2t(t),
                                  jax_rotation.RotToTarget().rot2t(t))


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_basis_matches_jax(deg):
    rng = np.random.default_rng(deg)
    d = rng.normal(size=(5, 4, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = _np(jax_spherical.sh_basis(jnp.asarray(d), deg))
    got = spherical.sh_basis(T(d), deg).numpy()
    assert got.shape == (5, 4, (deg + 1) ** 2)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sh_basis_refuses_degree_four():
    with pytest.raises(ValueError, match="deg 0..3"):
        spherical.sh_basis(torch.zeros(2, 3), 4)


def test_spherical_helpers_match_jax():
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(9, 3))
    for fn in ("sample_dir_by_uniform",):
        np.testing.assert_array_equal(getattr(spherical, fn)(10),
                                      getattr(jax_spherical, fn)(10))
    for a, b in zip(spherical.sample_dir_by_pano((4, 8)),
                    jax_spherical.sample_dir_by_pano((4, 8))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(spherical.pos_to_spherical(pos),
                    jax_spherical.pos_to_spherical(pos)):
        np.testing.assert_array_equal(a, b)
    th, ph = rng.uniform(-6, 0, 9), rng.uniform(0, 3, 9)
    np.testing.assert_array_equal(spherical.spherical_to_pos(th, ph, 2.0),
                                  jax_spherical.spherical_to_pos(th, ph, 2.0))
    np.testing.assert_array_equal(spherical.spherical_to_pixel(th, ph),
                                  jax_spherical.spherical_to_pixel(th, ph))
    x = rng.normal(size=(12, 3))
    np.testing.assert_array_equal(
        spherical.interp_uniform_to_pixel(x, [4, 8], 2),
        jax_spherical.interp_uniform_to_pixel(x, [4, 8], 2))
    idx = rng.integers(0, 12, (3, 4))
    np.testing.assert_array_equal(
        spherical.inverse_uniform_to_pixel(x, idx),
        jax_spherical.inverse_uniform_to_pixel(x, idx))


def _cells(seed, b, c):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c, 3)).astype(np.float32)
    x[0, 0] = [0.0, 0.1, 0.99]   # a center near +z: the frame's x axis
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("zero_row", [False, True])
def test_importance_env_directions_match_jax(zero_row):
    b, dp, nd = 6, 8, 5
    cells = _cells(0, b, dp)
    w = np.random.default_rng(1).uniform(0, 2, (b, dp)).astype(np.float32)
    if zero_row:   # all-zero weights: the uniform proposal
        w[2] = 0.0
    key = jax.random.PRNGKey(9)
    want_d, want_w = jax_mip.importance_env_directions(
        key, jnp.asarray(cells), jnp.asarray(w), nd)
    k_cell, k_cos, k_phi = jax.random.split(key, 3)
    got_d, got_w = mip.importance_env_directions(
        T(cells), T(w), nd, T(_np(jax.random.gumbel(k_cell, (b, nd, dp)))),
        T(_np(jax.random.uniform(k_cos, (b, nd, 1)))),
        T(_np(jax.random.uniform(k_phi, (b, nd, 1)))))
    np.testing.assert_allclose(got_d.numpy(), _np(want_d), atol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), _np(want_w), rtol=1e-6)


def test_stratified_env_directions_match_jax():
    b, d = 6, 10
    cells = _cells(3, b, d)
    key = jax.random.PRNGKey(4)
    want_d, want_w = jax_mip.stratified_env_directions(key,
                                                       jnp.asarray(cells))
    k_cos, k_phi = jax.random.split(key)
    got_d, got_w = mip.stratified_env_directions(
        T(cells), T(_np(jax.random.uniform(k_cos, (b, d, 1)))),
        T(_np(jax.random.uniform(k_phi, (b, d, 1)))))
    np.testing.assert_allclose(got_d.numpy(), _np(want_d), atol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), _np(want_w), rtol=1e-6)


def test_resample_takes_stop_grad_and_num_samples():
    """`_resample_env`'s call: the second march's fenceposts carry no
    gradient, its frustums do through the ray origins, and its sample
    count is `num_samples`, not the first march's."""
    rng = np.random.default_rng(6)
    o = T(rng.normal(size=(5, 3)).astype(np.float32)).requires_grad_()
    d = T(rng.normal(size=(5, 3)).astype(np.float32))
    t = T(np.sort(rng.uniform(0, 10, (5, 7)), -1).astype(np.float32))
    w = T(rng.uniform(0, 1, (5, 6)).astype(np.float32)).requires_grad_()
    key = jax.random.PRNGKey(8)
    jt, (jm, _) = jax_mip.resample_along_rays(
        key, _np(o.detach()), _np(d), np.full((5, 1), 0.01, np.float32),
        _np(t), _np(w.detach()), True, True, 0.01, num_samples=3)
    pt, (pm, _) = mip.resample_along_rays(
        o, d, T(np.full((5, 1), 0.01, np.float32)), t, w, 0.01,
        num_samples=3, u_rand=T(_np(jax.random.uniform(key, (5, 4)))))
    assert pt.shape == (5, 4) and not pt.requires_grad
    np.testing.assert_allclose(pt.numpy(), _np(jt), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pm.detach().numpy(), _np(jm), rtol=1e-5,
                               atol=1e-5)
    pm.sum().backward()
    assert w.grad is None and torch.all(o.grad == 3.0)


# ---- one train step per mode ----

MODES = {
    "rotated": ["nerf.env_rotation", "True"],
    "stratified": ["nerf.env_sampling", "stratified"],
    "importance": ["nerf.env_importance", "True"],
    "env_resample": ["nerf.env_resample", "True"],
    "density_noise": ["nerf.density_noise", "1.0"],
}


@pytest.mark.parametrize("sampling,rotation,importance", [
    ("auto", False, False), ("auto", True, False), ("auto", True, True),
    ("fixed", True, True), ("rotated", False, False),
    ("stratified", False, True), ("importance", False, False)])
def test_env_mode_resolves_as_in_jax(sampling, rotation, importance):
    """`nerf.env_sampling`, or with "auto" importance > rotated > fixed
    from the legacy booleans."""
    from pano_nerf_tpu.models import build_model as jax_build_model
    from pano_nerf_tpu_torch.models.base import NerfConfig
    hp = dict(load_config(CONFIG), **{
        "nerf.env_sampling": sampling, "nerf.env_rotation": rotation,
        "nerf.env_importance": importance})
    want = jax_build_model(hp)._env_mode()
    assert NerfConfig.from_hparams(hp).env_mode() == want


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_jax_in_f32(mode):
    parts, j_parts, pg, jg, _ = step_both(MODES[mode])
    check_step(parts, j_parts, pg, jg)


def _port_step(extra, step=0):
    """One f32 port step with JAX's draws at `step` (the
    `step_both` batch): (loss parts, {name: grad})."""
    jsys, _, psys = systems(extra)
    rays_np, rgbs_np = _batch()
    key = jax.random.fold_in(jax.random.PRNGKey(7), step)
    parts = psys.make_train_step(True)(
        psys.create_state(), rays_to_tensors(rays_np, torch.device("cpu")),
        torch.tensor(rgbs_np), replay_draws(jsys.model, key))
    return parts, {n: p.grad.clone() for n, p in psys.model.named_params()}


def test_kernel5_takes_per_ray_directions_and_density_noise_turns_it_off(
        monkeypatch):
    """With the key on, stratified per-ray directions reach kernel 5 (its
    plain version here) on the env level, and the step is the key-off
    step (test_torch_point_normals.py holds it to JAX); under density
    noise kernel 5 runs no level (JAX's gate) and the step is the key-off
    one exactly."""
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    calls, plain = [], k5.fused_render_train_reference

    def counted(mlp, means, *a, **k):
        calls.append(tuple(means.shape))
        return plain(mlp, means, *a, **k)

    monkeypatch.setattr(k5, "fused_render_train_reference", counted)
    key_on = ["nerf.use_train_render_kernel", "True"]
    for mode, want_calls in (("stratified", [(B, N, 3), (B * D, S, 3)]),
                             ("density_noise", [])):
        calls.clear()
        on_parts, on_grads = _port_step(MODES[mode] + key_on)
        assert calls == want_calls, mode
        off_parts, off_grads = _port_step(MODES[mode])
        for k, v in off_parts.items():
            got, want = float(on_parts[k]), float(v)
            assert abs(got - want) <= 1e-5 * abs(want) + 1e-9, (mode, k)
        for n, g in off_grads.items():
            if want_calls:
                assert _rel(on_grads[n].numpy(), g.numpy()) < 1e-4, n
            else:
                assert torch.equal(on_grads[n], g), n


def test_env_resample_render_matches_jax(monkeypatch):
    """Eval with env_resample: the port's kernel-4 route (its plain
    version here), a fourth level per chunk on the resampled env march,
    against JAX's first-order standard path, f32 atol 1e-4."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    from pano_nerf_tpu_torch.kernels import fused_render as k4
    calls, plain = [], k4.fused_render_level_reference

    def counted(mlp, means, *a, **k):
        calls.append(tuple(means.shape))
        return plain(mlp, means, *a, **k)

    monkeypatch.setattr(k4, "fused_render_level_reference", counted)
    jsys, params, psys = systems(MODES["env_resample"] + WIDE)
    rays_np, _ = _batch(1)
    want = jsys.make_render_image(enable_surf=True)(params,
                                                    JaxRays(*rays_np))
    got = psys.make_render_image(True)(None, rays_to_tensors(
        rays_np, torch.device("cpu")))
    assert calls[:4] == [(8, N, 3), (8, N, 3), (8 * D, S, 3),
                         (8 * D, SF, 3)] and len(calls) == 8
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)


def test_eval_keeps_the_fixed_set():
    """The env estimator is a training switch: a render with stratified
    sampling on equals the render with it off."""
    rays = rays_to_tensors(_batch(1)[0], torch.device("cpu"))
    renders = []
    for extra in ([], MODES["stratified"] + ["nerf.density_noise", "1.0"]):
        psys = systems(extra + WIDE)[2]
        renders.append(psys.make_render_image(True)(None, rays))
    for k in renders[0]:
        torch.testing.assert_close(renders[1][k], renders[0][k], rtol=0,
                                   atol=0)
