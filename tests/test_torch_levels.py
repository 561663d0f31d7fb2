"""JAX's level loop in the port, against the JAX package on the CPU.

`nerf.num_levels` 1 and 3 for Pano-NeRF and mip-NeRF, and
`nerf.stop_resample_grad: false` (the resampling's gradient through the
piecewise-constant inverse CDF into the previous level's weights). JAX
loops over its levels (pano_nerf_tpu/models/pano_mip_nerf.py:193, :314,
models/mip_nerf.py:48): level 0 evenly spaced or stratified, every later
one resampled from the one before; Pano-NeRF's fine level, with normals
and the surface path, is the last of two or more (:197, :318-319), so at
one level there is none, its losses read the one level as both coarse
and fine and its eval render raises (engine/system.py:347-354), which
the port refuses by name. mip-NeRF's last level carries the normal
whatever the count.

`replay` replays JAX's key schedule of a forward into the port's draws:
`split(key, 2 L + 1)` (mip-NeRF 2 L), level i placed by keys[2 i] and
noised by keys[2 i + 1], the env set by keys[-1]. One f32 train step
each, on the small model of tests/test_torch_train_step.py (width 64, 16
rays, 8 + 8 samples, 4 env directions x 4 samples): loss parts at rel
1e-5, gradients at rel-norm 1e-4 per leaf, or twice JAX's own change
under 1e-6 shifts of the rays (`test_torch_presets._check_grads`). On
the CPU the kernel route runs the kernels' plain versions. The eval
renders are in tests/test_torch_level_renders.py.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.core.rays import Rays as JaxRays
from pano_nerf_tpu.engine import losses as jax_losses
from pano_nerf_tpu_torch.core.rays import rays_map, rays_to_tensors
from pano_nerf_tpu_torch.models.mip_nerf import MipDraws
from pano_nerf_tpu_torch.models.pano_mip_nerf import TrainDraws
from pano_nerf_tpu_torch.ops import mip
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax

from test_torch_env_modes import systems
from test_torch_mip_nerf import _batch as mip_batch
from test_torch_mip_nerf import _systems as mip_systems
from test_torch_presets import SHIFTS, _check_grads, _noise, _shifted
from test_torch_train_step import B, D, _batch, _leaves, _rel

T = torch.tensor
CPU = torch.device("cpu")
KEY5 = ["nerf.use_train_render_kernel", "True"]


def _u(key, shape):
    return T(np.asarray(jax.random.uniform(key, shape)))


def _n(key, shape):
    return T(np.asarray(jax.random.normal(key, shape)))


def replay(model, key, batch=B, eval_counts=False):
    """The port's draws (TrainDraws, or MipDraws for JAX's `MipNeRF`) of
    the JAX `model`'s randomized forward at `key`, at its training or
    (`eval_counts`) eval sample counts, on the fixed env set (JAX
    base.py:834-865 and :678-684, pano_mip_nerf.py:310-311, :457-459 and
    :563-567, mip_nerf.py:47)."""
    L = model.num_levels
    pano = type(model).__name__ != "MipNeRF"
    keys = jax.random.split(key, 2 * L + pano)
    ev = eval_counts
    nc = min(model.eval_coarse_samples if ev and model.eval_coarse_samples
             else model.num_coarse_samples or model.num_samples,
             model.num_samples)
    n = (model.eval_fine_samples if ev and model.eval_fine_samples
         else model.num_samples)
    counts = [nc] + [n] * (L - 1)
    d = dict(t_coarse=_u(keys[0], (batch, nc + 1)),
             u_fine=_u(keys[2], (batch, n + 1)) if L > 1 else None)
    if L > 2:
        d["u_more"] = torch.stack([_u(keys[2 * i], (batch, n + 1))
                                   for i in range(2, L)])
    if model.density_noise > 0:
        noise = [_n(keys[2 * i + 1], (batch, counts[i], 1))
                 for i in range(L)]
        d.update(noise_coarse=noise[0],
                 noise_fine=noise[1] if L > 1 else None)
        if L > 2:
            d["noise_more"] = torch.stack(noise[2:])
    if not pano:
        return MipDraws(**d)
    s = (model.eval_env_samples if ev and model.eval_env_samples
         else model.num_env_samples)
    d.update(t_env=_u(keys[-1], (batch, D, s + 1)),
             d_alt=_n(jax.random.fold_in(key, 0x5C), (batch, 3)))
    return TrainDraws(**d)


def port_step(psys, model, key):
    """One port train step on the test batch with the JAX `model`'s draws
    at `key` (none without `train.randomized`): (parts, grads by leaf)."""
    rays_np, rgbs_np = _batch()
    draws = replay(model, key) if psys.train_randomized else None
    parts = psys.make_train_step(True)(
        psys.create_state(), rays_to_tensors(rays_np, CPU),
        torch.tensor(rgbs_np), draws)
    return parts, _leaves(params_to_jax({n: p.grad for n, p in
                                         psys.model.named_params()}))


@functools.lru_cache(maxsize=None)
def _jax_step(extra, shifts):
    """JAX's f32 train step of the small Pano-NeRF model with the opts
    `extra` (a tuple) on the test batch, `randomized` from
    `train.randomized`: (loss parts, grads clipped as JAX's step clips
    them, grads of `shifts` batches with shifted rays, their loss
    parts). Kernel 5's key
    changes nothing in JAX's f32 step (its kernels take bf16 only), so
    the cases with and without it share one compile."""
    jsys, params, _ = systems(list(extra))
    rays_np, rgbs_np = _batch()
    key = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    hp_j = jsys.hparams

    def loss_fn(p, rays):
        outs = jsys.model(p, key, rays, jsys.env_rays,
                          randomized=jsys.train_randomized,
                          white_bkgd=False, enable_surf=True,
                          use_ort_loss=True, use_vc_loss=True)
        parts = jax_losses.pano_losses(outs, jnp.asarray(rgbs_np),
                                       jnp.asarray(rays_np.lossmult), hp_j,
                                       True, step=jnp.int32(0))
        return parts["loss"], parts

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, j_parts), j_grads = grad_fn(params, JaxRays(*rays_np))
    clip = float(hp_j["optimizer.grad_clip"])

    def clipped(g):
        g = _leaves(jax.tree.map(np.asarray, g))
        norm = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                           for x in g.values()))
        return {k: x * np.float32(clip / max(norm, clip))
                for k, x in g.items()}

    floats = lambda ps: {k: None if v is None else float(v)
                         for k, v in ps.items()}
    runs = [grad_fn(params, _shifted(rays_np, i)) for i in range(shifts)]
    return (floats(j_parts), clipped(j_grads),
            [clipped(g) for _, g in runs],
            [floats(ps) for (_, ps), _ in runs])


def pano_step(extra, shifts=0, on_kernels=True):
    """One f32 train step of both Pano-NeRF systems with `extra` opts on
    the test batch (the port on the kernel route where `on_kernels`),
    JAX's `randomized` from `train.randomized`: (port parts, JAX parts,
    port grads, JAX grads clipped as JAX's step clips them, JAX grads of
    `shifts` shifted batches, a function giving the port's step in
    float64 from the same state: (loss parts, grads))."""
    jsys, params, psys = systems(extra, on_kernels=on_kernels)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    j_parts, j_grads, shifted, _ = _jax_step(
        tuple(x for x in extra if x not in KEY5), shifts)
    parts, grads = port_step(psys, jsys.model, key)

    def exact():
        sys64 = copy.deepcopy(psys)
        sys64.model.double()
        sys64.model.kernels = False  # the kernels' plain versions take f32
        sys64.model.load_params({k: v.double() for k, v in
                                 params_from_jax(params).items()})
        sys64.env_rays = rays_map(lambda x: x.double(), sys64.env_rays)
        draws = replay(jsys.model, key)
        rays_np, rgbs_np = _batch()
        parts64 = sys64.make_train_step(True)(
            sys64.create_state(),
            rays_map(lambda x: x.double(), rays_to_tensors(rays_np, CPU)),
            torch.tensor(rgbs_np).double(),
            type(draws)(*(x.double() if x is not None
                          and x.is_floating_point() else x for x in draws))
            if psys.train_randomized else None)
        return parts64, _leaves(params_to_jax(
            {n: p.grad for n, p in sys64.model.named_params()}))

    return parts, j_parts, grads, j_grads, shifted, exact


def check_parts(parts, j_parts, exact=None):
    """The port's loss parts are JAX's (those that are not None), each
    at rel 1e-5; where one is not, and `exact()` gives the port's step
    in float64, the port's f32 part within 1e-5 of its part and JAX's within
    1e-4 (XLA fuses a differentiated forward otherwise: it moved
    vol_surface by 7e-5 at three levels without stop_resample_grad,
    where JAX's forward alone agrees with the port's within 2e-6)."""
    names = {k for k, v in j_parts.items() if v is not None}
    assert set(parts) == names, (sorted(parts), sorted(names))
    near = lambda a, b, r: abs(a - b) <= r * abs(b) + 1e-9
    p64 = None
    for k in names:
        want, got = float(j_parts[k]), float(parts[k])
        if near(got, want, 1e-5):
            continue
        assert exact is not None, (k, got, want)
        p64 = exact()[0] if p64 is None else p64
        assert near(got, float(p64[k]), 1e-5) and near(
            want, float(p64[k]), 1e-4), (k, got, want, float(p64[k]))


def check_pano_step(extra, shifts=0, on_kernels=True):
    parts, j_parts, pg, jg, shifted, exact = pano_step(extra, shifts,
                                                       on_kernels)
    check_parts(parts, j_parts, exact)
    _check_grads(pg, jg, shifted)
    return parts, pg


LEVELS = {"1": ["nerf.num_levels", "1"], "3": ["nerf.num_levels", "3"],
          "3-key5": ["nerf.num_levels", "3"] + KEY5}


@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_pano_train_step_matches_jax_at_num_levels(levels, monkeypatch):
    """At one level the step has only the coarse losses (vol_coarse =
    vol_fine, the distortion loss of the level counted as both levels');
    at three the middle level is resampled from the coarse one and its
    own distortion loss is not read (JAX reads outs[0] and outs[-1]);
    with the key on kernel 5 (its plain version) renders levels 0 and 1
    and the env march."""
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    calls, plain = [], k5.fused_render_train_reference

    def counted(mlp, means, *a, **k):
        calls.append(tuple(means.shape))
        return plain(mlp, means, *a, **k)

    monkeypatch.setattr(k5, "fused_render_train_reference", counted)
    parts = check_pano_step(LEVELS[levels])[0]
    if levels == "1":
        assert float(parts["vol_coarse"]) == float(parts["vol_fine"])
        assert "ort" not in parts and "vol_surface" not in parts
    else:
        assert {"ort", "vol_surface", "vc", "dist"} <= set(parts)
    assert calls == ([(B, 8, 3), (B, 8, 3), (B * D, 4, 3)]
                     if levels == "3-key5" else [])


STOP = {"2": ["nerf.stop_resample_grad", "False"],
        "2-key5": ["nerf.stop_resample_grad", "False"] + KEY5}


@pytest.mark.parametrize("case", sorted(STOP))
def test_resampling_gradient_matches_jax(case):
    """`stop_resample_grad: false`: the fine frustums' gradient flows
    back through the resampled fenceposts into the coarse weights (kernel
    3's moment gradient and, with the key on, kernel 5's weights
    cotangent); the gradient differs from the stopped one's."""
    pg = check_pano_step(STOP[case], SHIFTS)[1]
    jsys, _, psys = systems(STOP[case][2:])
    stopped = port_step(psys, jsys.model,
                        jax.random.fold_in(jax.random.PRNGKey(7), 0))[1]
    assert max(_rel(pg[k], stopped[k]) for k in pg) > 1e-3


@pytest.mark.parametrize("case", ["3", "3-key5"])
def test_resampling_gradient_over_three_levels_matches_jax(case):
    """Over three levels the resampling gradient chains two inverse CDFs.
    This batch is ill-conditioned there in f32 (ray 4's surface shading
    moves by 3.9e-4 between the port's f32 and f64 steps): JAX's own
    gradient moves by up to 1.9e-2 per leaf under 1e-6 shifts of the
    rays, beyond `_check_grads`' cap, and its parts by up to 3.4e-3
    (`ort`). JAX's two compiles of the same forward land on either side
    (with the gradient stopped it reads the port's values, without it
    the f64 ones), so neither f32 step is within 1e-4 of the f64 one on
    every leaf (the port's reads 5.2e-3 on trunk_1/bias, JAX's stopped
    one 1.45e-2). JAX's change under the shifts is the allowance, and
    the port's float64 step from the same state the arbiter: each loss
    part within twice JAX's change (at least rel 1e-5) of JAX's and of
    the f64 one; each gradient leaf within twice JAX's change (at least
    1e-4) of JAX's and of the f64 one, and JAX's within ten times it (at
    least 1e-3) of the f64 one. Detaching the second resampling's inputs
    reads 0.26-1.05 on the trunk, 184 times the allowance. With the key
    on, kernel 5's plain version renders levels 0 and 1 and its weights
    cotangent carries the gradient (the f64 arbiter composites plainly:
    the kernels' plain versions take f32)."""
    stop = ["nerf.stop_resample_grad", "False", "nerf.num_levels", "3"]
    extra = stop + (KEY5 if case == "3-key5" else [])
    parts, j_parts, pg, jg, shifted, exact = pano_step(extra, SHIFTS)
    shifted_parts = _jax_step(tuple(stop), SHIFTS)[3]
    p64, g64 = exact()
    names = {k for k, v in j_parts.items() if v is not None}
    assert set(parts) == names, (sorted(parts), sorted(names))
    for k in names:
        want = j_parts[k]
        moved = max(abs(p[k] - want) for p in shifted_parts)
        tol = max(1e-5, 2 * moved / max(abs(want), 1e-30))
        for ref in (want, float(p64[k])):
            assert abs(float(parts[k]) - ref) <= tol * abs(ref) + 1e-9, (
                k, float(parts[k]), ref, tol)
    noise = _noise(jg, shifted)
    assert jg.keys() == pg.keys() == g64.keys()
    for k in jg:
        assert noise[k] < 3e-2, (k, noise[k])
        tol = max(1e-4, 2 * noise[k])
        port, port64 = _rel(pg[k], jg[k]), _rel(pg[k], g64[k])
        ref64 = _rel(jg[k], g64[k])
        assert port < tol and port64 < tol, (k, port, port64, tol)
        assert ref64 < max(1e-3, 10 * noise[k]), (k, ref64, noise[k])


def test_resampling_gradient_over_three_levels_takes_either_route():
    """Beside the arbiter: with the key on (kernel 5's plain version on
    levels 0 and 1, its weights cotangent carrying the gradient) the step
    equals the key-off one (plain compositing) at rel 1e-5 and 1e-4 per
    leaf."""
    stop = ["nerf.stop_resample_grad", "False", "nerf.num_levels", "3"]
    key = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    runs = []
    for extra in (stop + KEY5, stop):
        jsys, _, psys = systems(extra)
        runs.append(port_step(psys, jsys.model, key))
    (on_parts, on), (off_parts, off) = runs
    check_parts(on_parts, off_parts)
    for k in off:
        assert _rel(on[k], off[k]) < 1e-4, (k, _rel(on[k], off[k]))


def test_resample_along_rays_gradient_matches_jax():
    """The op alone: the gradient of the resampled frustums' means with
    respect to the weights and fenceposts, against JAX's at
    stop_grad=False, and none with stop_grad."""
    from pano_nerf_tpu.ops import mip as jax_mip
    rng = np.random.default_rng(3)
    o = rng.normal(size=(5, 3)).astype(np.float32)
    d = rng.normal(size=(5, 3)).astype(np.float32)
    r = np.full((5, 1), 0.01, np.float32)
    t = np.sort(rng.uniform(0, 10, (5, 7)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (5, 6)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    coef = rng.normal(size=(5, 4, 3)).astype(np.float32)

    def j_loss(t_, w_):
        _, (m, _) = jax_mip.resample_along_rays(key, o, d, r, t_, w_, True,
                                                False, 0.01, num_samples=4)
        return jnp.sum(coef * jnp.sin(m))

    jt, jw = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(t, w)
    u = _u(key, (5, 5))
    for stop in (False, True):
        pt, pw = T(t).requires_grad_(), T(w).requires_grad_()
        _, (m, _) = mip.resample_along_rays(T(o), T(d), T(r), pt, pw, 0.01,
                                            num_samples=4, u_rand=u,
                                            stop_grad=stop)
        if stop:
            assert not m.requires_grad
            continue
        torch.sum(T(coef) * torch.sin(m)).backward()
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jt),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(pw.grad.numpy(), np.asarray(jw),
                                   rtol=1e-4, atol=1e-5)


def test_pano_render_at_one_level_is_refused_as_jax_fails():
    """At one level there is no fine level: JAX's eval render raises
    reading its roughness (engine/system.py:354); the port's refuses by
    name, while its model renders the one level."""
    jsys, params, psys = systems(LEVELS["1"], on_kernels=False)
    rays_np, _ = _batch(1)
    with pytest.raises(TypeError):
        jsys.make_render_image(enable_surf=True)(params, JaxRays(*rays_np))
    with pytest.raises(NotImplementedError, match=r"nerf\.num_levels"):
        psys.make_render_image(True)
    with torch.no_grad():
        outs = psys.model(rays_to_tensors(rays_np, CPU), psys.env_rays,
                          False, True)
    assert len(outs) == 1 and outs[0].normal is None


def _mip_step(extra):
    """One f32 train step of both mip-NeRF systems with `extra` opts
    (`loss.ort_loss` 0.1: kernel 3 on the last level), JAX's draws
    replayed: (port parts, JAX parts, port grads, JAX grads)."""
    jsys, state, psys = mip_systems("f32", ["loss.ort_loss", "0.1", *extra])
    rays_np, rgbs_np = mip_batch()
    key = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    hp_j = jsys.hparams

    def loss_fn(p):
        outs = jsys.model(p, key, JaxRays(*rays_np),
                          randomized=jsys.train_randomized,
                          white_bkgd=False, use_ort_loss=True)
        parts = jax_losses.mipnerf_losses(
            outs, jnp.asarray(rgbs_np), jnp.asarray(rays_np.lossmult), hp_j)
        return parts["loss"], parts

    (_, j_parts), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params)
    draws = replay(jsys.model, key) if jsys.train_randomized else None
    parts = psys.make_train_step(False)(
        psys.create_state(), rays_to_tensors(rays_np, CPU),
        torch.tensor(rgbs_np), draws)
    grads = _leaves(params_to_jax({n: p.grad for n, p in
                                   psys.model.mlp.named_parameters()}))
    return parts, j_parts, grads, _leaves(jax.tree.map(np.asarray, j_grads))


MIP_CASES = {"levels1": ["nerf.num_levels", "1"],
             "levels3": ["nerf.num_levels", "3"],
             "density_noise": ["nerf.density_noise", "1.0"],
             "levels3-noise": ["nerf.num_levels", "3",
                               "nerf.density_noise", "1.0"]}


@pytest.mark.parametrize("case", sorted(MIP_CASES))
def test_mip_train_step_matches_jax(case, monkeypatch):
    """mip-NeRF's step at one and three levels (the orientation loss on
    the last level, one level: the coarse one), and with
    `nerf.density_noise` on every level's raw density (JAX
    mip_nerf.py:73-75)."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    parts, j_parts, pg, jg = _mip_step(MIP_CASES[case])
    check_parts(parts, j_parts)
    _check_grads(pg, jg)
