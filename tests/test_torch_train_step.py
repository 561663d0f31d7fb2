"""One train step of the port against the JAX package's, on the CPU.

The port's `PanoNeRFSystem.make_train_step` (the plain versions of
kernels 2 and 3 on CPU tensors) and JAX `PanoNeRFSystem.make_train_step`
(its standard XLA path) take the same bridged parameters, the same ray
batch and the same random numbers: JAX draws them inside the step from its
key schedule, and the test replays that schedule to hand them to the port
(`fold_in(key, step)`; `split` into 2 * num_levels + 1, coarse
stratification from keys[0], resampling jitter from keys[2], env
stratification from keys[-1]; `fold_in(step_key, 0x5C)` for the
view-consistency direction). A small model (width 64, 16 rays, 8 + 8
samples, 4 env directions x 4 samples) keeps it fast.

With `nerf.use_train_render_kernel` the port renders the coarse level and
the env queries through kernel 5 (`fused_render_train`, its plain version
here). JAX does so too in bf16, with its Pallas kernel in interpret mode;
in f32 its kernel topology check (bf16 only) sends it down the standard
path, which computes the same function.
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
from pano_nerf_tpu.engine import schedule as jax_schedule
from pano_nerf_tpu.engine.system import PanoNeRFSystem as JaxSystem
from pano_nerf_tpu.ops import mip as jax_mip
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.core.rays import rays_to_tensors
from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
from pano_nerf_tpu_torch.engine import schedule, system as port_system
from pano_nerf_tpu_torch.engine.system import PanoNeRFSystem
from pano_nerf_tpu_torch.models.base import (kernel_build_gaps,
                                             plain_route_reasons)
from pano_nerf_tpu_torch.models.pano_mip_nerf import TrainDraws
from pano_nerf_tpu_torch.ops import mip
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax
import torch_threads  # noqa: F401  (tests/torch_threads.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
B, N, D, S = 16, 8, 4, 4
OPTS = ["nerf.num_samples", str(N), "nerf.num_env_samples", str(S),
        "nerf.num_ray_samples", str(D), "nerf.mlp.net_width", "64",
        "nerf.mlp.net_width_condition", "32"]


def f32_on_the_kernels(psys):
    """Put an f32 system of the kernels' topology on the kernel route, to
    hold that route's wiring (kernels 2-5 as the model calls them) to JAX
    at f32 tolerances. f32 takes the plain route on every device
    (`models/base.py` `plain_route_reasons`, JAX's `_kernel_topology_ok`),
    but on the CPU the kernel route runs the kernels' plain versions,
    which take f32 as well. Only where f32 is the one reason for the
    plain route and the plain versions take the model; returns `psys`."""
    cfg = psys.model.cfg
    if (plain_route_reasons(cfg) == ["train.precision f32"]
            and not kernel_build_gaps(cfg, torch.device("cpu"))):
        psys.model.kernels = True
    return psys


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    ones = np.ones((B, 1), np.float32)
    rays = JaxRays(
        origins=rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32),
        directions=d,
        viewdirs=(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32),
        radii=ones * 0.01, lossmult=ones, near=ones * 0.0, far=ones * 10.0,
        noise_var=ones * 0.0)
    rgbs = rng.uniform(0.0, 3.0, (B, 3)).astype(np.float32)
    return rays, rgbs


def _draws(key, step):
    """Replay the JAX step's key schedule (system.py:243,
    pano_mip_nerf.py:310-311 and :457-459, mip.py:111-119 and :209-214)."""
    step_key = jax.random.fold_in(key, step)
    keys = jax.random.split(step_key, 5)
    u = lambda k, shape: np.asarray(jax.random.uniform(k, shape))
    return TrainDraws(
        t_coarse=torch.tensor(u(keys[0], (B, N + 1))),
        u_fine=torch.tensor(u(keys[2], (B, N + 1))),
        t_env=torch.tensor(u(keys[4], (B, D, S + 1))),
        d_alt=torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(step_key, 0x5C), (B, 3)))))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


KERNEL5 = ["nerf.use_train_render_kernel", "True"]


def _run_both(precision, extra=()):
    opts = OPTS + ["train.precision", f"'{precision}'", *extra]
    jhp = jax_load_config(CONFIG, opts)
    jsys = JaxSystem(jhp)
    jsys.set_env_rays(jax_lit(num=D, far=10.0))
    state = jsys.create_state(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, state.params)
    rays_np, rgbs_np = _batch()
    key = jax.random.PRNGKey(7)
    hp_j = jsys.hparams

    def loss_fn(p):
        outs = jsys.model(p, jax.random.fold_in(key, 0), JaxRays(*rays_np),
                          jsys.env_rays, randomized=True, white_bkgd=False,
                          enable_surf=True, use_ort_loss=True,
                          use_vc_loss=True)
        parts = jax_losses.pano_losses(outs, jnp.asarray(rgbs_np),
                                       jnp.asarray(rays_np.lossmult), hp_j,
                                       True, step=jnp.int32(0))
        return parts["loss"], parts

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, j_parts), j_grads = grad_fn(state.params)
    new_state, _ = jsys.make_train_step(True)(
        state, (JaxRays(*rays_np), jnp.asarray(rgbs_np)), key)
    j_new = jax.tree.map(np.asarray, new_state.params)

    hp = load_config(CONFIG, opts)
    psys = f32_on_the_kernels(PanoNeRFSystem(hp, device="cpu"))
    psys.model.mlp.load_state_dict(params_from_jax(params0))
    psys.set_env_rays(generate_lit_rays(D, 0.0, 10.0))
    pstate = psys.create_state()
    step = psys.make_train_step(True)
    parts = step(pstate, rays_to_tensors(rays_np, torch.device("cpu")),
                 torch.tensor(rgbs_np), _draws(key, 0))
    grads = params_to_jax({n: p.grad for n, p in
                           psys.model.mlp.named_parameters()})
    new = params_to_jax(psys.model.mlp.state_dict())
    return (j_parts, jax.tree.map(np.asarray, j_grads), j_new, parts, grads,
            new, hp_j)


def _leaves(tree):
    inner = tree.get("params", tree)
    return {f"{m}/{k}": np.asarray(v) for m, leaves in inner.items()
            for k, v in leaves.items()}


def test_train_step_matches_jax_in_f32():
    _check_f32(*_run_both("f32"))


def _check_f32(j_parts, j_grads, j_new, parts, grads, new, hp):
    names = ("loss", "vol_coarse", "vol_fine", "vol_surface", "chrom",
             "ort", "dist", "sat", "vc")
    assert set(names) <= set(parts)
    for k in names:
        want, got = float(j_parts[k]), float(parts[k])
        assert abs(got - want) <= 1e-5 * abs(want) + 1e-9, (k, got, want)
    jg, pg = _leaves(j_grads), _leaves(grads)
    assert jg.keys() == pg.keys()
    norm = np.sqrt(sum(np.sum(g ** 2) for g in jg.values()))
    assert norm < hp["optimizer.grad_clip"]  # the clip's scale is 1.0
    for k in jg:
        assert _rel(pg[k], jg[k]) < 1e-4, k
    lr = schedule.mip_lr_decay(1e-3, 5e-6, 44000, 120, 0.01)(0)
    jn, pn = _leaves(j_new), _leaves(new)
    for k in jn:
        assert float(np.abs(pn[k] - jn[k]).max()) <= 0.1 * lr, k


def test_train_step_tracks_jax_in_bf16():
    """bf16 rounds at other places in the two: the JAX plain path rounds
    every dense output (bias included) to bf16, the port's plain versions
    round matmul operands only, as the kernels do. So the step is held
    loosely: loss parts within 3% and gradients within 10% (rel-norm per
    leaf), which still catches any term or wiring that is off."""
    _check_bf16(*_run_both("bf16"))


def _check_bf16(j_parts, j_grads, _, parts, grads, *rest):
    for k in ("loss", "vol_coarse", "vol_fine", "vol_surface", "vc"):
        want, got = float(j_parts[k]), float(parts[k])
        assert abs(got - want) <= 3e-2 * abs(want), (k, got, want)
    jg, pg = _leaves(j_grads), _leaves(grads)
    for k in jg:
        assert _rel(pg[k], jg[k]) < 0.1, k


def test_train_render_kernel_step_matches_jax_in_f32():
    _check_f32(*_run_both("f32", KERNEL5))


def test_train_render_kernel_step_tracks_jax_in_bf16(monkeypatch):
    """Both through kernel 5 (JAX's Pallas kernel in interpret mode), held
    as `test_train_step_tracks_jax_in_bf16` holds the standard step."""
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")
    _check_bf16(*_run_both("bf16", KERNEL5))


def _port_step(extra, scope="all"):
    """One f32 port step on the test batch; returns (loss parts, grads)."""
    import dataclasses
    hp = load_config(CONFIG, OPTS + ["train.precision", "'f32'", *extra])
    psys = f32_on_the_kernels(PanoNeRFSystem(hp, device="cpu"))
    model = psys.model
    model.cfg = dataclasses.replace(model.cfg, train_kernel_scope=scope)
    psys.set_env_rays(generate_lit_rays(D, 0.0, 10.0))
    rays_np, rgbs_np = _batch()
    parts = psys.make_train_step(True)(
        psys.create_state(), rays_to_tensors(rays_np, torch.device("cpu")),
        torch.tensor(rgbs_np), _draws(jax.random.PRNGKey(7), 0))
    return parts, {n: p.grad.numpy() for n, p in model.mlp.named_parameters()}


@pytest.mark.parametrize("scope", ["all", "coarse", "env"])
def test_train_render_kernel_on_equals_off_in_f32(scope, monkeypatch):
    """Kernel 5 computes the function of the standard path's coarse level
    and env queries, so in f32 the step's loss parts and gradients agree
    under each `train_kernel_scope`; and kernel 5's plain version ran once
    for each subgraph the scope selects."""
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    calls = []
    plain = k5.fused_render_train_reference

    def counted(mlp, means, *a, **k):
        calls.append(tuple(means.shape))
        return plain(mlp, means, *a, **k)

    monkeypatch.setattr(k5, "fused_render_train_reference", counted)
    off_parts, off_grads = _port_step([])
    assert calls == []
    on_parts, on_grads = _port_step(KERNEL5, scope)
    assert calls == dict(all=[(B, N, 3), (B * D, S, 3)], coarse=[(B, N, 3)],
                         env=[(B * D, S, 3)])[scope]
    for k, v in off_parts.items():
        want, got = float(v), float(on_parts[k])
        assert abs(got - want) <= 1e-5 * abs(want) + 1e-9, (k, got, want)
    for n, g in off_grads.items():
        assert _rel(on_grads[n], g) < 1e-4, n


def test_fused_mlp_apply_takes_five_density_channels_on_the_card():
    from pano_nerf_tpu_torch.kernels import fused_mlp as k1
    from pano_nerf_tpu_torch.models.mlp import NerfMLP
    k1.check_kernel_support(NerfMLP(96, 27, num_density_channels=5),
                            torch.device("cuda"))
    six = NerfMLP(96, 27, num_density_channels=6)
    k1.check_kernel_support(six, torch.device("cpu"))
    with pytest.raises(ValueError, match="num_density_channels"):
        k1.check_kernel_support(six, torch.device("cuda"))


def test_clip_scale_is_exactly_one_under_the_bound():
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.tensor([0.1, -0.2, 0.3])
    before = p.grad.clone()
    norm = port_system.clip_by_global_norm_([p], 4.0)
    assert torch.equal(p.grad, before)
    assert float(norm) == pytest.approx(float(torch.linalg.norm(before)))
    p.grad = torch.tensor([30.0, 40.0, 0.0])
    port_system.clip_by_global_norm_([p], 4.0)
    assert torch.allclose(p.grad, torch.tensor([2.4, 3.2, 0.0]))


@pytest.mark.parametrize("step", [0, 60, 120, 44000])
def test_mip_lr_decay_matches_jax(step):
    args = (1e-3, 5e-6, 44000, 120, 0.01)
    want = float(jax_schedule.mip_lr_decay(*args)(step))
    assert schedule.mip_lr_decay(*args)(step) == pytest.approx(want,
                                                               rel=1e-6)


def test_distortion_loss_matches_jax_and_has_finite_grads_at_zero():
    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0, 10, (5, 9)), -1).astype(np.float32)
    w = rng.uniform(0, 0.3, (5, 8)).astype(np.float32)
    want = float(jax_mip.distortion_loss(jnp.asarray(t), jnp.asarray(w)))
    got = float(mip.distortion_loss(torch.tensor(t), torch.tensor(w)))
    assert got == pytest.approx(want, rel=1e-6)
    wz = torch.zeros(5, 8, requires_grad=True)
    mip.distortion_loss(torch.tensor(t), wz).backward()
    assert torch.isfinite(wz.grad).all()


def test_safe_normalize_grad_is_finite_at_zero():
    x = torch.zeros(4, 3, requires_grad=True)
    y = mip.safe_normalize(x)
    (y * torch.arange(12.0).reshape(4, 3)).sum().backward()
    assert torch.equal(y, torch.zeros(4, 3))
    assert torch.isfinite(x.grad).all()


def test_randomized_sampling_matches_jax():
    rng = np.random.default_rng(5)
    o = rng.normal(size=(6, 3)).astype(np.float32)
    d = rng.normal(size=(6, 3)).astype(np.float32)
    r = np.full((6, 1), 0.01, np.float32)
    near, far = np.zeros((6, 1), np.float32), np.full((6, 1), 10.0,
                                                       np.float32)
    key = jax.random.PRNGKey(11)
    jt, (jm, jc) = jax_mip.sample_along_rays(key, o, d, r, 7, near, far,
                                             True)
    t_rand = torch.tensor(np.asarray(jax.random.uniform(key, (6, 8))))
    T = torch.tensor
    pt, (pm, pc) = mip.sample_along_rays(T(o), T(d), T(r), 7, T(near),
                                         T(far), t_rand=t_rand)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)
    w = rng.uniform(0, 1, (6, 7)).astype(np.float32)
    k2 = jax.random.PRNGKey(12)
    jt2, _ = jax_mip.resample_along_rays(k2, o, d, r, jt, w, True, True,
                                         0.01, num_samples=7)
    u = torch.tensor(np.asarray(jax.random.uniform(k2, (6, 8))))
    pt2, _ = mip.resample_along_rays(T(o), T(d), T(r), pt, T(w), 0.01,
                                     num_samples=7, u_rand=u)
    np.testing.assert_allclose(pt2.numpy(), np.asarray(jt2), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("key,value", [("parallel.num_devices", 4)])
def test_unsupported_train_keys_raise_naming_the_key(key, value):
    hp = load_config(CONFIG, OPTS)
    hp[key] = value
    psys = PanoNeRFSystem(hp, device="cpu")
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        psys.make_train_step(True)


@pytest.mark.parametrize("key,value", [
    ("nerf.env_distill_samples", 4), ("loss.env_distill", 0.1),
    ("loss.chrom_gate", True), ("loss.chrom_illum_comp", True),
    ("nerf.point_normals", True), ("loss.illum_distill", 0.1),
    ("loss.scale_distill", 0.1), ("loss.scale_distill_dist", 0.1),
    ("loss.vc_chroma", 0.1), ("loss.vc_sat_mask", True),
    ("train.randomized", False)])
def test_preset_train_keys_are_accepted(key, value):
    """The keys of the HDR presets' train path, of point normals, the
    illum distill, the last loss terms and the deterministic step,
    refused until the port had them (tests/test_torch_presets.py,
    test_torch_point_normals.py, test_torch_illum.py,
    test_torch_loss_switches.py and test_torch_key_switches.py hold
    their steps to JAX's)."""
    hp = load_config(CONFIG, OPTS)
    hp[key] = value
    psys = PanoNeRFSystem(hp, device="cpu")
    psys.set_env_rays(generate_lit_rays(D, 0.0, 10.0))
    psys.make_train_step(True)


def test_loss_terms_match_jax_off_the_healthy_range():
    """Saturation guard engaged (predictions past 2x the knee) and the
    chromaticity prior, on random tensors."""
    from pano_nerf_tpu_torch.engine import losses
    rng = np.random.default_rng(9)
    pred = rng.uniform(0, 30, (32, 3)).astype(np.float32)
    gt = rng.uniform(0, 12, (32, 3)).astype(np.float32)
    mask = np.ones((32, 1), np.float32)
    ldr_j = jax_losses.hdr_to_ldr(jnp.asarray(gt), quantize=True)
    ldr_p = losses.hdr_to_ldr(torch.tensor(gt), quantize=True)
    np.testing.assert_allclose(ldr_p.numpy(), np.asarray(ldr_j), atol=1e-6)
    want = float(jax_losses.saturation_loss(jnp.asarray(pred), ldr_j,
                                            jnp.asarray(mask), margin=2.0))
    got = float(losses.saturation_loss(torch.tensor(pred), ldr_p,
                                       torch.tensor(mask), margin=2.0))
    assert want > 0 and got == pytest.approx(want, rel=1e-6)
    alb = rng.uniform(0.03, 0.8, (32, 3)).astype(np.float32)
    want = float(jax_losses.chromaticity_loss(ldr_j, jnp.asarray(alb)))
    got = float(losses.chromaticity_loss(ldr_p, torch.tensor(alb)))
    assert got == pytest.approx(want, rel=1e-6)
