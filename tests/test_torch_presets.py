"""The HDR presets (`configs/panonerf_hdr.yaml`, `panonerf_shadow.yaml`)
of the port against the JAX package, on the CPU.

The presets add to `configs/panonerf.yaml` the tight-scale re-read of the
env march (`nerf.env_tight_rgb`, here with `nerf.env_tight_chroma`), the
illuminant-compensated chromaticity prior (`loss.chrom_illum_comp`) and,
for the shadow preset, the env-distill re-march (`nerf.env_distill_samples`)
with its trapezoid-scheduled tie (`loss.env_distill*`). A small model
(width 64, 16 rays, 8 + 8 samples, 4 env directions x 4 samples, 6
distill samples) takes bridged parameters and the same random numbers:
JAX draws them inside its forward, the test replays its key schedule
(tests/test_torch_train_step.py `_draws`, plus `fold_in(step_key, 0xED)`
-> `split` -> the distill direction by `randint` and its stratification).

- `sample_env_rays_hemisphere` given the same uniforms;
- the `__post_init__` checks of the tight re-read's variants;
- each tight-read variant (full S, top1, topk, tight weights, with and
  without the chroma combine) at the model level, outputs and gradients;
- the new loss terms and the env-distill trapezoid;
- one train step of each preset in f32 (loss parts rel 1e-5, gradients
  rel-norm 1e-4 per leaf, or twice JAX's own change under 1e-6 shifts
  of the ray origins where the tight scale lifts f32 rounding above
  that: `_check_grads`), the shadow preset inside its fall window (the
  same at `nerf.env_tight_rgb 1`, with no allowance:
  tests/test_torch_tight1.py);
- the preset eval render in f32 (atol 1e-4) against JAX's standard path,
  and in bf16 against JAX's kernel route (Pallas in interpret mode).

`PYTHONPATH=. python tests/test_torch_presets.py` prints, for every gradient case,
each leaf's distance to JAX beside JAX's own change under the shifts.
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
from pano_nerf_tpu.models import build_model as jax_build_model
from pano_nerf_tpu.models.base import LevelOutput as JaxLevelOutput
from pano_nerf_tpu.ops import mip as jax_mip
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.core.rays import rays_to_tensors
from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
from pano_nerf_tpu_torch.engine import losses
from pano_nerf_tpu_torch.engine.system import PanoNeRFSystem, build_system
from pano_nerf_tpu_torch.models import build_model
from pano_nerf_tpu_torch.models.base import LevelOutput
from pano_nerf_tpu_torch.models.pano_mip_nerf import TrainDraws
from pano_nerf_tpu_torch.ops import mip
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax

from test_torch_train_step import (B, D, N, OPTS, S, _batch, _leaves, _rel,
                                   f32_on_the_kernels)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HDR = os.path.join(REPO, "configs", "panonerf_hdr.yaml")
SHADOW = os.path.join(REPO, "configs", "panonerf_shadow.yaml")
S_ED = 6
# The HDR preset keeps its 0 distill samples.
PRESET_OPTS = {HDR: OPTS,
               SHADOW: OPTS + ["nerf.env_distill_samples", str(S_ED)]}


def _draws(model_key, distill):
    """The port's draws of a JAX forward given `model_key` (its key
    schedule replayed: pano_mip_nerf.py:310-311, :457-459 and, for the
    distill pair, :707-721)."""
    keys = jax.random.split(model_key, 5)
    u = lambda k, shape: torch.tensor(np.asarray(jax.random.uniform(k,
                                                                    shape)))
    draws = TrainDraws(
        t_coarse=u(keys[0], (B, N + 1)), u_fine=u(keys[2], (B, N + 1)),
        t_env=u(keys[4], (B, D, S + 1)),
        d_alt=torch.tensor(np.asarray(jax.random.normal(
            jax.random.fold_in(model_key, 0x5C), (B, 3)))))
    if not distill:
        return draws
    k_sel, k_mar = jax.random.split(jax.random.fold_in(model_key, 0xED))
    return draws._replace(
        ed_idx=torch.tensor(np.asarray(jax.random.randint(
            k_sel, (B, 1), 0, D)), dtype=torch.int64),
        t_ed=torch.tensor(np.asarray(jax.random.uniform(
            k_mar, (B, 1, S_ED + 1)))))


def _systems(config, precision, extra=()):
    opts = PRESET_OPTS[config] + ["train.precision", f"'{precision}'",
                                  *extra]
    jsys = JaxSystem(jax_load_config(config, opts))
    jsys.set_env_rays(jax_lit(num=D, far=10.0))
    params = jax.tree.map(np.asarray,
                          jsys.model.init(jax.random.PRNGKey(0)))
    psys = f32_on_the_kernels(build_system(load_config(config, opts),
                                           device="cpu"))
    assert isinstance(psys, PanoNeRFSystem)
    psys.model.mlp.load_state_dict(params_from_jax(params))
    psys.set_env_rays(generate_lit_rays(D, 0.0, 10.0))
    return jsys, params, psys


SHIFTS = 3
# The largest of JAX's own per-leaf changes under the shifts, over every
# case at the presets' scale, is 9.13e-3 (the shadow step in its fall
# window, `PYTHONPATH=. python tests/test_torch_presets.py`); a larger
# change would make the allowance too loose to mean anything.
NOISE_CAP = 1e-2


def _shifted(rays_np, seed):
    """The rays with their origins moved by 1e-6 in a random direction."""
    d = np.random.default_rng(seed).normal(size=rays_np.origins.shape)
    d *= 1e-6 / np.linalg.norm(d, axis=-1, keepdims=True)
    return JaxRays(*rays_np._replace(
        origins=(rays_np.origins + d).astype(np.float32)))


def _noise(jg, jg_shifted):
    """JAX's own largest rel-norm change per leaf under the shifts."""
    return {k: max((_rel(j[k], jg[k]) for j in jg_shifted), default=0.0)
            for k in jg}


def _check_grads(pg, jg, jg_shifted=()):
    """The port's gradient against JAX's, rel-norm per leaf: within 1e-4,
    or, given the gradients of `SHIFTS` rays whose origins moved by 1e-6,
    within twice JAX's own largest change among them.

    The tight re-read evaluates the IPE at covariances x 0.01, where the
    degrees up to ~13 survive near the surface point: a phase there is
    2^13 x a coordinate of the point, so the point's f32 rounding (the
    frameworks' fine-level distances differ by ~1e-6, from the order of
    their sums) moves the trunk's gradients by 1e-4 to 1e-2 in either
    framework. At env_tight_rgb 1 the cases pass no shifted references
    and hold every leaf at 1e-4."""
    assert jg.keys() == pg.keys()
    noise = _noise(jg, jg_shifted)
    for k in jg:
        assert noise[k] < NOISE_CAP, (k, noise[k])
        got, tol = _rel(pg[k], jg[k]), max(1e-4, 2 * noise[k])
        assert got < tol, (k, got, tol)


def test_sample_env_rays_hemisphere_matches_jax():
    rng = np.random.default_rng(2)
    o = rng.normal(size=(5, 3)).astype(np.float32)
    d = rng.normal(size=(5, 3, 3)).astype(np.float32)
    near = np.full((3, 1), 0.0, np.float32)
    far = np.array([[10.0], [8.0], [6.0]], np.float32)
    radii = np.array([[0.01], [0.02], [0.03]], np.float32)
    key = jax.random.PRNGKey(4)
    jt, (jm, jc), jd = jax_mip.sample_env_rays_hemisphere(
        key, o, d, 7, near, far, radii, True)
    t_rand = torch.tensor(np.asarray(jax.random.uniform(key, (5, 3, 8))))
    T = torch.tensor
    pt, (pm, pc), pd = mip.sample_env_rays_hemisphere(
        T(o), T(d), 7, T(near), T(far), T(radii), t_rand=t_rand)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    jt0, _, _ = jax_mip.sample_env_rays_hemisphere(
        key, o, d, 7, near, far, radii, False)
    pt0, _, _ = mip.sample_env_rays_hemisphere(T(o), T(d), 7, T(near),
                                               T(far), T(radii))
    np.testing.assert_allclose(pt0.numpy(), np.asarray(jt0), rtol=1e-6)


@pytest.mark.parametrize("bad", [
    {"nerf.env_tight_chroma": True},
    {"nerf.env_tight_rgb": 0.01, "nerf.env_tight_top1": True},
    {"nerf.env_tight_rgb": 0.01, "nerf.env_tight_topk": 2},
    {"nerf.env_tight_rgb": 0.01, "nerf.env_tight_chroma": True,
     "nerf.env_tight_topk": 2, "nerf.env_tight_top1": True},
    {"nerf.env_tight_weights": True},
    {"nerf.env_tight_rgb": 0.01, "nerf.env_tight_chroma": True,
     "nerf.env_tight_weights": True}], ids=lambda d: "+".join(
         k.split("_", 2)[-1] for k in d))
def test_tight_read_checks_raise_value_error_as_in_jax(bad):
    hp = dict(load_config(os.path.join(REPO, "configs", "panonerf.yaml")),
              **bad)
    with pytest.raises(ValueError):
        jax_build_model(hp)
    with pytest.raises(ValueError, match="env_tight"):
        build_model(hp)


def test_env_resample_stays_refused_beside_the_tight_read():
    """Accepted since the port has env_resample: beside the HDR preset's
    tight re-read, JAX skips the re-read and marches a second time
    (pano_mip_nerf.py:593, :675), and so does the port; held to JAX
    here on one f32 step at the preset's scale (as `_check_grads`).
    Beside env_tight_weights it is refused with a ValueError, as in
    JAX."""
    from test_torch_env_modes import step_both
    parts, j_parts, pg, jg, psys = step_both(
        ["nerf.env_resample", "True", "nerf.env_tight_rgb", "0.01",
         "nerf.env_tight_chroma", "True"])
    assert psys.model.cfg.env_resample and psys.model.cfg.env_tight_rgb
    for k in j_parts:
        want, got = float(j_parts[k]), float(parts[k])
        assert abs(got - want) <= 1e-5 * abs(want) + 1e-9, (k, got, want)
    _check_grads(pg, jg)
    hp = dict(load_config(HDR), **{"nerf.env_resample": True,
                                   "nerf.env_tight_chroma": False,
                                   "nerf.env_tight_weights": True})
    with pytest.raises(ValueError):
        jax_build_model(hp)
    with pytest.raises(ValueError, match="env_resample"):
        build_model(hp)


def test_presets_build_without_refusal():
    for config in (HDR, SHADOW):
        system = build_system(load_config(config), device="cpu")
        cfg = system.model.cfg
        assert cfg.env_tight_rgb == 0.01 and cfg.env_tight_chroma
        system.set_env_rays(generate_lit_rays(10, 0.0, 10.0))
        system.make_train_step(True)
    assert build_system(load_config(SHADOW), device="cpu"
                        ).model.cfg.env_distill_samples == 16


VARIANTS = {
    "full": ["nerf.env_tight_chroma", "False"],
    "full_chroma": [],
    "top1": ["nerf.env_tight_top1", "True"],
    "topk": ["nerf.env_tight_topk", "2"],
    "weights": ["nerf.env_tight_chroma", "False",
                "nerf.env_tight_weights", "True"],
}
VARIANT_OUTS = ("surf_rgb", "shading", "env_read", "env_fine",
                "env_read_acc", "env_fine_acc", "env_read_dist",
                "env_fine_dist")
# The presets' tight scale, and 1, where the tight read's f32 rounding is
# damped and the gradients are held at 1e-4 with no allowance.
TIGHT = {"preset": [], "tight1": ["nerf.env_tight_rgb", "1.0"]}


def _variant_run(variant, tight, shifts):
    """The randomized forward of the shadow preset's model with `variant`
    of the tight re-read in both frameworks, and the gradient of a loss
    on its surface radiance and env read: (port outputs, JAX outputs,
    port grads, JAX grads, JAX grads of `shifts` shifted rays)."""
    jsys, params, psys = _systems(SHADOW, "f32",
                                  VARIANTS[variant] + TIGHT[tight])
    rays_np, _ = _batch()
    key = jax.random.PRNGKey(3)

    def j_loss(p, rays):
        fine = jsys.model(p, key, rays, jsys.env_rays, randomized=True,
                          white_bkgd=False, enable_surf=True,
                          use_ort_loss=False)[-1]
        outs = {k: getattr(fine, k) for k in VARIANT_OUTS}
        return (jnp.sum(jnp.sin(outs["surf_rgb"]))
                + jnp.sum(jnp.cos(outs["env_read"]))), outs

    grad_fn = jax.jit(jax.value_and_grad(j_loss, has_aux=True))
    (_, want), j_grads = grad_fn(params, JaxRays(*rays_np))
    j_shifted = [_leaves(jax.tree.map(np.asarray, grad_fn(
        params, _shifted(rays_np, i))[1])) for i in range(shifts)]
    fine = psys.model.train_forward(
        rays_to_tensors(rays_np, torch.device("cpu")), psys.env_rays,
        _draws(key, True), False, True, False, False)[-1]
    (torch.sum(torch.sin(fine.surf_rgb))
     + torch.sum(torch.cos(fine.env_read))).backward()
    return (fine, want, _grads(psys),
            _leaves(jax.tree.map(np.asarray, j_grads)), j_shifted)


def _grads(psys):
    return _leaves(params_to_jax({n: p.grad for n, p in
                                  psys.model.mlp.named_parameters()}))


def check_variant(variant, tight):
    """Outputs at rtol 1e-4; gradients by `_check_grads`, with the
    shifted references at the presets' scale and none at `tight1`."""
    fine, want, pg, jg, j_shifted = _variant_run(
        variant, tight, SHIFTS if tight == "preset" else 0)
    for k in VARIANT_OUTS:
        np.testing.assert_allclose(getattr(fine, k).detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    _check_grads(pg, jg, j_shifted)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tight_read_variant_matches_jax(variant):
    """The randomized forward of the shadow preset's model with each
    variant of the tight re-read: the surface products that carry the
    env read, the distill pair, and the gradient of a loss on them
    (at env_tight_rgb 1: tests/test_torch_tight1.py)."""
    check_variant(variant, "preset")


def _levels(rng, cls, T, distill=True):
    f = lambda *s: T(rng.uniform(0.0, 3.0, s).astype(np.float32))
    coarse = cls(rgb=f(B, 3), distance=None, acc=None,
                 dist_loss=T(np.float32(0.3)))
    fine = cls(rgb=f(B, 3), distance=None, acc=None, albedo=f(B, 3) / 3,
               surf_rgb=f(B, 3), shading=f(B, 3) * 2,
               ort_loss=T(np.float32(0.21)), dist_loss=T(np.float32(0.4)),
               rgb_alt=f(B, 3),
               **(dict(env_read=f(B, 3), env_fine=f(B, 3),
                       env_read_acc=f(B) / 3, env_fine_acc=f(B) / 3,
                       env_read_dist=f(B), env_fine_dist=f(B))
                  if distill else {}))
    return [coarse, fine]


SCHEDULE = {"loss.env_distill": 0.1, "loss.env_distill_acc": 0.2,
            "loss.env_distill_dist": 0.3, "loss.env_distill_start": 0.1,
            "loss.env_distill_ramp": 0.1, "loss.env_distill_end": 0.7,
            "loss.env_distill_fall": 0.15, "loss.ort_tie_boost": 3.0,
            "optimizer.max_steps": 1000}


@pytest.mark.parametrize("step,sched", [
    (0, 0.0), (100, 0.0), (150, 0.5), (700, 1.0), (775, 0.5),
    (1000, 0.0)])
@pytest.mark.parametrize("extra", [
    {}, {"loss.chrom_gate": True}, {"loss.chrom_illum_comp": True},
    {"loss.chrom_gate": True, "loss.chrom_illum_comp": True,
     "loss.chrom_gate_sigma": 0.5, "loss.chrom_illum_floor": 0.3}],
    ids=["plain", "gate", "comp", "gate+comp"])
def test_preset_loss_terms_and_schedule_match_jax(step, sched, extra):
    """Every loss part, the trapezoid (0 before start, ramp, 1, fall to
    0) and the orientation weight riding it (loss.ort_tie_boost), at
    steps 0, start, mid-ramp, end, mid-fall and max."""
    hp = losses.prepare_hparams(dict(
        load_config(os.path.join(REPO, "configs", "panonerf.yaml")),
        **SCHEDULE, **extra))
    rng = np.random.default_rng(step)
    gt = rng.uniform(0.0, 12.0, (B, 3)).astype(np.float32)
    mask = (rng.uniform(size=(B, 1)) > 0.2).astype(np.float32)
    j_outs = _levels(np.random.default_rng(1), JaxLevelOutput, jnp.asarray)
    p_outs = _levels(np.random.default_rng(1), LevelOutput, torch.tensor)
    want = jax_losses.pano_losses(j_outs, jnp.asarray(gt), jnp.asarray(mask),
                                  hp, True, step=jnp.int32(step))
    got = losses.pano_losses(p_outs, torch.tensor(gt), torch.tensor(mask),
                             hp, True, step=torch.tensor(step))
    assert {k for k, v in got.items() if v is not None} == {
        k for k, v in want.items() if v is not None}
    for k, v in want.items():
        if v is not None:
            assert float(got[k]) == pytest.approx(float(v), rel=1e-5), k
    assert float(losses.env_distill_schedule(hp, torch.tensor(step))
                 ) == pytest.approx(sched, abs=1e-6)


def test_env_distill_schedule_refusals():
    hp = {"loss.env_distill": 0.1, "loss.env_distill_fall": 0.1,
          "optimizer.max_steps": 100}
    with pytest.raises(ValueError, match="env_distill_end"):
        losses.env_distill_schedule(hp, torch.tensor(0))
    with pytest.raises(ValueError, match="env_distill_end"):
        jax_losses.pano_losses(
            _levels(np.random.default_rng(0), JaxLevelOutput, jnp.asarray),
            jnp.ones((B, 3)), jnp.ones((B, 1)),
            dict(losses.prepare_hparams(load_config(HDR)), **hp), True,
            step=jnp.int32(0))
    hp = dict(hp, **{"loss.env_distill_end": 0.5})
    with pytest.raises(ValueError, match="no `step`"):
        losses.env_distill_schedule(hp, None)
    assert losses.env_distill_schedule({"loss.env_distill": 0.1}, None
                                       ) is None
    assert losses.env_distill_schedule(dict(hp, **{
        "loss.env_distill": 0.0}), None) is None


# One step in the shadow preset's fall window (0.7 to 0.85 of the
# shipped 44,000 steps), where the trapezoid is 0.5.
MID_FALL = 34100


def _step_run(config, step, tight, shifts):
    """One f32 train step of `config` at `step` in both frameworks:
    (port loss parts, JAX loss parts, port grads, JAX grads, JAX grads
    of `shifts` shifted rays)."""
    jsys, params, psys = _systems(config, "f32", TIGHT[tight])
    rays_np, rgbs_np = _batch()
    key = jax.random.PRNGKey(7)
    hp_j = jsys.hparams

    def loss_fn(p, rays):
        outs = jsys.model(p, jax.random.fold_in(key, step), rays,
                          jsys.env_rays, randomized=True, white_bkgd=False,
                          enable_surf=True, use_ort_loss=True,
                          use_vc_loss=True)
        parts = jax_losses.pano_losses(outs, jnp.asarray(rgbs_np),
                                       jnp.asarray(rays_np.lossmult), hp_j,
                                       True, step=jnp.int32(step))
        return parts["loss"], parts

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, j_parts), j_grads = grad_fn(params, JaxRays(*rays_np))
    j_shifted = [_leaves(jax.tree.map(np.asarray, grad_fn(
        params, _shifted(rays_np, i))[1])) for i in range(shifts)]
    state = psys.create_state()
    state.step = step
    parts = psys.make_train_step(True)(
        state, rays_to_tensors(rays_np, torch.device("cpu")),
        torch.tensor(rgbs_np), _draws(jax.random.fold_in(key, step),
                                      config == SHADOW))
    return (parts, j_parts, _grads(psys),
            _leaves(jax.tree.map(np.asarray, j_grads)), j_shifted)


def check_step(config, step, tight):
    """Loss parts at rel 1e-5; gradients by `_check_grads`, with the
    shifted references at the presets' scale and none at `tight1`."""
    parts, j_parts, pg, jg, j_shifted = _step_run(
        config, step, tight, SHIFTS if tight == "preset" else 0)
    names = {"loss", "vol_coarse", "vol_fine", "vol_surface", "chrom",
             "ort", "dist", "sat", "vc"} | ({"env_distill"}
                                            if config == SHADOW else set())
    assert set(parts) == names
    for k in names:
        want, got = float(j_parts[k]), float(parts[k])
        assert abs(got - want) <= 1e-5 * abs(want) + 1e-9, (k, got, want)
    _check_grads(pg, jg, j_shifted)


STEP_CASES = {"hdr": (HDR, 0), "shadow": (SHADOW, 0),
              "shadow-mid-fall": (SHADOW, MID_FALL)}


@pytest.mark.parametrize("config,step", list(STEP_CASES.values()),
                         ids=list(STEP_CASES))
def test_preset_train_step_matches_jax_in_f32(config, step):
    check_step(config, step, "preset")


def _render_both(config, precision):
    jsys, params, psys = _systems(config, precision,
                                  ["val.chunk_size", "8"])
    rays_np, _ = _batch(1)
    want = jsys.make_render_image(enable_surf=True)(params,
                                                    JaxRays(*rays_np))
    got = psys.make_render_image(True)(None, rays_to_tensors(
        rays_np, torch.device("cpu")))
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("config", [HDR, SHADOW], ids=["hdr", "shadow"])
def test_preset_render_matches_jax_in_f32(monkeypatch, config):
    """The eval route of kernels 2 and 3 with the tight re-read (its
    plain versions here) against JAX's first-order standard path."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    got, want = _render_both(config, "f32")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_preset_render_tracks_jax_kernel_route_in_bf16(monkeypatch):
    """JAX through kernels 2 and 3 (Pallas, interpret mode), the port
    through their plain versions, in bf16: the kernel tolerances of
    tests/test_torch_render.py (normals within 0.85 in cosine, the
    surface products where the normals agree)."""
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")
    got, want = _render_both(HDR, "bf16")
    for k in ("rgb_coarse", "dep_coarse", "rgb_fine", "dep_fine", "albedo",
              "roughness"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-2, err_msg=k)
    cos = np.sum(got["normal"] * want["normal"], -1)
    assert np.median(cos) > 0.998 and cos.min() > 0.85, np.sort(cos)
    ok = cos > 0.99
    assert ok.mean() > 0.8
    for k in ("surf_rgb", "shading"):
        np.testing.assert_allclose(got[k][ok], want[k][ok], rtol=0.1,
                                   atol=3e-2, err_msg=k)


if __name__ == "__main__":
    # Every gradient case: each leaf's rel-norm distance to JAX and JAX's
    # own largest change under the shifts (measured at both scales).
    # Run from the repo root: PYTHONPATH=. python tests/test_torch_presets.py
    runs = [(f"variant {v} {t}", lambda v=v, t=t: _variant_run(v, t, SHIFTS))
            for t in sorted(TIGHT) for v in sorted(VARIANTS)]
    runs += [(f"step {c} {t}", lambda c=c, t=t: _step_run(*STEP_CASES[c], t,
                                                          SHIFTS))
             for t in sorted(TIGHT) for c in STEP_CASES]
    for name, run in runs:
        _, _, pg, jg, j_shifted = run()
        noise = _noise(jg, j_shifted)
        dist = {k: _rel(pg[k], jg[k]) for k in jg}
        over = [k for k in jg if dist[k] >= 1e-4]
        print(f"{name}: {len(over)} of {len(jg)} leaves at >= 1e-4; "
              f"max distance {max(dist.values()):.3e}, max noise "
              f"{max(noise.values()):.3e}")
        for k in sorted(jg):
            print(f"    {k:24s} distance {dist[k]:.3e} noise {noise[k]:.3e}")
