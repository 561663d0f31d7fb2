"""The plain route of the port against the JAX package's XLA route, on
the CPU.

Where JAX's `_kernel_topology_ok` keeps a config off its kernels (f32
`train.precision`, another trunk or view-branch depth or skip, no view
directions, the emissive or chroma head), it sends every MLP query to
XLA, and the port's model to the general NerfMLP with torch autograd
(`models/base.py` `plain_route_reasons`, `NerfModel._query`), on every
device. The small model of tests/test_torch_train_step.py (width 64, 16
rays, 8 + 8 samples, 4 env directions x 4 samples):

- the route table: the shipped configs on the kernels, each key of
  JAX's predicate on the plain route; on the kernel route, the widths
  and encodings the kernels are not built for refused
  (`kernel_build_gaps`);
- f32 renders of both families against JAX's at atol 1e-4 (mip-NeRF's
  normal at 1e-3, as tests/test_torch_mip_nerf.py holds it); one f32
  train step of each against JAX's (loss parts rel 1e-5, gradients
  rel-norm 1e-4 per leaf); one bf16 step at the two-way rule (loss parts
  within 3%, the port's gradient within 1.5x of JAX's bf16 distance to
  JAX's f32 gradient);
- the standard config never reaches the plain NerfMLP (on the CPU its
  queries go through the kernels' wrappers, here their plain versions;
  the `cuda` twin holds the same on the card), and f32 reaches none of
  the wrappers.

Each lifted topology key is held to JAX in tests/test_torch_topology.py,
each encoding key and no view directions in test_torch_encodings.py.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.core.config import load_config as jax_load_config
from pano_nerf_tpu.core.rays import Rays as JaxRays
from pano_nerf_tpu.engine import losses as jax_losses
from pano_nerf_tpu.engine.system import MipNeRFSystem as JaxMipSystem
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.core.rays import rays_map, rays_to_tensors
from pano_nerf_tpu_torch.engine.system import build_system
from pano_nerf_tpu_torch.models import build_model
from pano_nerf_tpu_torch.models.base import (kernel_build_gaps,
                                             plain_route_reasons)
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax

from test_torch_env_modes import replay_draws, systems
from test_torch_train_step import B, S, _batch, _leaves, _rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
MIP_CONFIG = os.path.join(REPO, "configs", "mipnerf.yaml")
CHUNK = ["val.chunk_size", "16"]


def flat(leaves):
    return np.concatenate([leaves[k].ravel() for k in sorted(leaves)])


def step_both(extra, precision="f32", step=0, scale_distill=False,
              f64=False, on_kernels=False, jit_init=False):
    """One train step of JAX and of the port (f32 on the plain route, as
    on every device; with `on_kernels` on the kernel route, the kernels'
    plain versions) at `step` on the test batch: (port loss parts, JAX loss parts, port grads, JAX grads
    clipped as JAX's step clips them, port system) and with `f64` the
    port's step in float64 from the same state (loss parts, grads). JAX's
    draws are replayed into the port's TrainDraws, with the
    scale-distill re-march's (`fold_in(key, 0x5D)`) when asked;
    `jit_init` as `systems` takes it."""
    jsys, params, psys = systems(extra, precision, on_kernels=on_kernels,
                                 jit_init=jit_init)
    rays_np, rgbs_np = _batch()
    key = jax.random.fold_in(jax.random.PRNGKey(7), step)
    hp_j = jsys.hparams

    def loss_fn(p):
        outs = jsys.model(p, key, JaxRays(*rays_np), jsys.env_rays,
                          randomized=True, white_bkgd=False,
                          enable_surf=True, use_ort_loss=True,
                          use_vc_loss=True, use_scale_distill=scale_distill)
        parts = jax_losses.pano_losses(outs, jnp.asarray(rgbs_np),
                                       jnp.asarray(rays_np.lossmult), hp_j,
                                       True, step=jnp.int32(step))
        return parts["loss"], parts

    (_, j_parts), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    draws = replay_draws(jsys.model, key)
    if scale_distill:
        draws = draws._replace(t_sd=torch.tensor(np.asarray(
            jax.random.uniform(jax.random.fold_in(key, 0x5D), (B, S + 1)))))
    state = psys.create_state()
    state.step = step
    parts = psys.make_train_step(True)(
        state, rays_to_tensors(rays_np, torch.device("cpu")),
        torch.tensor(rgbs_np), draws)
    pg = _leaves(params_to_jax({n: p.grad for n, p in
                                psys.model.named_params()}))
    jg = _leaves(jax.tree.map(np.asarray, j_grads))
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in jg.values()))
    clip = float(hp_j["optimizer.grad_clip"])
    jg = {k: g * np.float32(clip / max(norm, clip)) for k, g in jg.items()}
    out = (parts, j_parts, pg, jg, psys)
    if not f64:
        return out
    sys64 = copy.deepcopy(psys)
    sys64.model.double()
    sys64.model.kernels = False   # the kernels' wrappers take f32 only
    sys64.model.load_params({k: v.double() for k, v in
                             params_from_jax(params).items()})
    sys64.env_rays = rays_map(lambda x: x.double(), sys64.env_rays)
    d64 = type(draws)(*(x.double() if x is not None and x.is_floating_point()
                        else x for x in draws))
    state = sys64.create_state()
    state.step = step
    parts64 = sys64.make_train_step(True)(
        state, rays_map(lambda x: x.double(), rays_to_tensors(
            rays_np, torch.device("cpu"))),
        torch.tensor(rgbs_np).double(), d64)
    g64 = _leaves(params_to_jax({n: p.grad for n, p in
                                 sys64.model.named_params()}))
    return out + (parts64, g64)


def check_step_f64(extra, names=(), **kw):
    """One f32 train step against JAX's: loss parts at rel 1e-5 and
    gradients at rel-norm 1e-4 per leaf. The port's f64 step from the
    same state arbitrates f32 rounding: where JAX's f32 value is itself
    further than that from it (XLA's fusion and summation order: one
    leaf of tests/test_torch_topology.py's IPE degrees 0..12 reads 2.1e-4
    from it where the port reads 2.5e-5), the port's f32 value is held to
    the f64 one at the same tolerance, and JAX's to it at ten times that.
    Returns the port's loss parts."""
    parts, j_parts, pg, jg, psys, p64, g64 = step_both(extra, f64=True,
                                                       **kw)
    want_names = {"loss", "vol_coarse", "vol_fine", "vol_surface", "chrom",
                  "ort", "dist", "sat", "vc", *names}
    assert set(parts) == want_names
    for k in want_names:
        got, want, exact = float(parts[k]), float(j_parts[k]), float(p64[k])
        near = lambda a, b, r: abs(a - b) <= r * abs(b) + 1e-9
        assert near(got, want, 1e-5) or (
            near(got, exact, 1e-5) and near(want, exact, 1e-4)), (
                k, got, want, exact)
    assert jg.keys() == pg.keys()
    for k in jg:
        assert _rel(pg[k], jg[k]) < 1e-4 or (
            _rel(pg[k], g64[k]) < 1e-4 and _rel(jg[k], g64[k]) < 1e-3), (
                k, _rel(pg[k], jg[k]), _rel(pg[k], g64[k]),
                _rel(jg[k], g64[k]))
    return parts


def render_both(extra, precision="f32"):
    """The eval products of JAX and of the port on the same weights:
    (port, JAX, the port's system), numpy."""
    jsys, params, psys = systems(list(extra) + CHUNK, precision,
                                 on_kernels=False)
    rays_np, _ = _batch(1)
    want = jsys.make_render_image(enable_surf=True)(params, JaxRays(*rays_np))
    got = psys.make_render_image(True)(None, rays_to_tensors(
        rays_np, torch.device("cpu")))
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()}, psys)


def render_f64(psys, rays_np):
    """The port's eval products in float64 (a copy of the system), the
    arbiter of f32 rounding."""
    sys64 = copy.deepcopy(psys)
    sys64.model.double()
    sys64.env_rays = rays_map(lambda x: x.double(), sys64.env_rays)
    rays = rays_map(lambda x: x.double(),
                    rays_to_tensors(rays_np, torch.device("cpu")))
    with torch.no_grad():
        out = sys64.render_chunk(rays, None, True).numpy()
    parts, col = {}, 0
    for name, width in sys64.render_products(True):
        parts[name] = out[:, col:col + width]
        col += width
    return parts


def check_render(extra):
    """The f32 render against JAX's: every product at atol 1e-4 on every
    ray where the port's f32 render agrees with its f64 render at 1e-4.
    Where a fine-level ReLU pre-activation lies within f32 rounding of 0
    (one ray of the 8-channel init of tests/test_torch_heads.py), the
    port's f32 may flip that mask where JAX's does not, turning one
    sample's normal; on such a ray (at most one) the port's f64 render is
    held to JAX's at 1e-4. Returns (port, JAX) products."""
    got, want, psys = render_both(extra)
    assert set(got) == set(want)
    f64 = render_f64(psys, _batch(1)[0])
    off = np.zeros(len(got["rgb_fine"]), bool)
    for k in got:
        off |= np.abs(got[k] - f64[k]).max(-1) > 1e-4
    assert off.sum() <= 1, np.flatnonzero(off)
    for k in want:
        np.testing.assert_allclose(got[k][~off], want[k][~off], atol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(f64[k][off], want[k][off], atol=1e-4,
                                   err_msg=k)
    return got, want


def check_bf16(extra, scale_distill=False, names=()):
    """The two-way rule: loss parts within 3% of JAX's bf16 parts; the
    port's bf16 gradient within 1.5x of JAX's bf16 distance to JAX's f32
    gradient (rel-norm of the whole gradient)."""
    parts, j_parts, pg, jg, _ = step_both(extra, "bf16",
                                          scale_distill=scale_distill)
    for k in ("loss", "vol_coarse", "vol_fine", "vol_surface", "vc",
              *names):
        want, got = float(j_parts[k]), float(parts[k])
        assert abs(got - want) <= 3e-2 * abs(want), (k, got, want)
    f32 = flat(step_both(extra, "f32", scale_distill=scale_distill)[3])
    port, jax_bf16 = _rel(flat(pg), f32), _rel(flat(jg), f32)
    assert port <= 1.5 * jax_bf16, (port, jax_bf16)


# ---- the route ----

STANDARD = (CONFIG, MIP_CONFIG,
            os.path.join(REPO, "configs", "panonerf_hdr.yaml"),
            os.path.join(REPO, "configs", "panonerf_shadow.yaml"),
            os.path.join(REPO, "configs", "panonerf_fast.yaml"))


@pytest.mark.parametrize("config", STANDARD,
                         ids=lambda c: os.path.basename(c))
def test_shipped_configs_take_the_kernels(config):
    model = build_model(load_config(config))
    assert model.kernels and plain_route_reasons(model.cfg) == []
    assert kernel_build_gaps(model.cfg, torch.device("cuda")) == []


@pytest.mark.parametrize("opts,why", [
    (["train.precision", "'f32'"], ["train.precision f32"]),
    (["nerf.mlp.net_depth", "4"], ["nerf.mlp.net_depth 4"]),
    (["nerf.mlp.skip_index", "3"], ["nerf.mlp.skip_index 3"]),
    (["nerf.mlp.net_depth_condition", "2"],
     ["nerf.mlp.net_depth_condition 2"]),
    (["nerf.use_viewdirs", "False"], ["nerf.use_viewdirs false"]),
    (["nerf.emissive_head", "True"], ["nerf.emissive_head"]),
    (["nerf.emissive_head", "True", "nerf.chroma_head", "True"],
     ["nerf.emissive_head", "nerf.chroma_head"]),
    (["train.precision", "'f32'", "nerf.max_deg_point", "10",
      "nerf.mlp.net_width", "64"], ["train.precision f32"])])
def test_route_table(opts, why):
    """Why a config takes the plain route: JAX's predicate alone, the
    same on every device."""
    model = build_model(load_config(CONFIG, opts))
    assert plain_route_reasons(model.cfg) == why and not model.kernels


@pytest.mark.parametrize("opts,cuda,cpu", [
    (["nerf.mlp.net_width", "640", "nerf.mlp.net_width_condition", "320"],
     ["nerf.mlp.net_width 640", "nerf.mlp.net_width_condition 320"], []),
    (["nerf.max_deg_point", "18"],
     ["nerf.min_deg_point..max_deg_point 0..18"], []),
    (["nerf.deg_view", "5", "nerf.append_identity", "False"],
     ["nerf.deg_view 5"], []),
    (["nerf.max_deg_point", "0"],
     ["nerf.min_deg_point..max_deg_point 0..0"],
     ["nerf.min_deg_point..max_deg_point 0..0"])])
def test_kernel_route_refuses_what_the_kernels_are_not_built_for(
        opts, cuda, cpu):
    """On the kernel route (bf16, the standard topology) a width or an
    encoding the kernels are not built for is refused, never sent to the
    plain route: the CUDA builds take trunk widths up to 512 and view
    widths up to 256, IPE degrees 1..16 and viewdir encodings of deg_view
    1..4 (with or without identity); the plain versions on the CPU any
    width and any number of degrees from 1, as JAX's kernels."""
    hp = load_config(CONFIG, opts)
    model = build_model(hp)
    assert model.kernels
    assert kernel_build_gaps(model.cfg, torch.device("cuda")) == cuda
    assert kernel_build_gaps(model.cfg, torch.device("cpu")) == cpu
    if cpu:
        with pytest.raises(NotImplementedError, match=cpu[0]):
            build_system(hp, device="cpu")
    else:
        assert build_system(hp, device="cpu").model.kernels


def test_plain_route_is_said_once(capsys, monkeypatch):
    from pano_nerf_tpu_torch.engine import system as port_system
    monkeypatch.setattr(port_system, "_ROUTES_SAID", set())
    hp = load_config(CONFIG, ["nerf.mlp.net_depth", "3"])
    for _ in range(2):
        build_system(hp, device="cpu")
    out = capsys.readouterr().out
    assert out.count("[route] plain on cpu: nerf.mlp.net_depth 3") == 1
    build_system(load_config(CONFIG), device="cpu")
    assert "[route]" not in capsys.readouterr().out


def _counting(monkeypatch):
    """Count the kernels' plain versions' calls (reached only through
    their wrappers)."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    calls = []
    for mod, name in ((k2, "fused_mlp_ipe_reference"),
                      (k3, "fused_mlp_normals_reference")):
        plain = getattr(mod, name)

        def counted(*a, _plain=plain, _name=name, **k):
            calls.append(_name)
            return _plain(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


def test_standard_step_goes_through_the_kernel_wrappers(monkeypatch):
    """On the CPU a bf16 config the kernels take reaches every MLP query
    of a step through the wrappers of kernels 2 (coarse, view
    consistency, env) and 3 (fine), here their plain versions; in f32 it
    takes the plain route and reaches none of them."""
    from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
    from test_torch_train_step import D, OPTS
    calls = _counting(monkeypatch)
    rays_np, rgbs_np = _batch()

    def step(precision):
        psys = build_system(load_config(CONFIG, OPTS + [
            "train.precision", f"'{precision}'"]), device="cpu")
        psys.set_env_rays(generate_lit_rays(D, 0.0, 10.0))
        psys.make_train_step(True)(
            psys.create_state(),
            rays_to_tensors(rays_np, torch.device("cpu")),
            torch.tensor(rgbs_np), psys.make_draws(B, torch.Generator()))
        return psys.model.kernels

    assert step("bf16")
    assert sorted(calls) == sorted(["fused_mlp_ipe_reference"] * 3
                                   + ["fused_mlp_normals_reference"])
    calls.clear()
    assert not step("f32")
    assert calls == []


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py phases 4 and 15 hold "
                    "the routes on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_standard_config_never_reaches_the_plain_mlp_on_the_card(
        cuda_device, monkeypatch):
    """The cuda twin: the shipped config's step and render on the card
    launch the kernels and never call the NerfMLP forward or its chain."""
    from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
    from pano_nerf_tpu_torch.kernels import counters
    from pano_nerf_tpu_torch.models import mlp as mlp_lib, normals

    def no_plain(*a, **k):
        raise AssertionError("the plain NerfMLP ran on the kernel route")

    monkeypatch.setattr(mlp_lib.NerfMLP, "forward", no_plain)
    monkeypatch.setattr(normals, "mlp_with_density_grad", no_plain)
    psys = build_system(load_config(CONFIG, CHUNK), device="cuda")
    assert psys.model.kernels
    psys.set_env_rays(generate_lit_rays(10, 0.0, 10.0))
    rays_np, rgbs_np = _batch()
    rays = rays_to_tensors(rays_np, cuda_device)
    counters.reset_launch_counts()
    psys.make_train_step(True)(
        psys.create_state(), rays, torch.tensor(rgbs_np).to(cuda_device),
        psys.make_draws(B, torch.Generator(device=cuda_device)))
    psys.make_render_image(True)(None, rays)
    got = counters.launch_counts()
    assert got["fused_mlp_ipe_fwd"] == 3 and got["fused_mlp_normals_fwd"] == 1
    assert got["fused_render_level"] > 0


# ---- f32 and bf16 on the plain route against JAX ----

def test_f32_render_matches_jax():
    check_render([])


def test_f32_step_matches_jax():
    check_step_f64([])


def test_bf16_step_at_the_two_way_rule():
    check_bf16([])


def _mip_systems(precision, extra=()):
    opts = ["nerf.num_samples", "8", "nerf.mlp.net_width", "64",
            "nerf.mlp.net_width_condition", "32", *CHUNK,
            "train.precision", f"'{precision}'", *extra]
    jsys = JaxMipSystem(jax_load_config(MIP_CONFIG, opts))
    state = jsys.create_state(jax.random.PRNGKey(0))
    psys = build_system(load_config(MIP_CONFIG, opts), device="cpu")
    psys.model.mlp.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, state.params)))
    return jsys, state, psys


def mip_render_both(extra=()):
    jsys, state, psys = _mip_systems("f32", extra)
    rays_np, _ = _batch(1)
    want = jsys.make_render_image()(state.params, JaxRays(*rays_np))
    got = psys.make_render_image()(None, rays_to_tensors(
        rays_np, torch.device("cpu")))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3 if k == "normal" else 1e-4,
                                   err_msg=k)


def mip_step_both(extra=()):
    """One f32 mip-NeRF step with the orientation loss, both sides:
    loss parts rel 1e-5, gradients rel-norm 1e-4 per leaf."""
    from pano_nerf_tpu_torch.models.mip_nerf import MipDraws
    jsys, state, psys = _mip_systems("f32", ["loss.ort_loss", "0.1",
                                             *extra])
    rays_np, rgbs_np = _batch()
    key = jax.random.PRNGKey(7)
    hp_j = jsys.hparams
    n = psys.model.cfg.num_samples

    def loss_fn(p):
        outs = jsys.model(p, jax.random.fold_in(key, 0), JaxRays(*rays_np),
                          randomized=True, white_bkgd=False,
                          use_ort_loss=True)
        parts = jax_losses.mipnerf_losses(
            outs, jnp.asarray(rgbs_np), jnp.asarray(rays_np.lossmult), hp_j)
        return parts["loss"], parts

    (_, j_parts), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params)
    keys = jax.random.split(jax.random.fold_in(key, 0), 4)
    u = lambda k: torch.tensor(np.asarray(jax.random.uniform(k, (B, n + 1))))
    parts = psys.make_train_step(False)(
        psys.create_state(), rays_to_tensors(rays_np, torch.device("cpu")),
        torch.tensor(rgbs_np), MipDraws(t_coarse=u(keys[0]),
                                        u_fine=u(keys[2])))
    assert set(parts) == {"loss", "vol_coarse", "vol_fine", "ort"}
    for k in parts:
        want, got = float(j_parts[k]), float(parts[k])
        assert abs(got - want) <= 1e-5 * abs(want) + 1e-9, (k, got, want)
    jg = _leaves(jax.tree.map(np.asarray, j_grads))
    pg = _leaves(params_to_jax({n: p.grad for n, p in
                                psys.model.mlp.named_parameters()}))
    assert jg.keys() == pg.keys()
    for k in jg:
        assert _rel(pg[k], jg[k]) < 1e-4, (k, _rel(pg[k], jg[k]))


def test_mip_f32_render_matches_jax():
    mip_render_both()


def test_mip_f32_step_matches_jax():
    mip_step_both()
