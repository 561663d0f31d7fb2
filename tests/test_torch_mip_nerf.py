"""The mip-NeRF baseline (`configs/mipnerf.yaml`) of the port against the
JAX package's `MipNeRFSystem`, on the CPU.

The port's `MipNeRFSystem` runs the plain versions of kernels 2 and 3 on
CPU tensors at C = 1 density channel (the model class sets it, although
the YAML says 5, as JAX's `MipNeRF` does). A small model (trunk width
64, 16 rays, 8 + 8 samples) takes bridged parameters:

- the eval products (`make_render_image`) in f32 against JAX's standard
  path: rgb and depth at atol 1e-4, the fine normal at atol 1e-3 (the
  port takes d density / d means from kernel 3's explicit chain, JAX
  from a `jax.vjp`); and in bf16 against JAX's kernel route (Pallas in
  interpret mode: kernel 2 and its custom VJP) at the kernel tolerances;
- one train step against JAX's `make_train_step` with the same draws
  (JAX's key schedule replayed: `fold_in(key, step)`, `split` into 4,
  coarse stratification from keys[0], resampling jitter from keys[2]),
  with `loss.ort_loss` 0 and 0.1, in f32 and bf16, held as
  tests/test_torch_train_step.py holds the Pano-NeRF step;
- `mipnerf_losses`, the model factory, the parameter bridge at C = 1,
  and a 2-step `python -m pano_nerf_tpu_torch.train` run rendered back
  through `python -m pano_nerf_tpu_torch.eval --ckpt_dir`.
"""

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
from pano_nerf_tpu.engine.system import build_system as jax_build_system
from pano_nerf_tpu.models import build_model as jax_build_model
from pano_nerf_tpu.models.base import LevelOutput as JaxLevelOutput
from pano_nerf_tpu_torch import eval as port_eval
from pano_nerf_tpu_torch import train as port_train
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.core.rays import rays_to_tensors
from pano_nerf_tpu_torch.data.synthetic import generate_scene
from pano_nerf_tpu_torch.engine import losses, validation as val_lib
from pano_nerf_tpu_torch.engine.system import (MipNeRFSystem,
                                               PanoNeRFSystem, build_system)
from pano_nerf_tpu_torch.models import build_model
from pano_nerf_tpu_torch.models.base import LevelOutput
from pano_nerf_tpu_torch.models.mip_nerf import MipDraws, MipNeRF
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax

from test_torch_train_step import _leaves, _rel, f32_on_the_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "mipnerf.yaml")
B, N = 16, 8
OPTS = ["nerf.num_samples", str(N), "nerf.mlp.net_width", "64",
        "nerf.mlp.net_width_condition", "32", "val.chunk_size", "12"]


def _batch(seed=0, num=B):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(num, 3)).astype(np.float32)
    ones = np.ones((num, 1), np.float32)
    rays = JaxRays(
        origins=rng.uniform(-0.3, 0.3, (num, 3)).astype(np.float32),
        directions=d,
        viewdirs=(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32),
        radii=ones * 0.01, lossmult=ones, near=ones * 0.0, far=ones * 6.0,
        noise_var=ones * 0.0)
    rgbs = rng.uniform(0.0, 3.0, (num, 3)).astype(np.float32)
    return rays, rgbs


def _systems(precision, extra=()):
    opts = OPTS + ["train.precision", f"'{precision}'", *extra]
    jsys = JaxMipSystem(jax_load_config(CONFIG, opts))
    state = jsys.create_state(jax.random.PRNGKey(0))
    psys = f32_on_the_kernels(build_system(load_config(CONFIG, opts),
                                           device="cpu"))
    psys.model.mlp.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, state.params)))
    return jsys, state, psys


def test_build_system_and_model_choose_mipnerf_with_one_density_channel():
    hp = load_config(CONFIG, OPTS)
    assert hp["nerf.mlp_name"] == "mipnerf"
    assert hp["nerf.mlp.num_density_channels"] == 5   # never read
    system = build_system(hp, device="cpu")
    assert type(system) is MipNeRFSystem and not system.surface
    assert isinstance(system.model, MipNeRF)
    assert isinstance(build_model(hp), MipNeRF)
    mlp = system.model.mlp
    assert mlp.num_density_channels == 1
    assert tuple(mlp.density_layer.weight.shape) == (1, 64)
    assert jax_build_model(jax_load_config(CONFIG, OPTS)
                           ).mlp_num_density_channels == 1
    pano = load_config(os.path.join(REPO, "configs", "panonerf.yaml"))
    assert type(build_system(pano, device="cpu")) is PanoNeRFSystem
    assert build_model(pano).mlp.num_density_channels == 5
    with pytest.raises(ValueError, match="Unknown system"):
        build_system(dict(hp, **{"nerf.mlp_name": "nerf"}), device="cpu")
    with pytest.raises(ValueError, match="build_system"):
        PanoNeRFSystem(hp, device="cpu")


def test_mipnerf_honours_density_noise_as_jax():
    """JAX's mip-NeRF noises its raw density (models/mip_nerf.py:61-77);
    so does the port's, which takes the key (the noised step against
    JAX's is in tests/test_torch_levels.py)."""
    hp = dict(load_config(CONFIG, OPTS), **{"nerf.density_noise": 1.0})
    assert jax_build_model(hp).density_noise == 1.0
    assert build_model(hp).cfg.density_noise == 1.0


def test_parameters_round_trip_jax_port_jax_at_one_density_channel():
    jsys, state, psys = _systems("f32")
    want = _leaves(jax.tree.map(np.asarray, state.params))
    assert want["density/kernel"].shape == (64, 1)
    back = _leaves(params_to_jax(psys.model.mlp.state_dict()))
    assert want.keys() == back.keys()
    for k in want:
        assert back[k].shape == want[k].shape, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def _render_both(precision):
    jsys, state, psys = _systems(precision)
    rays_np, _ = _batch(1)
    want = jsys.make_render_image()(state.params, JaxRays(*rays_np))
    got = psys.make_render_image()(None, rays_to_tensors(
        rays_np, torch.device("cpu")))
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def test_render_matches_jax_in_f32(monkeypatch):
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    got, want = _render_both("f32")
    assert set(got) == set(want) == {"rgb_coarse", "dep_coarse", "rgb_fine",
                                      "dep_fine", "normal"}
    for k in ("rgb_coarse", "dep_coarse", "rgb_fine", "dep_fine"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["normal"], want["normal"], atol=1e-3)


def test_render_tracks_jax_kernel_route_in_bf16(monkeypatch):
    """JAX through kernel 2 (Pallas, interpret mode) at both levels, the
    fine normal by `jax.vjp` through its custom VJP; the port through the
    plain versions of kernels 2 and 3. bf16 rounds at other places in the
    two: the kernel tolerances of tests/test_torch_render.py (every ray's
    normal within 0.85 in cosine, as its 12-ray kernel test holds them)."""
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")
    got, want = _render_both("bf16")
    for k in ("rgb_coarse", "dep_coarse", "rgb_fine", "dep_fine"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-2, err_msg=k)
    cos = np.sum(got["normal"] * want["normal"], -1)
    assert np.median(cos) > 0.998, np.sort(cos)
    assert cos.min() > 0.85, np.sort(cos)


def _draws(key, step):
    """Replay JAX's key schedule of one MipNeRF step (system.py:374,
    mip_nerf.py:47, base.py:834-865)."""
    keys = jax.random.split(jax.random.fold_in(key, step), 4)
    u = lambda k: torch.tensor(np.asarray(jax.random.uniform(k, (B, N + 1))))
    return MipDraws(t_coarse=u(keys[0]), u_fine=u(keys[2]))


def _run_both(precision, ort):
    jsys, state, psys = _systems(precision, ["loss.ort_loss", str(ort)])
    rays_np, rgbs_np = _batch()
    key = jax.random.PRNGKey(7)
    hp_j = jsys.hparams

    def loss_fn(p):
        outs = jsys.model(p, jax.random.fold_in(key, 0), JaxRays(*rays_np),
                          randomized=True, white_bkgd=False,
                          use_ort_loss=ort > 0)
        parts = jax_losses.mipnerf_losses(
            outs, jnp.asarray(rgbs_np), jnp.asarray(rays_np.lossmult), hp_j)
        return parts["loss"], parts

    (_, j_parts), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params)
    new_state, _ = jsys.make_train_step()(
        state, (JaxRays(*rays_np), jnp.asarray(rgbs_np)), key)
    pstate = psys.create_state()
    parts = psys.make_train_step(False)(
        pstate, rays_to_tensors(rays_np, torch.device("cpu")),
        torch.tensor(rgbs_np), _draws(key, 0))
    grads = params_to_jax({n: p.grad for n, p in
                           psys.model.mlp.named_parameters()})
    return (j_parts, jax.tree.map(np.asarray, j_grads),
            jax.tree.map(np.asarray, new_state.params), parts, grads,
            params_to_jax(psys.model.mlp.state_dict()), hp_j)


@pytest.mark.parametrize("ort", [0.0, 0.1])
def test_train_step_matches_jax_in_f32(monkeypatch, ort):
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    j_parts, j_grads, j_new, parts, grads, new, hp = _run_both("f32", ort)
    names = ["loss", "vol_coarse", "vol_fine"] + (["ort"] if ort else [])
    assert set(parts) == set(names)
    for k in names:
        want, got = float(j_parts[k]), float(parts[k])
        assert abs(got - want) <= 1e-5 * abs(want) + 1e-9, (k, got, want)
    jg, pg = _leaves(j_grads), _leaves(grads)
    assert jg.keys() == pg.keys()
    assert pg["density/kernel"].shape == (64, 1)
    for k in jg:
        assert _rel(pg[k], jg[k]) < 1e-4, k
    lr = float(hp["optimizer.lr_init"]) * float(hp["optimizer.lr_delay_mult"])
    jn, pn = _leaves(j_new), _leaves(new)
    for k in jn:
        assert float(np.abs(pn[k] - jn[k]).max()) <= 0.1 * lr, k


def _flat(tree):
    leaves = _leaves(tree)
    return np.concatenate([leaves[k].ravel() for k in sorted(leaves)])


@pytest.mark.parametrize("ort", [0.0, 0.1])
def test_train_step_tracks_jax_in_bf16(monkeypatch, ort):
    """Loss parts within 3% as `_check_bf16` of
    tests/test_torch_train_step.py holds them. Gradients: without the
    orientation loss within 10% per leaf, as `_check_bf16` holds them.
    With it, the gradient normalizes per-sample density gradients and
    bf16 rounding moves it by 10-20% per leaf from f32 in JAX itself
    (more than the frameworks differ from each other in f32 by far), so
    it is held as chip_smoke.py holds the card's step: the port's bf16
    gradient must stay within 1.5x of JAX's bf16 distance to JAX's f32
    gradient (rel-norm of the whole gradient)."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    j_parts, j_grads, _, parts, grads, _, _ = _run_both("bf16", ort)
    for k in ("loss", "vol_coarse", "vol_fine") + (("ort",) if ort else ()):
        want, got = float(j_parts[k]), float(parts[k])
        assert abs(got - want) <= 3e-2 * abs(want), (k, got, want)
    if not ort:
        jg, pg = _leaves(j_grads), _leaves(grads)
        for k in jg:
            assert _rel(pg[k], jg[k]) < 0.1, k
        return
    f32 = _flat(_run_both("f32", ort)[1])
    port, jax_bf16 = _rel(_flat(grads), f32), _rel(_flat(j_grads), f32)
    assert port <= 1.5 * jax_bf16, (port, jax_bf16)


@pytest.mark.parametrize("ort", [0.0, 0.3])
def test_mipnerf_losses_match_jax(ort):
    rng = np.random.default_rng(4)
    f = lambda *s: rng.uniform(0, 3, s).astype(np.float32)
    coarse, fine, gt = f(32, 3), f(32, 3), f(32, 3)
    mask = (rng.uniform(size=(32, 1)) > 0.2).astype(np.float32)
    ort_loss = np.float32(0.37)
    hp = {"loss.coarse_loss_mult": 0.1, "loss.ort_loss": ort}
    want = jax_losses.mipnerf_losses(
        [JaxLevelOutput(rgb=jnp.asarray(coarse), distance=None, acc=None),
         JaxLevelOutput(rgb=jnp.asarray(fine), distance=None, acc=None,
                        ort_loss=jnp.asarray(ort_loss))],
        jnp.asarray(gt), jnp.asarray(mask), hp)
    T = torch.tensor
    got = losses.mipnerf_losses(
        [LevelOutput(rgb=T(coarse), distance=None, acc=None),
         LevelOutput(rgb=T(fine), distance=None, acc=None,
                     ort_loss=T(ort_loss))], T(gt), T(mask), hp)
    assert {k for k, v in got.items() if v is not None} == {
        k for k, v in want.items() if v is not None}
    for k, v in want.items():
        if v is not None:
            assert float(got[k]) == pytest.approx(float(v), rel=1e-6), k
    losses.check_mipnerf_loss_config(hp)
    with pytest.raises(KeyError, match="coarse_loss_mult"):
        losses.check_mipnerf_loss_config({"loss.ort_loss": 0.0})


def test_jax_build_system_is_the_reference_here():
    """The comparison above holds the port against the JAX system that
    JAX's own trainer builds for this config."""
    assert isinstance(jax_build_system(jax_load_config(CONFIG, OPTS)),
                      JaxMipSystem)


TRAIN_OPTS = ["train.factor", "1", "val.factor", "1", "train.sample_num",
              "'n0_1'", "nerf.num_samples", "6", "nerf.mlp.net_width", "64",
              "nerf.mlp.net_width_condition", "32", "train.batch_size", "16",
              "val.chunk_size", "256", "log_every_n_step", "1",
              "val.check_every_n_epoch", "0.002", "optimizer.max_steps", "2",
              "train.steps_per_call", "2"]


def test_train_two_steps_then_eval_the_checkpoint(tmp_path):
    """`python -m pano_nerf_tpu_torch.train --config configs/mipnerf.yaml`
    for 2 steps on a 16x32 scene: the run is `mipnerf_0_1`, its
    validations write the 8-product tree of the baseline (no surface
    products), and `eval --ckpt_dir` renders the checkpoint to the
    metrics of a render of its weights."""
    scene = str(tmp_path / "scene")
    generate_scene(scene, n_views=3, height=16, width=32, seed=0)
    out = str(tmp_path / "exp")
    trainer = port_train.main(["--data_path", scene, "--out_dir", out,
                               "--config", CONFIG, "--device", "cpu",
                               "--init_seed", "0"] + TRAIN_OPTS)
    save_dir = trainer.hparams["save_dir"]
    assert save_dir == os.path.join(out, "mipnerf_0_1")
    assert isinstance(trainer.system, MipNeRFSystem)
    assert not trainer.steps_with_surface
    assert trainer.ckpt.steps() == [2]
    tree = os.path.join(save_dir, "val_000002")
    surf = {"pred_hdr_surf", "pred_ldr_surf", "pred_albedo"}
    assert sorted(os.listdir(tree)) == sorted(set(val_lib.PRODUCTS) - surf)
    eval_out = str(tmp_path / "eval")
    metrics = port_eval.main(["--data_path", scene, "--out_dir", eval_out,
                              "--ckpt_dir", save_dir, "--device", "cpu",
                              "--config", CONFIG] + TRAIN_OPTS)
    assert metrics["step"] == 2
    assert "psnr_hdr_surf" not in metrics and "albedo_simse" not in metrics
    assert sorted(os.listdir(os.path.join(eval_out, "eval_000002"))) == \
        sorted(set(val_lib.PRODUCTS) - surf)
    system = build_system(port_eval.prepare_hparams(
        load_config(CONFIG, TRAIN_OPTS)), device="cpu")
    ds = trainer.val_dataset
    rays, gt_rgb, gt_depth, gt_normal, gt_albedo = ds[0]
    products = val_lib.render_full_pano(
        system.make_render_image(), trainer.ckpt.restore(2)["params"], rays,
        ds.h, ds.w, torch.device("cpu"))
    want = val_lib.validation_metrics(products, gt_rgb, gt_depth, gt_normal,
                                      gt_albedo, 0.0, 10.0)
    for k, v in want.items():
        assert metrics[k] == v, k
