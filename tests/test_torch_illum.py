"""The illuminant field of the port against the JAX package, on the CPU.

`nerf.illum_field` with `loss.illum_distill` (and its `_start` / `_ramp`
rise) and `train.illum_freeze`: the field's chroma (`_illum_chroma`) and
the luma-preserving re-tint (`_apply_illum`) at 1e-6 on the same
parameters, its initialization, the loss term and its rise, one f32 train
step inside the rise (loss parts rel 1e-5, gradients rel-norm 1e-4 per
leaf, the field's leaves included), the freeze mask on both sides of its
step, the eval render (f32 atol 1e-4), and the parameters' round trip
through the JAX tree, `.npz` files and a training run's checkpoint served
by `eval --ckpt_dir` and `render_path`. The field's output layer starts
at zero (the identity tint, which passes no gradient to its hidden
layers), so the parity cases draw it from a numpy seed.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.core.rays import Rays as JaxRays
from pano_nerf_tpu.engine import losses as jax_losses
from pano_nerf_tpu.models.base import LevelOutput as JaxLevelOutput
from pano_nerf_tpu_torch import eval as port_eval
from pano_nerf_tpu_torch import render_path as port_rp
from pano_nerf_tpu_torch import train as port_train
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.core.rays import rays_to_tensors
from pano_nerf_tpu_torch.data.synthetic import generate_scene
from pano_nerf_tpu_torch.engine import losses
from pano_nerf_tpu_torch.engine.checkpoint import Checkpointer
from pano_nerf_tpu_torch.models.base import LevelOutput
from pano_nerf_tpu_torch.models.illum import IllumField, apply_illum
from pano_nerf_tpu_torch.utils.params import (load_npz, params_from_jax,
                                              params_to_jax, save_npz)

from test_torch_env_modes import (WIDE, check_step, replay_draws, step_both,
                                  systems)
from test_torch_train_step import B, D, _batch
import torch_threads  # noqa: F401  (tests/torch_threads.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
ILLUM = ["nerf.illum_field", "True"]
# The rise of phase 12 of chip_smoke.py, over the config's 44,000 steps:
# 0 until step 22,000, 1 from 33,000.
DISTILL = ["loss.illum_distill", "0.05", "loss.illum_distill_start", "0.5",
           "loss.illum_distill_ramp", "0.25"]


def _field(params, sh_deg=2, posenc_deg=4):
    field = IllumField(sh_deg, params["w1"].shape[0], posenc_deg)
    field.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    return field


@pytest.mark.parametrize("sh_deg,posenc_deg", [(2, 4), (3, 2), (0, 1)])
def test_illum_chroma_and_retint_match_jax(sh_deg, posenc_deg):
    jsys, params, _ = systems(ILLUM + [
        "nerf.illum_sh_deg", str(sh_deg), "nerf.illum_posenc_deg",
        str(posenc_deg)], perturb_illum=True)
    rng = np.random.default_rng(sh_deg)
    x = rng.normal(size=(B, 3)).astype(np.float32)
    d = rng.normal(size=(B, D, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    env = rng.uniform(0, 4, (B, D, 3)).astype(np.float32)
    env[0, 0] = 0.0   # zero luma: the untinted read
    want = jsys.model._illum_chroma(params, jnp.asarray(x), jnp.asarray(d))
    got = _field(params["params"]["illum"], sh_deg, posenc_deg)(
        torch.tensor(x), torch.tensor(d))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    want_rgb = jsys.model._apply_illum(params, jnp.asarray(env),
                                       jnp.asarray(x), jnp.asarray(d),
                                       chroma=want)
    np.testing.assert_allclose(
        apply_illum(torch.tensor(env), got).detach().numpy(),
        np.asarray(want_rgb), rtol=1e-6, atol=1e-6)


def test_illum_field_init_is_neutral_and_seeded():
    """Xavier hidden layers from a generator of the field's own (the MLP's
    initial weights do not depend on whether the field is on), zero
    output: uniform chroma, the untinted read."""
    from pano_nerf_tpu_torch.models import build_model
    hp = load_config(CONFIG)
    on = build_model(dict(hp, **{"nerf.illum_field": True}),
                     torch.Generator().manual_seed(3))
    off = build_model(hp, torch.Generator().manual_seed(3))
    again = build_model(dict(hp, **{"nerf.illum_field": True}),
                        torch.Generator().manual_seed(3))
    for k, v in off.mlp.state_dict().items():
        assert torch.equal(on.mlp.state_dict()[k], v), k
    for k, v in on.illum.state_dict().items():
        assert torch.equal(again.illum.state_dict()[k], v), k
    f = on.illum
    w0 = f.w0.detach()
    assert tuple(w0.shape) == (27, 64) and tuple(f.w_out.shape) == (64, 27)
    assert float(w0.abs().max()) <= (6.0 / (27 + 64)) ** 0.5
    assert float(w0.std()) > 0.05 and not f.w_out.any()
    with torch.no_grad():
        chroma = f(torch.randn(4, 3), torch.nn.functional.normalize(
            torch.randn(4, 5, 3), dim=-1))
    torch.testing.assert_close(chroma, torch.full((4, 5, 3), 1 / 3))
    env = torch.rand(4, 5, 3)
    torch.testing.assert_close(apply_illum(env, chroma), env)


def _levels(rng, cls, to):
    f = lambda *s: to(rng.uniform(0.0, 3.0, s).astype(np.float32))
    coarse = cls(rgb=f(B, 3), distance=None, acc=None)
    fine = cls(rgb=f(B, 3), distance=None, acc=None,
               env_pre_illum=f(B, D, 3) - 0.5,
               illum_chroma=f(B, D, 3) / 9)
    return [coarse, fine]


@pytest.mark.parametrize("step,rise", [(0, 0.0), (500, 0.0), (625, 0.5),
                                       (750, 1.0), (1000, 1.0)])
def test_illum_distill_term_and_rise_match_jax(step, rise):
    hp = losses.prepare_hparams(dict(load_config(CONFIG), **{
        "loss.illum_distill": 0.05, "loss.illum_distill_start": 0.5,
        "loss.illum_distill_ramp": 0.25, "optimizer.max_steps": 1000}))
    rng = np.random.default_rng(step)
    gt = rng.uniform(0.0, 8.0, (B, 3)).astype(np.float32)
    mask = (rng.uniform(size=(B, 1)) > 0.2).astype(np.float32)
    want = jax_losses.pano_losses(
        _levels(np.random.default_rng(1), JaxLevelOutput, jnp.asarray),
        jnp.asarray(gt), jnp.asarray(mask), hp, False, step=jnp.int32(step))
    got = losses.pano_losses(
        _levels(np.random.default_rng(1), LevelOutput, torch.tensor),
        torch.tensor(gt), torch.tensor(mask), hp, False,
        step=torch.tensor(step))
    assert {k for k, v in got.items() if v is not None} == {
        k for k, v in want.items() if v is not None}
    for k, v in want.items():
        if v is not None:
            assert float(got[k]) == pytest.approx(float(v), rel=1e-5), k
    assert float(losses.illum_distill_rise(hp, torch.tensor(step))
                 ) == pytest.approx(rise, abs=1e-6)
    with pytest.raises(ValueError, match="no `step`"):
        losses.illum_distill_rise(hp, None)
    assert losses.illum_distill_rise(
        {"loss.illum_distill": 0.05}, None) is None


def test_train_step_inside_the_rise_matches_jax():
    """Step 27,500 of 44,000: the distill's rise at 0.5. The field's
    leaves are among the gradients held to JAX's."""
    parts, j_parts, pg, jg, psys = step_both(ILLUM + DISTILL, step=27500,
                                             perturb_illum=True)
    assert {k for k in pg if k.startswith("illum/")} == {
        f"illum/{k}" for k in ("w0", "b0", "w1", "b1", "w_out", "b_out")}
    check_step(parts, j_parts, pg, jg, names=("illum_distill",))


FREEZE = ["train.illum_freeze", "0.5", "optimizer.max_steps", "100",
          "optimizer.grad_clip", "0"]


@pytest.mark.parametrize("step", [49, 50])
def test_illum_freeze_masks_the_field_from_its_step(step):
    """train.illum_freeze 0.5 of 100 steps (JAX `_freeze_illum_grads`): at
    step 49 the step is the step without the key; from step 50 the
    field's gradients are 0, a fresh Adam leaves it as it was, and the
    MLP's gradients are still those of the step without the key (no
    clip here, so they are equal). JAX's mask zeroes the same leaves.
    (The full step inside the rise is held to JAX above.)"""
    frozen = step >= 50
    j_tree = {"params": {"trunk_0": {"kernel": jnp.ones(2)},
                         "illum": {"w0": jnp.ones(2)}}}
    masked = systems(ILLUM + FREEZE)[0]._freeze_illum_grads(
        j_tree, jnp.int32(step))["params"]
    assert float(masked["illum"]["w0"].sum()) == (0.0 if frozen else 2.0)
    assert float(masked["trunk_0"]["kernel"].sum()) == 2.0
    rays = rays_to_tensors(_batch()[0], torch.device("cpu"))
    rgbs = torch.tensor(_batch()[1])
    runs = []
    for extra in (FREEZE, FREEZE[2:]):
        jsys, _, psys = systems(ILLUM + DISTILL + extra, perturb_illum=True)
        before = [p.detach().clone() for _, p in psys.model.named_params()]
        state = psys.create_state()
        state.step = step
        psys.make_train_step(True)(state, rays, rgbs, replay_draws(
            jsys.model, jax.random.fold_in(jax.random.PRNGKey(7), step)))
        runs.append((psys.model.named_params(), before))
    (key_on, before), (key_off, _) = runs
    for (n, p), (_, q), b in zip(key_on, key_off, before):
        in_field = n.startswith("illum.")
        if frozen and in_field:
            assert not p.grad.any() and torch.equal(p, b), n
        else:
            assert torch.equal(p.grad, q.grad) and p.grad.any(), n
            assert torch.equal(p, q) and not torch.equal(p, b), n


def test_illum_render_matches_jax(monkeypatch):
    """Eval through the kernel-4 route (its plain version here), the env
    read re-tinted before the irradiance integral, against JAX's
    first-order standard path, f32 atol 1e-4."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    jsys, params, psys = systems(ILLUM + WIDE, perturb_illum=True)
    rays_np, _ = _batch(1)
    want = jsys.make_render_image(enable_surf=True)(params,
                                                    JaxRays(*rays_np))
    got = psys.make_render_image(True)(None, rays_to_tensors(
        rays_np, torch.device("cpu")))
    plain = systems(WIDE)[2].make_render_image(True)(None, rays_to_tensors(
        rays_np, torch.device("cpu")))
    assert not np.allclose(got["surf_rgb"], plain["surf_rgb"], atol=1e-3)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)


def test_params_round_trip_with_the_illum_subtree(tmp_path):
    jsys, params, psys = systems(ILLUM, perturb_illum=True)
    tree = params_to_jax(psys.model.param_state())
    assert tree["params"].keys() == params["params"].keys()
    for m, leaves in params["params"].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(tree["params"][m][k], v)
    save_npz(str(tmp_path / "p.npz"), tree)
    again = params_from_jax(load_npz(str(tmp_path / "p.npz")))
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(3, dict(params=again))
    restored = systems(ILLUM)[2]
    restored.model.load_params(ckpt.restore()["params"])
    for (n, p), (_, q) in zip(restored.model.named_params(),
                              psys.model.named_params()):
        assert torch.equal(p, q), n
    with pytest.raises(ValueError, match="illum_field is off"):
        systems([])[2].model.load_params(again)
    mlp_only = {k: v for k, v in again.items() if not k.startswith("illum")}
    with pytest.raises(RuntimeError, match="Missing key"):
        restored.model.load_params(mlp_only)


TRAIN_OPTS = ["train.factor", "1", "val.factor", "1",
              "train.sample_num", "'n0_1'", "nerf.num_samples", "6",
              "nerf.num_env_samples", "3", "nerf.num_ray_samples", "4",
              "train.batch_size", "16", "val.chunk_size", "256",
              "log_every_n_step", "2", "val.check_every_n_epoch", "0.002",
              "optimizer.max_steps", "2", "train.steps_per_call", "2",
              "loss.illum_distill", "0.05", "train.illum_freeze", "0.5",
              *ILLUM]


def test_illum_run_is_served_by_eval_and_render_path(tmp_path, capsys):
    """`train` with the field for 2 steps (frozen from step 1), then
    `eval --ckpt_dir` and `render_path` restore the field with the MLP:
    the served render is the trained model's."""
    scene = str(tmp_path / "s")
    generate_scene(scene, n_views=3, height=8, width=16, seed=0)
    trainer = port_train.main(["--data_path", scene, "--out_dir",
                               str(tmp_path / "exp"), "--config", CONFIG,
                               "--device", "cpu", "--init_seed", "0"]
                              + TRAIN_OPTS)
    saved = trainer.ckpt.restore()["params"]
    assert {k for k in saved if k.startswith("illum.")} == {
        f"illum.{k}" for k in ("w0", "b0", "w1", "b1", "w_out", "b_out")}
    for n, p in trainer.system.model.named_params():
        assert torch.equal(saved[n], p.detach()), n
    save_dir = trainer.hparams["save_dir"]
    metrics = port_eval.main(["--data_path", scene, "--out_dir",
                              str(tmp_path / "ev"), "--ckpt_dir", save_dir,
                              "--device", "cpu"] + TRAIN_OPTS)
    assert metrics["step"] == 2 and np.isfinite(metrics["psnr_hdr_vol"])
    res = port_rp.main(["--data_path", scene, "--ckpt_dir", save_dir,
                        "--config", CONFIG, "--out", str(tmp_path / "f"),
                        "--n_views", "1", "--path", "interp", "--device",
                        "cpu"] + TRAIN_OPTS)
    assert res["step"] == 2
    assert "[render_path] restored step 2" in capsys.readouterr().out
