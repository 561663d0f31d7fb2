"""The port's dispatch of train steps against the JAX package's, on the CPU.

The JAX trainer runs `train.steps_per_call` steps per dispatch where
`_group_ok` allows it and single steps at the edges and through the
cooldown after a recovery (pano_nerf_tpu/engine/trainer.py); the port
does the same, with CUDA graphs on the card and K eager steps on the CPU.
Here: the dispatch sequences of both trainers over a table of cadences
(their step functions replaced by counting stand-ins, so nothing trains),
a NaN rewind and the cooldown after it, K = 4 against K = 1 on real steps
(bit-equal on the CPU), the learning-rate table, the rollback a capture
uses after its warm-up, the train step with the card's Adam (capturable,
learning rate read on the device) against the JAX step, and the eval
entry on a port checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.core.config import load_config as jax_load_config
from pano_nerf_tpu.engine import schedule as jax_schedule
from pano_nerf_tpu.engine.checkpoint import Checkpointer as JaxCheckpointer
from pano_nerf_tpu.engine.trainer import Trainer as JaxTrainer
from pano_nerf_tpu_torch import eval as port_eval
from pano_nerf_tpu_torch import train as port_train
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.core.rays import rays_to_tensors
from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
from pano_nerf_tpu_torch.data.synthetic import generate_scene
from pano_nerf_tpu_torch.engine import schedule, system as port_system
from pano_nerf_tpu_torch.engine import validation as val_lib
from pano_nerf_tpu_torch.engine.checkpoint import Checkpointer
from pano_nerf_tpu_torch.engine.system import TrainState
from pano_nerf_tpu_torch.engine.trainer import Trainer, group_ok

import test_torch_train_step as ts
import torch_threads  # noqa: F401  (tests/torch_threads.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
OPTS = ["train.factor", "1", "val.factor", "1", "train.sample_num", "'n0_1'",
        "nerf.num_samples", "6", "nerf.num_env_samples", "3",
        "nerf.num_ray_samples", "4", "train.batch_size", "16",
        "val.chunk_size", "256", "train.precision", "'f32'"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "s")
    generate_scene(path, n_views=3, height=16, width=32, seed=0)
    return path


# (max_steps, steps_per_call, log_every, val_every, surface_start_step,
#  dispatch that returns a non-finite loss with poisoned parameters)
CASES = [(16, 4, 4, 1000, 0, None), (12, 2, 4, 1000, 5, None),
         (24, 3, 6, 12, 4, None), (13, 4, 4, 1000, 0, None),
         (30, 4, 4, 8, 0, 4), (30, 4, 4, 8, 5, 6)]


def _jax_dispatches(trainer, tmp, case):
    max_steps, spc, log_every, val_every, sss, poison = case
    trainer.max_steps, trainer.log_every = max_steps, log_every
    trainer.val_every, trainer.surface_start_step = val_every, sss
    trainer.hparams["train.steps_per_call"] = spc
    trainer.ckpt = JaxCheckpointer(str(tmp / "jax_ckpt"))
    trainer.validate = lambda *a, **k: None
    seen = []

    def make(dataset, enable_surf, batch, steps_per_call=1):
        def fn(state, key):
            seen.append((int(state.step), steps_per_call, enable_surf))
            params = state.params
            loss = jnp.float32(1.0)
            if len(seen) == poison:
                params = jax.tree.map(lambda x: x * jnp.nan, params)
                loss = jnp.float32(jnp.nan)
            return state._replace(step=state.step + steps_per_call,
                                  params=params), {"loss": loss}
        return fn

    trainer.system.make_train_step_device_data = make
    trainer.fit(sanity_val=False)
    return seen


def _port_dispatches(trainer, tmp, case):
    max_steps, spc, log_every, val_every, sss, poison = case
    trainer.max_steps, trainer.log_every = max_steps, log_every
    trainer.val_every, trainer.surface_start_step = val_every, sss
    trainer.hparams["train.steps_per_call"] = spc
    trainer.ckpt = Checkpointer(str(tmp / "port_ckpt"))
    trainer.validate = lambda *a, **k: None
    seen = []

    def make(state, dataset, gen, enable_surf, batch, steps_per_call=1):
        def run(st):
            seen.append((st.step, steps_per_call, enable_surf))
            st.step += steps_per_call
            loss = torch.tensor(1.0)
            if len(seen) == poison:
                loss = torch.tensor(float("nan"))
                with torch.no_grad():
                    for p in trainer.system.model.mlp.parameters():
                        p.mul_(float("nan"))
            return {"loss": loss}, loss[None]
        return run

    trainer.system.make_train_step_device_data = make
    trainer.fit(sanity_val=False)
    return seen


def test_dispatch_sequence_matches_jax(scene, tmp_path):
    """Single and grouped dispatches at the same steps with the same
    surface flag as the JAX trainer, across log, validation and surface
    boundaries, a ragged end, and a NaN rewind with its single-step
    cooldown (the last two cases)."""
    jhp = jax_load_config(CONFIG, OPTS + ["optimizer.max_steps", "8"])
    jhp = port_train.prepare_hparams(dict(
        jhp, data_path=scene, out_dir=str(tmp_path / "jax"), range=[0, 10],
        **{"train.nan_recovery": 2, "parallel.num_devices": 1}))
    jhp["save_dir"] = str(tmp_path / "jax")
    jax_trainer = JaxTrainer(jhp)
    hp = load_config(CONFIG, OPTS + ["optimizer.max_steps", "8"])
    hp = port_train.prepare_hparams(dict(
        hp, data_path=scene, out_dir=str(tmp_path / "port"), range=[0, 10],
        **{"train.nan_recovery": 2}))
    trainer = Trainer(hp, device="cpu", init_seed=0)
    for i, case in enumerate(CASES):
        case_dir = tmp_path / f"case{i}"
        case_dir.mkdir()
        want = _jax_dispatches(jax_trainer, case_dir, case)
        got = _port_dispatches(trainer, case_dir, case)
        assert got == want, case
        assert sum(k > 1 for _, k, _ in got) > 0, case
        if case[-1] is not None:   # rewound once, then single steps
            rewind = case[-1]
            failed_at = got[rewind - 1][0] + got[rewind - 1][1]
            after = got[rewind:]
            assert after[0][0] < failed_at
            assert all(k == 1 for s, k, _ in after
                       if s < failed_at + case[2])


@pytest.mark.parametrize("step,spc,max_steps,log,val,sss,surf,want", [
    (0, 4, 12, 4, 6, 5, True, True),
    (2, 4, 12, 4, 6, 5, True, False),      # a log boundary inside
    (4, 4, 12, 4, 6, 5, True, False),      # a validation boundary inside
    (8, 4, 12, 4, 6, 5, True, True),
    (9, 4, 12, 100, 100, 5, True, False),  # past max_steps
    (3, 4, 12, 100, 100, 5, True, False),  # the surface flag changes
    (3, 4, 12, 100, 100, 5, False, True),  # ... unless there is none
    (5, 4, 12, 100, 100, 5, True, True),   # it changes before the group
    (7, 1, 12, 100, 100, 0, True, False)])
def test_group_ok_rules(step, spc, max_steps, log, val, sss, surf, want):
    assert group_ok(step, spc, max_steps, log, val, sss, surf) == want


def _fit(scene, out, spc, max_steps=12):
    hp = load_config(CONFIG, OPTS + [
        "optimizer.max_steps", str(max_steps), "log_every_n_step", "4",
        "val.check_every_n_epoch", "1", "train.surface_start_step", "6",
        "train.steps_per_call", str(spc)])
    hp = port_train.prepare_hparams(dict(hp, data_path=scene, out_dir=out,
                                         range=[0, 10]))
    trainer = Trainer(hp, device="cpu", init_seed=0)
    seen = []
    make = trainer.system.make_train_step_device_data

    def recording(state, dataset, gen, surf, batch, k=1):
        run = make(state, dataset, gen, surf, batch, k)

        def wrapped(st):
            seen.append((st.step, k, surf))
            return run(st)
        return wrapped

    trainer.system.make_train_step_device_data = recording
    trainer.fit(sanity_val=False)
    with open(os.path.join(hp["save_dir"], "metrics.jsonl")) as fp:
        recs = [json.loads(line) for line in fp]
    return trainer, seen, recs


def test_steps_per_call_equals_single_steps(scene, tmp_path):
    """K = 4 and K = 1 over 12 steps that cross two log boundaries and the
    surface start (step 6): the same parameters, Adam state, generator
    state and logged scalars (bit-equal: on the CPU a group is the same
    eager steps in the same order)."""
    grouped, seen4, recs4 = _fit(scene, str(tmp_path / "k4"), 4)
    single, seen1, recs1 = _fit(scene, str(tmp_path / "k1"), 1)
    assert seen4 == [(0, 4, False), (4, 1, False), (5, 1, False),
                     (6, 1, True), (7, 1, True), (8, 4, True)]
    assert seen1 == [(s, 1, s >= 6) for s in range(12)]
    a = grouped.ckpt.restore()
    b = single.ckpt.restore()
    assert a["step"] == b["step"] == 12
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    for p, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][p][k]), (p, k)
    assert torch.equal(a["generator"], b["generator"])

    def scalars(recs):
        return [{k: v for k, v in r.items() if k != "rays_per_sec"}
                for r in recs if r["kind"] == "train"]
    assert scalars(recs4) == scalars(recs1)
    assert [r["step"] for r in scalars(recs4)] == [4, 8, 12]
    assert scalars(recs4)[0].get("vol_surface") is None
    assert np.isfinite(scalars(recs4)[-1]["vol_surface"])


def test_lr_table_matches_numpy_and_jax():
    args = (1e-3, 5e-6, 44000, 120, 0.01)
    table = schedule.lr_table(*args)
    fn = schedule.mip_lr_decay(*args)
    assert table.dtype == np.float32 and table.shape == (44001,)
    for s in list(range(0, 300)) + list(range(300, 44001, 97)) + [44000]:
        assert float(table[s]) == fn(s), s
    steps = np.arange(44001)
    want = np.asarray(jax_schedule.mip_lr_decay(*args)(jnp.asarray(steps)))
    np.testing.assert_allclose(table, want, rtol=1e-6)


def test_rollback_point_restores_a_fresh_start():
    """What a capture's warm-up did (steps: parameters, Adam's lazily made
    state, the step count, the generator) is undone in place: the steps
    after it equal those of an untouched copy."""
    results = []
    for warm in (0, 3):
        system = port_system.PanoNeRFSystem(load_config(CONFIG, OPTS),
                                            device="cpu", init_seed=0)
        system.set_env_rays(generate_lit_rays(4, 0.0, 10.0))
        rays, rgbs = ts._batch()
        data = (rays_to_tensors(rays, torch.device("cpu")),
                torch.tensor(rgbs))
        gen = torch.Generator().manual_seed(3)
        state = system.create_state()
        one = system.make_device_step(data, gen, True, 8)
        params = list(system.model.mlp.parameters())
        for rounds in range(2):   # before Adam's state exists, and after
            restore = port_system.rollback_point(state, params, gen)
            for _ in range(warm):
                one(state)
            restore()
            assert state.step == rounds
            one(state)
        results.append(([p.detach().clone() for p in params],
                        {k: v.clone() for k, v in
                         state.optimizer.state[params[0]].items()},
                        gen.get_state()))
    (p0, s0, g0), (p3, s3, g3) = results
    assert all(torch.equal(a, b) for a, b in zip(p0, p3))
    assert s0.keys() == s3.keys()
    assert all(torch.equal(s0[k], s3[k]) for k in s0)
    assert torch.equal(g0, g3)


def test_capturable_adam_step_matches_jax_in_f32(monkeypatch):
    """The card's optimizer on the CPU: Adam `capturable` (step counts and
    bias corrections in f32 tensors, foreach) with the learning rate read
    from the device table at `step_t`; torch allows capturable only on
    accelerators, so its device check is widened for this test. Held to
    the f32 tolerances of the JAX comparison."""
    import torch.optim.adam as adam
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cuda", "cpu"])

    def capturable(self):
        return TrainState(step=0, optimizer=torch.optim.Adam(
            self.model.mlp.parameters(), lr=0.0, betas=(0.9, 0.999),
            eps=1e-8, capturable=True, foreach=True),
            step_t=torch.zeros((), dtype=torch.int64))

    monkeypatch.setattr(port_system.PanoNeRFSystem, "create_state",
                        capturable)
    j_parts, j_grads, j_new, parts, grads, new, hp = ts._run_both("f32")
    ts._check_f32(j_parts, j_grads, j_new, parts, grads, new, hp)


def test_eval_entry_renders_a_port_checkpoint(scene, tmp_path):
    """`--ckpt_dir` restores a port run's weights (latest, or `--step`)
    and writes the products under eval_<step>; the metrics equal a render
    of the checkpoint's weights through render_fn."""
    out = str(tmp_path / "exp")
    trainer = port_train.main([
        "--data_path", scene, "--out_dir", out, "--config", CONFIG,
        "--device", "cpu", "--init_seed", "0", "optimizer.max_steps", "4",
        "log_every_n_step", "2", "val.check_every_n_epoch", "0.002",
        "checkpoint.keep_every_n_steps", "2"] + OPTS)
    save_dir = trainer.hparams["save_dir"]
    assert trainer.ckpt.steps() == [2, 4]
    eval_out = str(tmp_path / "eval")
    argv = ["--data_path", scene, "--out_dir", eval_out, "--ckpt_dir",
            save_dir, "--device", "cpu", "--config", CONFIG] + OPTS
    latest = port_eval.main(argv)
    assert latest["step"] == 4
    assert os.path.isdir(os.path.join(eval_out, "eval_000004", "pred_hdr"))
    second = port_eval.main(argv[:-len(OPTS)] + ["--step", "2"] + OPTS)
    assert second["step"] == 2

    hp = port_eval.prepare_hparams(load_config(CONFIG, OPTS))
    system = port_system.PanoNeRFSystem(hp, device="cpu")
    ds = trainer.val_dataset
    system.set_env_rays(trainer.train_dataset.generate_lit_rays(
        num=4, near=0.0, far=10.0))
    saved = trainer.ckpt.restore(4)
    rays, gt_rgb, gt_depth, gt_normal, gt_albedo = ds[0]
    products = val_lib.render_full_pano(system.make_render_image(),
                                        saved["params"], rays, ds.h, ds.w,
                                        torch.device("cpu"))
    want = val_lib.validation_metrics(products, gt_rgb, gt_depth, gt_normal,
                                      gt_albedo, 0.0, 10.0)
    for k, v in want.items():
        assert latest[k] == v, k
