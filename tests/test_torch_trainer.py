"""The port's trainer and train entry point on the CPU.

A 16x32 synthetic scene (3 views: 2 train, 1 val) trains a few steps of
`configs/panonerf.yaml` with small sample counts through `python -m
pano_nerf_tpu_torch.train --device cpu` (the plain versions of the
kernels): metrics.jsonl, validation products and checkpoints are written,
a re-run resumes, and a non-finite step rewinds, is a false alarm, or
aborts as in the JAX trainer (tests/test_trainer_integration.py). The
flat train split equals the JAX dataset's.
"""

import json
import os

import numpy as np
import pytest
import torch

from pano_nerf_tpu.data.pano_dataset import PanoDataset as JaxDataset
from pano_nerf_tpu_torch import train as port_train
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.core.rays import RAYS_KEYS
from pano_nerf_tpu_torch.data.pano_dataset import PanoDataset
from pano_nerf_tpu_torch.data.synthetic import generate_scene
from pano_nerf_tpu_torch.engine.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
OPTS = ["train.factor", "1", "val.factor", "1", "train.sample_num", "'n0_1'",
        "nerf.num_samples", "6", "nerf.num_env_samples", "3",
        "nerf.num_ray_samples", "4", "train.batch_size", "16",
        "val.chunk_size", "256", "log_every_n_step", "2",
        "val.check_every_n_epoch", "0.002"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scene") / "s")
    generate_scene(path, n_views=3, height=16, width=32, seed=0)
    return path


def _records(out):
    with open(os.path.join(out, "panonerf_0_1", "metrics.jsonl")) as fp:
        return [json.loads(line) for line in fp]


def test_train_entry_writes_metrics_checkpoints_and_resumes(scene, tmp_path,
                                                            capsys):
    out = str(tmp_path / "exp")
    argv = ["--data_path", scene, "--out_dir", out, "--config", CONFIG,
            "--device", "cpu", "--init_seed", "0",
            "optimizer.max_steps", "4"] + OPTS
    trainer = port_train.main(argv)
    recs = _records(out)
    train = [r for r in recs if r["kind"] == "train"]
    assert [r["step"] for r in train] == [2, 4]
    for r in train:
        assert r["rays_per_sec"] > 0
        for k in ("loss", "vol_coarse", "vol_fine", "vol_surface", "chrom",
                  "ort", "dist", "sat", "vc"):
            assert k in r and r[k] == r[k], k
    assert [r["step"] for r in recs if r["kind"] == "val"] == [0, 2, 4]
    assert trainer.ckpt.steps() == [4]
    save_dir = os.path.join(out, "panonerf_0_1")
    assert len(os.listdir(os.path.join(save_dir, "val_000004",
                                       "pred_hdr"))) == 1
    first = {k: v.clone() for k, v in
             trainer.system.model.mlp.state_dict().items()}
    capsys.readouterr()

    again = port_train.main(argv)
    assert "[resume] restored step 4" in capsys.readouterr().out
    assert len(_records(out)) == len(recs)
    for k, v in again.system.model.mlp.state_dict().items():
        assert torch.equal(v, first[k]), k


def _poisoning_trainer(scene, out, poison_call, poison_params=True,
                       recovery=2):
    hp = load_config(CONFIG, OPTS + ["optimizer.max_steps", "8"])
    hp = port_train.prepare_hparams(dict(
        hp, data_path=scene, out_dir=out, range=[0, 10],
        **{"train.nan_recovery": recovery, "log_every_n_step": 1}))
    trainer = Trainer(hp, device="cpu", init_seed=0)
    calls = {"n": 0}
    make = trainer.system.make_train_step

    def make_poisoned(enable_surf):
        step = make(enable_surf)

        def wrapped(state, rays, rgbs, draws):
            parts = step(state, rays, rgbs, draws)
            calls["n"] += 1
            if calls["n"] == poison_call:
                parts = dict(parts, loss=torch.tensor(float("nan")))
                if poison_params:
                    with torch.no_grad():
                        for p in trainer.system.model.mlp.parameters():
                            p.mul_(float("nan"))
            return parts
        return wrapped

    trainer.system.make_train_step = make_poisoned
    return trainer


@pytest.mark.parametrize("mode", ["rewind", "false_alarm", "abort"])
def test_non_finite_step_is_triaged(scene, tmp_path, mode):
    out = str(tmp_path / "exp")
    trainer = _poisoning_trainer(scene, out, poison_call=4,
                                 poison_params=mode != "false_alarm",
                                 recovery=0 if mode == "abort" else 2)
    if mode == "abort":
        with pytest.raises(FloatingPointError, match="last good checkpoint"):
            trainer.fit(sanity_val=False)
        assert [r for r in _records(out) if r["kind"] == "abort"]
        return
    trainer.fit(sanity_val=False)
    recs = _records(out)
    kinds = [r["kind"] for r in recs]
    if mode == "rewind":
        rec = [r for r in recs if r["kind"] == "nan_recovery"]
        assert len(rec) == 1
        assert rec[0]["restored_step"] == 2 and rec[0]["retry"] == 1
        assert rec[0]["device_data_finite"] is True
    else:
        assert "nan_false_alarm" in kinds and "nan_recovery" not in kinds
        assert [r for r in recs if r["kind"] == "val" and r["step"] == 4]
    assert "abort" not in kinds
    assert trainer.ckpt.latest_step() == 8
    params = list(trainer.system.model.mlp.parameters())
    assert all(torch.isfinite(p).all() for p in params)


def test_train_entry_without_cpu_request_raises(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(["--data_path", scene, "--out_dir",
                         str(tmp_path / "o"), "--config", CONFIG] + OPTS)


def test_train_split_is_the_jax_flat_ray_set(scene):
    port = PanoDataset(scene, split="train", factor=1, num=[0, 1])
    ref = JaxDataset(scene, split="train", factor=1, num=[0, 1])
    assert port.num_rays == ref.num_rays == 2 * 16 * 32 == len(port)
    for k in RAYS_KEYS:
        np.testing.assert_array_equal(getattr(port.rays, k),
                                      getattr(ref.rays, k), err_msg=k)
    for k in ("images", "depths", "normals", "albedos"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    rays, rgb = port[5][:2]
    np.testing.assert_array_equal(rays.origins, ref.rays.origins[5])
    np.testing.assert_array_equal(rgb, ref.images[5])
