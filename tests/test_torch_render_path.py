"""`python -m pano_nerf_tpu_torch.render_path` and its pose and figure
helpers against the JAX package's `scripts/render_path.py` pipeline, on
the CPU.

- `utils/vis.py`: `gen_render_path`, `create_spheric_poses`,
  `create_spiral_poses` (atol 1e-6), `visualize_depth` and the frame
  stackers against pano_nerf_tpu/utils/vis.py;
- `data/pano_dataset.py` `pano_rays_for_pose` against the script's;
- one frame of each family (Pano-NeRF through kernel 4's plain version,
  the HDR preset through the route of kernels 2 and 3, mip-NeRF), from
  the same pose of a 16x32 synthetic scene's path and the same bridged
  parameters, against JAX's render of it (f32, atol 1e-4);
- a 2-step training run of the shadow preset, then `render_path
  --device cpu` on its checkpoint: three EXR + PNG frames.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from pano_nerf_tpu.core.config import load_config as jax_load_config
from pano_nerf_tpu.data.pano_dataset import PanoDataset as JaxDataset
from pano_nerf_tpu.engine import validation as jax_val
from pano_nerf_tpu.engine.system import build_system as jax_build_system
from pano_nerf_tpu.utils import vis as jax_vis
from pano_nerf_tpu_torch import render_path as port_rp
from pano_nerf_tpu_torch import train as port_train
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.data.io_exr import read_exr
from pano_nerf_tpu_torch.data.pano_dataset import (PanoDataset,
                                                   pano_rays_for_pose)
from pano_nerf_tpu_torch.data.synthetic import generate_scene
from pano_nerf_tpu_torch.engine.system import build_system
from pano_nerf_tpu_torch.utils import vis
from pano_nerf_tpu_torch.utils.params import params_to_jax

from test_torch_train_step import f32_on_the_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {name: os.path.join(REPO, "configs", f"{name}.yaml")
           for name in ("panonerf", "panonerf_hdr", "mipnerf")}
OPTS = ["nerf.num_samples", "8", "nerf.num_env_samples", "4",
        "nerf.num_ray_samples", "4", "nerf.mlp.net_width", "64",
        "nerf.mlp.net_width_condition", "32", "val.chunk_size", "128",
        "train.factor", "1", "val.factor", "1", "train.sample_num",
        "'n0_1_2'", "train.precision", "'f32'"]


def _script():
    """scripts/render_path.py, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_render_path_script", os.path.join(REPO, "scripts",
                                               "render_path.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    c2ws = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        c2ws[i, :3, :3] = q * np.sign(np.diag(r))
        c2ws[i, :3, 3] = rng.normal(size=3)
    return c2ws


@pytest.mark.parametrize("n_views", [1, 3, 7, 30])
def test_gen_render_path_matches_jax(n_views):
    c2ws = _rotations(4, n_views)
    want = jax_vis.gen_render_path(c2ws, n_views=n_views)
    got = vis.gen_render_path(c2ws, n_views=n_views)
    assert got.shape == want.shape == (4 * max(1, n_views // 3), 4, 4)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_spheric_and_spiral_poses_match_jax():
    np.testing.assert_allclose(vis.create_spheric_poses(1.3, 17),
                               jax_vis.create_spheric_poses(1.3, 17),
                               atol=1e-6)
    radii = np.array([0.5, 0.3, 0.2])
    np.testing.assert_allclose(vis.create_spiral_poses(radii, 2.0, 23),
                               jax_vis.create_spiral_poses(radii, 2.0, 23),
                               atol=1e-6)


def test_depth_figure_and_stackers_match_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0, 9, (6, 10, 1)).astype(np.float32)
    np.testing.assert_allclose(vis.visualize_depth(depth),
                               jax_vis.visualize_depth(depth), atol=1e-6)
    imgs = [rng.uniform(size=(6, 10, 3)).astype(np.float32),
            rng.uniform(size=(6, 10, 1)).astype(np.float32),
            rng.uniform(size=(6, 10, 3)).astype(np.float32)]
    for name, args in (("vstack_img", (imgs,)), ("hstack_img", (imgs,)),
                       ("stack_frame", (imgs, (2, 2))),
                       ("stack_frame", (imgs, (1, 3)))):
        np.testing.assert_array_equal(getattr(vis, name)(*args),
                                      getattr(jax_vis, name)(*args))


def test_pano_rays_for_pose_matches_the_script():
    want = _script().pano_rays_for_pose(np.array([0.1, -0.2, 0.3]), 8, 16,
                                        0.0, 10.0)
    got = pano_rays_for_pose(np.array([0.1, -0.2, 0.3]), 8, 16, 0.0, 10.0)
    for k in got._fields:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rp") / "scene")
    generate_scene(path, n_views=4, height=16, width=32, seed=0)
    return path


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_path_frame_matches_jax(monkeypatch, scene, name):
    """The path's second frame as the port renders it (`render_frame`)
    and as the script's pipeline renders it (its rays, JAX's system and
    `render_full_pano`), every product at f32 atol 1e-4; Pano-NeRF's
    normal (kernel 4's plain version, where JAX takes its standard path)
    and the surface products that integrate relu(N.L) as
    tests/test_torch_render.py `test_render_matches_jax_f32` holds them:
    cosine above 0.9999, surf_rgb and shading on the rays whose normals
    agree to 8e-4 rad, at least 98% of them (a normal turned by up to
    8e-4 rad moves relu(N.L) by that much, so those two at rel 1e-3)."""
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    # Kernel 4's plain version takes only the full width.
    opts = OPTS + (["nerf.mlp.net_width", "256",
                    "nerf.mlp.net_width_condition", "128"]
                   if name == "panonerf" else [])
    hp = port_rp.prepare_hparams(load_config(CONFIGS[name], opts))
    jhp = jax_load_config(CONFIGS[name], opts)
    jhp["train.sample_num"] = hp["train.sample_num"]
    ds = PanoDataset(scene, split="train", factor=1,
                     num=hp["train.sample_num"])
    jds = JaxDataset(scene, split="train", factor=1,
                     num=hp["train.sample_num"])
    c2ws = np.stack([np.asarray(m) for m in ds.camtoworlds])
    origins = port_rp.path_origins(c2ws, "interp", 3)
    want_origins = jax_vis.gen_render_path(
        np.stack([np.asarray(m) for m in jds.camtoworlds]), 3)[:, :3, 3]
    np.testing.assert_allclose(origins, want_origins, atol=1e-6)

    system = f32_on_the_kernels(build_system(hp, device="cpu", init_seed=3))
    jsys = jax_build_system(jhp)
    if system.surface:
        system.set_env_rays(ds.generate_lit_rays(num=4, far=10.0))
        jsys.set_env_rays(jds.generate_lit_rays(num=4, far=10.0))
    params = system.model.mlp.state_dict()
    got = port_rp.render_frame(
        system.make_render_image(system.surface), params, origins[1],
        ds.h, ds.w, 0.0, 10.0, torch.device("cpu"))
    rays = _script().pano_rays_for_pose(np.asarray(want_origins[1]), jds.h,
                                        jds.w, 0.0, 10.0)
    want = jax_val.render_full_pano(
        jsys.make_render_image(enable_surf=system.surface),
        jax.tree.map(jax.numpy.asarray, params_to_jax(params)), rays,
        jds.h, jds.w)
    assert set(got) == set(want)
    kernel4 = name == "panonerf"
    cos = np.sum(got["normal"] * want["normal"], -1)
    same = cos > 1 - 3e-7
    for k in want:
        assert got[k].shape == want[k].shape == (16, 32, want[k].shape[-1])
        if kernel4 and k == "normal":
            assert cos.min() > 0.9999, cos.min()
        elif kernel4 and k in ("surf_rgb", "shading"):
            assert same.mean() > 0.98, same.mean()
            np.testing.assert_allclose(got[k][same], want[k][same],
                                       rtol=1e-3, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4,
                                       err_msg=k)


TRAIN_OPTS = OPTS + ["nerf.env_distill_samples", "4", "train.batch_size",
                     "16", "log_every_n_step", "1",
                     "val.check_every_n_epoch", "0.002",
                     "optimizer.max_steps", "2", "train.steps_per_call", "2"]


def test_train_two_steps_then_render_path(scene, tmp_path, capsys):
    """`train --config configs/panonerf_shadow.yaml` for 2 steps, then
    `render_path --device cpu` on its checkpoint: three frames along the
    interpolated path, each an EXR (half-float HDR, finite, the rendered
    radiance) and a PNG."""
    config = os.path.join(REPO, "configs", "panonerf_shadow.yaml")
    trainer = port_train.main(["--data_path", scene, "--out_dir",
                               str(tmp_path / "exp"), "--config", config,
                               "--device", "cpu", "--init_seed", "0"]
                              + TRAIN_OPTS)
    assert trainer.ckpt.steps() == [2]
    assert trainer.system.model.cfg.env_distill_samples == 4
    out = str(tmp_path / "frames")
    video = str(tmp_path / "path.gif")
    res = port_rp.main(["--data_path", scene, "--ckpt_dir",
                        trainer.hparams["save_dir"], "--config", config,
                        "--out", out, "--n_views", "3", "--path", "interp",
                        "--video", video, "--device", "cpu"] + TRAIN_OPTS)
    assert res["step"] == 2 and res["size"] == (16, 32)
    assert sorted(os.listdir(out)) == [f"{i:04d}.{ext}" for i in range(3)
                                       for ext in ("exr", "png")]
    for i in range(3):
        hdr = read_exr(os.path.join(out, f"{i:04d}.exr"))
        assert hdr.shape[:2] == (16, 32) and np.all(np.isfinite(hdr))
        with open(os.path.join(out, f"{i:04d}.png"), "rb") as fp:
            assert fp.read(8) == b"\x89PNG\r\n\x1a\n"
    printed = capsys.readouterr().out
    assert "[render_path] restored step 2" in printed
    assert os.path.exists(video) or "video export skipped" in printed
    system = build_system(port_rp.prepare_hparams(load_config(
        config, TRAIN_OPTS)), device="cpu")
    ds = PanoDataset(scene, split="train", factor=1, num=[0, 1, 2])
    system.set_env_rays(ds.generate_lit_rays(num=4, far=10.0))
    origin = port_rp.path_origins(
        np.stack([np.asarray(m) for m in ds.camtoworlds]), "interp", 3)[0]
    want = port_rp.render_frame(system.make_render_image(True),
                                trainer.ckpt.restore()["params"], origin,
                                16, 32, 0.0, 10.0, torch.device("cpu"))
    np.testing.assert_allclose(read_exr(os.path.join(out, "0000.exr"))[
        ..., :3], want["rgb_fine"], rtol=2e-3, atol=1e-3)
    spheric = port_rp.path_origins(
        np.stack([np.asarray(m) for m in ds.camtoworlds]), "spheric", 5)
    assert spheric.shape == (5, 3) and np.all(np.isfinite(spheric))
