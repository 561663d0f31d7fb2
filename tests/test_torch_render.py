"""The port's eval slice as a whole against the JAX package, on the CPU.

A 16x32 synthetic scene is written by both packages' generators (the EXR
files must be identical); one val panorama of it is rendered by the port's
`render_fn` (the fused kernel's plain version on CPU tensors) and by the
JAX `PanoNeRFSystem.make_render_image` (its standard XLA path on the CPU),
with the same bridged parameters: in float32 at tight tolerance, then in
bf16 at the kernel-vs-plain tolerances (bf16 rounds at other places in the
two). Finally `python -m pano_nerf_tpu_torch.eval` writes the 11-product
tree and the metrics the JAX validation computes.
"""

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from pano_nerf_tpu.core.config import load_config as jax_load_config
from pano_nerf_tpu.core.rays import Rays as JaxRays
from pano_nerf_tpu.data.pano_dataset import generate_lit_rays as jax_lit
from pano_nerf_tpu.data.synthetic import generate_scene as jax_generate
from pano_nerf_tpu.engine import validation as jax_val
from pano_nerf_tpu.engine.system import PanoNeRFSystem as JaxSystem
from pano_nerf_tpu_torch import eval as port_eval
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.core.rays import rays_to_tensors
from pano_nerf_tpu_torch.data.pano_dataset import PanoDataset, generate_lit_rays
from pano_nerf_tpu_torch.data.synthetic import generate_scene
from pano_nerf_tpu_torch.engine.system import PanoNeRFSystem
from pano_nerf_tpu_torch.engine.validation import PRODUCTS
from pano_nerf_tpu_torch.utils.params import params_from_jax

from test_torch_train_step import f32_on_the_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
OPTS = ["nerf.num_samples", "8", "nerf.num_env_samples", "4",
        "nerf.num_ray_samples", "4", "val.chunk_size", "128",
        "train.factor", "1", "val.factor", "1",
        "train.sample_num", "'n0_1_2'"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    generate_scene(port_dir, n_views=4, height=16, width=32, seed=0)
    jax_generate(jax_dir, n_views=4, height=16, width=32, seed=0)
    return port_dir, jax_dir


def test_generated_scene_matches_jax(scene):
    port_dir, jax_dir = scene
    with open(os.path.join(port_dir, "transforms_all.json")) as a, \
            open(os.path.join(jax_dir, "transforms_all.json")) as b:
        assert json.load(a) == json.load(b)
    for material in ("image", "albedo", "normal", "depth"):
        for i in range(4):
            rel = os.path.join(material, f"{i:03d}.exr")
            assert filecmp.cmp(os.path.join(port_dir, rel),
                               os.path.join(jax_dir, rel), shallow=False), rel


def _render_both(scene, precision):
    port_dir, _ = scene
    opts = OPTS + ["train.precision", f"'{precision}'"]
    ds = PanoDataset(port_dir, split="val", factor=1, num=[0, 1, 2])
    rays_np = [x.reshape(-1, x.shape[-1]) for x in ds[0][0]]

    jhp = jax_load_config(CONFIG, opts)
    jhp["train.sample_num"] = [0, 1, 2]
    jsys = JaxSystem(jhp)
    jsys.set_env_rays(jax_lit(num=4, far=10.0))
    params = jax.tree.map(np.asarray,
                          jsys.model.init(jax.random.PRNGKey(0)))
    want = jsys.make_render_image(enable_surf=True)(params,
                                                    JaxRays(*rays_np))
    want = {k: np.asarray(v) for k, v in want.items()}

    thp = load_config(CONFIG, opts)
    tsys = f32_on_the_kernels(PanoNeRFSystem(thp, device="cpu"))
    tsys.set_env_rays(generate_lit_rays(num=4, far=10.0))
    rays = rays_to_tensors(JaxRays(*rays_np), torch.device("cpu"))
    got = tsys.make_render_image(enable_surf=True)(params_from_jax(params),
                                                   rays)
    with torch.no_grad():
        acc = tsys.model(rays, tsys.env_rays, False, True)[-1].acc.numpy()
    return {k: v.numpy() for k, v in got.items()}, want, acc


def test_render_matches_jax_f32(monkeypatch, scene):
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    got, want, acc = _render_both(scene, "f32")
    assert set(got) == set(want)
    for k in ("rgb_coarse", "dep_coarse", "rgb_fine", "dep_fine",
              "albedo", "roughness"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    on = acc > 1e-3
    assert on.sum() > 100
    cos = np.sum(got["normal"] * want["normal"], -1)
    assert cos[on].min() > 0.9999, cos[on].min()
    # surf_rgb and shading integrate the env radiance (up to ~9) against
    # relu(N.L), so they amplify the normal's direction. A ReLU unit within
    # float32 summation noise of zero flips between the two frameworks and
    # turns a few rays' normals by ~1e-3 rad; compare the rays whose
    # normals agree to 8e-4 rad (cos > 1 - 3e-7) and require them to be
    # nearly all.
    same = cos > 1 - 3e-7
    assert same.mean() > 0.98, same.mean()
    np.testing.assert_allclose(got["surf_rgb"][same], want["surf_rgb"][same],
                               atol=1e-4)
    # shading is the un-scaled irradiance (surf_rgb = albedo/pi * shading).
    np.testing.assert_allclose(got["shading"][same], want["shading"][same],
                               rtol=2e-4, atol=1e-4)


def test_render_matches_jax_bf16(monkeypatch, scene):
    monkeypatch.delenv("PANO_NERF_PALLAS_INTERPRET", raising=False)
    got, want, _ = _render_both(scene, "bf16")
    for k, tol in (("rgb_coarse", 2e-2), ("dep_coarse", 2e-2),
                   ("rgb_fine", 2e-2), ("dep_fine", 2e-2),
                   ("albedo", 2e-2), ("roughness", 2e-2)):
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)
    # At random init many rays' expected normals average nearly cancelling
    # per-sample density gradients, and a bf16 rounding that lands on the
    # other side of a ReLU in one framework turns them: bound the
    # distribution. (The 12-ray kernel test bounds every ray by 0.85; over
    # this panorama's 512 rays 1 to 4 fall below it.)
    cos = np.sum(got["normal"] * want["normal"], -1)
    assert np.median(cos) > 0.998, np.median(cos)
    assert np.mean(cos > 0.85) > 0.99, np.sort(cos)[:8]
    # surf/shading integrate relu(N.L): compare where the normals agree.
    ok = cos > 0.99
    np.testing.assert_allclose(got["surf_rgb"][ok], want["surf_rgb"][ok],
                               rtol=0.1, atol=3e-2)


def test_eval_entry_writes_products_and_metrics(scene, tmp_path):
    port_dir, _ = scene
    out = str(tmp_path / "out")
    metrics = port_eval.main(["--data_path", port_dir, "--out_dir", out,
                              "--init_seed", "0", "--device", "cpu",
                              "--config", CONFIG] + OPTS)
    tree = os.path.join(out, "eval_000000")
    assert sorted(os.listdir(tree)) == sorted(PRODUCTS)
    assert len(PRODUCTS) == 11
    for p in PRODUCTS:
        assert len(os.listdir(os.path.join(tree, p))) == 1, p
    assert metrics["num_images"] == 1 and metrics["device"] == "cpu"

    # The same panorama's metrics through the JAX validation code.
    ds = PanoDataset(port_dir, split="val", factor=1, num=[0, 1, 2])
    thp = port_eval.prepare_hparams(load_config(CONFIG, OPTS))
    sys_ = PanoNeRFSystem(thp, device="cpu", init_seed=0)
    train = PanoDataset(port_dir, split="train", factor=1, num=[0, 1, 2])
    sys_.set_env_rays(train.generate_lit_rays(num=4, near=0.0, far=10.0))
    from pano_nerf_tpu_torch.engine.validation import render_full_pano
    rays, gt_rgb, gt_depth, gt_normal, gt_albedo = ds[0]
    products = render_full_pano(sys_.make_render_image(), None, rays, ds.h,
                                ds.w, torch.device("cpu"))
    want = jax_val.validation_metrics(products, gt_rgb, gt_depth, gt_normal,
                                      gt_albedo, 0.0, 10.0)
    for k, v in want.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-3, atol=1e-4,
                                   err_msg=k)
