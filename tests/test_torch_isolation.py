"""The port stands alone: no JAX, no pano_nerf_tpu, no silent CPU fallback."""

import importlib.util
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import pano_nerf_tpu_torch
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.core.device import resolve_device
import torch_threads  # noqa: F401  (tests/torch_threads.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(pano_nerf_tpu_torch.__path__,
                                          "pano_nerf_tpu_torch."))
# The port's tools beside the package (they import it and chip_smoke).
TOOLS = ["chip_smoke", "scripts.torch_kernel_ab", "scripts.torch_check_spread",
         "scripts.torch_k3_conditioning"]


def test_every_module_is_listed():
    assert "pano_nerf_tpu_torch.eval" in MODULES
    assert "pano_nerf_tpu_torch.kernels.fused_render" in MODULES
    for name in ("train", "kernels.fused_mlp_ipe", "kernels.fused_mlp_normals",
                 "kernels.fused_mlp", "kernels.fused_render_train",
                 "engine.losses", "engine.schedule", "engine.checkpoint",
                 "engine.trainer", "import_reference_ckpt",
                 "utils.import_torch", "utils.profiling", "data.png",
                 "data.perspective_datasets"):
        assert f"pano_nerf_tpu_torch.{name}" in MODULES, name
    assert len(MODULES) >= 37


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES + TOOLS!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'pano_nerf_tpu'))\n"
        "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA card")


def test_default_device_raises_without_a_card(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_render_system_without_cpu_request_raises(no_cuda):
    from pano_nerf_tpu_torch.engine.system import PanoNeRFSystem
    hp = load_config(os.path.join(REPO, "configs", "panonerf.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PanoNeRFSystem(hp)


def test_eval_entry_point_without_cpu_request_raises(no_cuda, tmp_path):
    from pano_nerf_tpu_torch import eval as port_eval
    from pano_nerf_tpu_torch.data.synthetic import generate_scene
    generate_scene(str(tmp_path / "s"), n_views=2, height=8, width=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.main(["--data_path", str(tmp_path / "s"), "--out_dir",
                        str(tmp_path / "o"), "--init_seed", "0",
                        "train.sample_num", "'n0'"])


def test_kernel_ab_script_unpacks_the_train_shapes():
    """scripts/torch_kernel_ab.py takes `chip_smoke.train_shapes`' three
    values (calls, levels, surface points) through its `train_calls`, on
    the CPU at 4 rays (the script itself needs the card)."""
    from pano_nerf_tpu_torch.core.rays import rays_to_tensors
    from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
    from pano_nerf_tpu_torch.models import build_model
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_ab", os.path.join(REPO, "scripts", "torch_kernel_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    hp = load_config(os.path.join(REPO, "configs", "panonerf.yaml"), [
        "nerf.num_samples", "4", "nerf.num_ray_samples", "3",
        "nerf.mlp.net_width", "32", "nerf.mlp.net_width_condition", "16"])
    cpu = torch.device("cpu")
    model = build_model(hp, torch.Generator().manual_seed(0))
    env = rays_to_tensors(generate_lit_rays(3, far=10.0, radius=0.0142), cpu)
    calls, levels = ab.train_calls(model, env, cpu, batch=4)
    assert set(calls) == {"coarse", "fine", "vc", "env"}
    assert set(levels) == {"coarse", "env"}
    assert tuple(calls["coarse"][1].shape) == (4, 4, 3)
    assert tuple(levels["env"][0].shape) == (4 * 3, 5, 3)


@pytest.mark.parametrize("key,value", [
    ("nerf.env_sampling", "hemisphere"), ("nerf.mlp.num_rgb_channels", 4)])
def test_unsupported_config_raises_naming_the_key(key, value):
    from pano_nerf_tpu_torch.models.base import NerfConfig
    hp = load_config(os.path.join(REPO, "configs", "panonerf.yaml"))
    hp[key] = value
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        NerfConfig.from_hparams(hp)


@pytest.mark.parametrize("key,value", [
    ("val.randomized", True), ("nerf.ray_shape", "cylinder"),
    ("nerf.disable_integration", True), ("nerf.num_levels", 3),
    ("nerf.stop_resample_grad", False)])
def test_model_keys_are_accepted(key, value):
    """The model keys refused until the port had their paths
    (tests/test_torch_levels.py and test_torch_key_switches.py hold them
    to JAX); `val.randomized` is the system's."""
    from pano_nerf_tpu_torch.models.base import NerfConfig
    hp = load_config(os.path.join(REPO, "configs", "panonerf.yaml"))
    hp[key] = value
    cfg = NerfConfig.from_hparams(hp)
    name = key.split(".")[1]
    if hasattr(cfg, name):
        assert getattr(cfg, name) == value


@pytest.mark.parametrize("key,value", [
    ("nerf.density_noise", 1.0), ("nerf.env_importance", True),
    ("nerf.env_resample", True), ("nerf.illum_field", True),
    ("nerf.env_rotation", True), ("nerf.env_sampling", "stratified")])
def test_study_switches_are_accepted(key, value):
    """The keys that were refused until the port had their paths
    (tests/test_torch_env_modes.py, test_torch_illum.py and
    test_torch_point_normals.py hold them to JAX)."""
    from pano_nerf_tpu_torch.models.base import NerfConfig
    hp = load_config(os.path.join(REPO, "configs", "panonerf.yaml"))
    hp[key] = value
    cfg = NerfConfig.from_hparams(hp)
    name = key.split(".")[1]
    assert getattr(cfg, name) == (value if name != "env_sampling"
                                  else "stratified")


@pytest.mark.parametrize("key,value", [
    ("nerf.emissive_head", True), ("nerf.chroma_head", True),
    ("nerf.mlp.net_depth", 6), ("nerf.mlp.skip_index", 3),
    ("nerf.mlp.net_depth_condition", 2), ("nerf.use_viewdirs", False),
    ("nerf.min_deg_point", 2), ("nerf.max_deg_point", 10),
    ("nerf.deg_view", 2), ("nerf.append_identity", False),
    ("train.precision", "f32")])
def test_plain_route_keys_are_accepted(key, value):
    """The keys that were refused until the port had the plain route
    (tests/test_torch_plain_route.py, test_torch_topology.py,
    test_torch_encodings.py and test_torch_heads.py hold them to JAX):
    the system is built and takes the plain route. The keys of JAX's
    predicate take it alone; an encoding key takes it with f32, and in
    bf16 the kernel route (the kernels are built for it, tests/
    test_torch_kernel_shapes.py)."""
    from pano_nerf_tpu_torch.engine.system import build_system
    from pano_nerf_tpu_torch.models.base import plain_route_reasons
    hp = load_config(os.path.join(REPO, "configs", "panonerf.yaml"))
    hp[key] = value
    if key in ("nerf.min_deg_point", "nerf.max_deg_point", "nerf.deg_view",
               "nerf.append_identity"):
        assert build_system(hp, device="cpu").model.kernels
        hp["train.precision"] = "f32"
    model = build_system(hp, device="cpu").model
    assert not model.kernels
    assert plain_route_reasons(model.cfg)
