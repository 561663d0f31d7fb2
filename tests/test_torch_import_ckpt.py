"""Reference Lightning checkpoints imported by the port, against JAX's
conversion, on the CPU.

A synthesized Lightning `.ckpt` (`torch.save` of a `state_dict` under
`mip_nerf.mlp.` and `hyper_parameters` with `nerf.*` keys) at P1's widths
(trunk 64, view branch 32) and at the shipped widths goes through
`python -m pano_nerf_tpu_torch.import_reference_ckpt` and through JAX's
`convert_mlp_state_dict`: the two MLPs agree (f32, atol 1e-5). The
written checkpoint is served by the port's eval on the CPU and restored
into a train state (no optimizer state: Adam starts fresh), and a shape
mismatch is reported per tensor.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.models.mlp import NerfMLP as JaxMLP
from pano_nerf_tpu.utils.import_torch import (
    convert_mlp_state_dict as jax_convert)
from pano_nerf_tpu_torch import eval as port_eval
from pano_nerf_tpu_torch import import_reference_ckpt as port_import
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.data.synthetic import generate_scene
from pano_nerf_tpu_torch.engine.checkpoint import Checkpointer
from pano_nerf_tpu_torch.engine.system import build_system
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.utils import import_torch
import torch_threads  # noqa: F401  (tests/torch_threads.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
WIDTHS = {"P1": (64, 32), "shipped": (256, 128)}
PREFIX = "mip_nerf.mlp."
SMALL = ["nerf.num_samples", "8", "nerf.num_env_samples", "4",
         "nerf.num_ray_samples", "4", "val.chunk_size", "128",
         "train.factor", "1", "val.factor", "1", "train.sample_num",
         "'n0_1'"]


def reference_ckpt(path, W, VW, seed=0):
    """A Lightning-style checkpoint of a reference MLP (5 density
    channels, IPE 0..16, deg-4 viewdirs with identity) at widths W / VW;
    returns its state_dict of numpy arrays."""
    ref = NerfMLP(96, 27, net_width=W, net_width_condition=VW,
                  num_density_channels=5,
                  generator=torch.Generator().manual_seed(seed))
    sd = {PREFIX + k: v.detach().clone() for k, v in ref.state_dict().items()}
    sd["mip_nerf.some_buffer"] = torch.zeros(3)
    torch.save({"state_dict": sd, "epoch": 3, "hyper_parameters": {
        "nerf.mlp.net_width": W, "nerf.mlp.net_width_condition": VW,
        "train.batch_size": 99}}, path)
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene") / "s")
    generate_scene(root, n_views=3, height=8, width=16)
    return root


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_import_matches_jax_conversion(tmp_path, name):
    W, VW = WIDTHS[name]
    ckpt = str(tmp_path / "last.ckpt")
    sd = reference_ckpt(ckpt, W, VW)
    out = port_import.main(["--torch_ckpt", ckpt, "--out_dir",
                            str(tmp_path / "out"), "--config", CONFIG,
                            "--step", "7", "train.sample_num", "'n0_1'"])
    assert out["step"] == 7
    saved = Checkpointer(os.path.join(out["ckpt_dir"], "checkpoints")
                         ).restore()
    assert saved["step"] == 7 and set(saved) == {"params", "step"}
    mlp = NerfMLP(96, 27, net_width=W, net_width_condition=VW,
                  num_density_channels=5, compute_dtype=torch.float32)
    mlp.load_state_dict(saved["params"])

    jmlp = JaxMLP(net_width=W, net_width_condition=VW,
                  num_density_channels=5, dtype=jnp.float32)
    template = jax.tree.map(np.asarray, jmlp.init(
        jax.random.PRNGKey(1), jnp.zeros((2, 96)), jnp.zeros((2, 27))))
    params = jax_convert(sd, template)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 5, 96)).astype(np.float32)
    v = rng.normal(size=(6, 1, 27)).astype(np.float32)
    want = jmlp.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                      jnp.asarray(v))
    with torch.no_grad():
        got = mlp(torch.tensor(x), torch.tensor(v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


def test_imported_checkpoint_is_served_and_restored(tmp_path, scene):
    """The P1 import rendered by the port's eval on the CPU through
    `--ckpt_dir`, and loaded into a train state with a fresh Adam."""
    ckpt = str(tmp_path / "last.ckpt")
    reference_ckpt(ckpt, *WIDTHS["P1"])
    out = port_import.main(["--torch_ckpt", ckpt, "--out_dir",
                            str(tmp_path / "out"), "--config", CONFIG,
                            *SMALL])
    metrics = port_eval.main([
        "--data_path", scene, "--out_dir", str(tmp_path / "eval"),
        "--ckpt_dir", out["ckpt_dir"], "--config", CONFIG, "--device",
        "cpu", "--max_images", "1", *SMALL, "nerf.mlp.net_width", "64",
        "nerf.mlp.net_width_condition", "32"])
    assert np.isfinite(metrics["psnr_ldr_vol"])
    assert os.path.isdir(tmp_path / "eval" / "eval_000000")

    hp = load_config(CONFIG, SMALL + ["nerf.mlp.net_width", "64",
                                      "nerf.mlp.net_width_condition", "32"])
    system = build_system(hp, device="cpu")
    state = system.create_state()
    saved = Checkpointer(os.path.join(out["ckpt_dir"], "checkpoints")
                         ).restore()
    system.restore_state(state, saved)
    assert state.step == 0
    for n, p in system.model.named_params():
        assert torch.equal(p.detach(), saved["params"][n]), n


def test_shape_mismatch_is_reported_per_tensor(tmp_path):
    """A 64-wide checkpoint forced to 128 on the command line fails
    listing each tensor whose shape differs; an unknown prefix fails
    too."""
    ckpt = str(tmp_path / "last.ckpt")
    reference_ckpt(ckpt, *WIDTHS["P1"])
    with pytest.raises(ValueError) as err:
        port_import.main(["--torch_ckpt", ckpt, "--out_dir",
                          str(tmp_path / "out"), "--config", CONFIG,
                          "train.sample_num", "'n0_1'",
                          "nerf.mlp.net_width", "128"])
    msg = str(err.value)
    for name in ("layers.0.0.weight", "layers.7.0.bias",
                 "density_layer.weight", "extra_layer.weight",
                 "view_layers.0.0.weight"):
        assert f"'{PREFIX}{name}'" in msg, name
    assert "color_layer" not in msg   # [3, 32] either way
    with pytest.raises(ValueError, match="no '\\*layers.0.0.weight'"):
        import_torch.find_mlp_prefix({"a.weight": np.zeros(1)})


def test_export_round_trips():
    mlp = NerfMLP(96, 27, net_width=64, net_width_condition=32,
                  num_density_channels=5,
                  generator=torch.Generator().manual_seed(3))
    params = dict(mlp.named_parameters())
    sd = import_torch.export_mlp_state_dict(params)
    assert all(k.startswith(PREFIX) for k in sd)
    back = import_torch.convert_mlp_state_dict(sd, mlp)
    for n, p in params.items():
        assert torch.equal(back[n], p.detach()), n
