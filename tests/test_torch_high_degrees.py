"""IPE degrees above 16 and viewdir degrees above 4, on the CPU.

JAX's kernels build any number of degrees (`_ipe96x` takes any L,
`_pe27` any deg_view). The port's CUDA builds take as many as a build's
activation tile and shared memory hold (`kernels/shapes.py`
`max_degrees`, `max_deg_view`: 21 IPE degrees in every build, the
128-column g_x and d x products; deg_view 42 with identity in the
128 / 64 build, 20 in the wider ones), so the card refuses more, naming
the key and the build's limit; the plain versions on the CPU take any,
as JAX's kernels do. Here, at `nerf.max_deg_point 20` (20 IPE degrees,
120 features) and `nerf.deg_view 6` (39 viewdir codes with identity),
narrow bf16 MLPs (trunk 128, view branch 64) with bridged parameters:

- the route: taken on the card and on the CPU; per build, the limits and
  the refusal one step past each; kernel 5's key at the 1,024 widths;
- kernel 2's forward and backward and kernel 4 (with normals) through
  their plain versions against JAX's Pallas kernels in interpret mode,
  at the tolerances of tests/test_torch_kernel_shapes.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pano_nerf_tpu.kernels.fused_mlp_ipe import fused_mlp_ipe_apply as jax_k2
from pano_nerf_tpu.kernels.fused_render import fused_render_level as jax_k4
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.engine.system import build_system
from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
from pano_nerf_tpu_torch.kernels import fused_render as fr
from pano_nerf_tpu_torch.kernels import fused_render_train as k5
from pano_nerf_tpu_torch.kernels import shapes
from pano_nerf_tpu_torch.models import build_model
from pano_nerf_tpu_torch.models.base import kernel_build_gaps

from test_torch_wide_widths import (ORDER, _flat, _level_inputs, _mlp_loss,
                                    models as wide_models, rel)
import torch_threads  # noqa: F401  (tests/torch_threads.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
HIGH = ["nerf.max_deg_point", "20", "nerf.deg_view", "6"]
L, DV = 20, 6


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")


def test_more_degrees_run_on_the_cpu_and_are_refused_on_the_card():
    """20 IPE degrees and deg_view 6 (refused on the card until the builds
    took more than 16 and 4) run on the card's builds and on the CPU."""
    hp = load_config(CONFIG, HIGH + ["nerf.mlp.net_width", "64",
                                     "nerf.mlp.net_width_condition", "32"])
    model = build_model(hp)
    assert model.kernels
    assert kernel_build_gaps(model.cfg, torch.device("cpu")) == []
    assert kernel_build_gaps(model.cfg, torch.device("cuda")) == []
    assert build_system(hp, device="cpu").model.kernels
    mlp = model.mlp
    assert (mlp.xyz_dim, mlp.view_dim) == (6 * L, 3 + 6 * DV)
    for dev in ("cuda", "cpu"):
        dev = torch.device(dev)
        k2.check_kernel_support(mlp, 0, L, dev)
        fr.check_kernel_support(mlp, 8, 0, L, DV, dev)
        k5.check_kernel_support(mlp, 8, 0, L, DV, dev)


# build (trunk / view branch) -> (IPE degrees, deg_view with identity) it
# takes at most, by `shapes.smem_bytes` and the tile.
LIMITS = {(128, 64): (21, 42), (256, 128): (21, 20), (512, 256): (21, 20),
          (1024, 512): (21, 20)}


@pytest.mark.parametrize("W,VW", sorted(LIMITS))
def test_each_build_takes_its_limits_and_refuses_one_past(W, VW):
    """At each build's widths the card's gate takes the build's most IPE
    degrees and deg_view and refuses one more, naming the key and the
    limit; the CPU takes both."""
    top_l, top_v = LIMITS[W, VW]
    build = shapes.MlpShape(W=W, VW=VW)
    assert shapes.max_degrees(build) == top_l
    assert shapes.max_deg_view(build) == top_v
    widths = ["nerf.mlp.net_width", str(W), "nerf.mlp.net_width_condition",
              str(VW)]
    name = f"the {W} / {VW} build"
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for key, top, what in (("nerf.max_deg_point", top_l, "IPE degrees"),
                           ("nerf.deg_view", top_v, "deg_view")):
        cfg = build_model(load_config(CONFIG, widths + [key, str(top)])).cfg
        assert kernel_build_gaps(cfg, cuda) == [], key
        cfg = dataclasses.replace(cfg, **{key.split(".")[1]: top + 1})
        assert kernel_build_gaps(cfg, cpu) == []
        want = (f"nerf.min_deg_point..max_deg_point 0..{top + 1} ({name} "
                f"takes up to {top} IPE degrees)" if what == "IPE degrees"
                else f"nerf.deg_view {top + 1} ({name} takes deg_view up "
                f"to {top})")
        assert kernel_build_gaps(cfg, cuda) == [want]
        assert shapes.encoding_gaps(shapes.MlpShape(
            W=W, VW=VW, L=16 if what == "deg_view" else top + 1,
            VF=27 if what == "IPE degrees" else 3 + 6 * (top + 1)))


def test_kernel5_key_at_the_1024_widths_takes_the_kernel_route():
    """A model at E's widths (trunk 1,024, view branch 512) with
    `nerf.use_train_render_kernel` takes the kernel route on the card's
    gate: kernel 5 runs on the 1,024 build's CTA pair."""
    hp = load_config(CONFIG, ["nerf.mlp.net_width", "1024",
                              "nerf.mlp.net_width_condition", "512",
                              "nerf.use_train_render_kernel", "True"])
    model = build_model(hp)
    assert model.kernels and model.cfg.use_train_render_kernel
    assert kernel_build_gaps(model.cfg, torch.device("cuda")) == []
    assert shapes.build_of(model.mlp).W == shapes.PAIR_W
    k5.check_kernel_support(model.mlp, 56, 0, 16, 4, torch.device("cuda"))


def models():
    """Bridged bf16 MLPs (trunk 128, view branch 64) at 20 IPE degrees and
    deg_view 6 with identity: (JAX params, a fresh port module)."""
    return wide_models(W=128, VW=64, x_dim=6 * L, v_dim=3 + 6 * DV)


def test_ipe_plain_version_matches_pallas_kernel_at_20_degrees(interpret):
    """Kernel 2 forward and backward: outputs atol 5e-3, parameter
    gradients rel-norm 2e-2, moment gradients 5e-2."""
    params, mlp = models()
    rng = np.random.default_rng(1)
    M = 40
    means = (rng.normal(size=(M, 3)) * 2).astype(np.float32)
    covs = (np.abs(rng.normal(size=(M, 3))) * 0.01).astype(np.float32)
    v = (rng.normal(size=(M, mlp.view_dim)) * 0.5).astype(np.float32)

    def f(p, m):
        outs = jax_k2(p, m, jnp.asarray(covs), jnp.asarray(v), 5, 0, L)
        return _mlp_loss(outs), outs
    (_, j_out), (j_gp, j_gm) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(means))
    m = torch.tensor(means, requires_grad=True)
    p_out = k2.fused_mlp_ipe_apply(mlp, m, torch.tensor(covs),
                                   torch.tensor(v), min_deg=0, max_deg=L)
    _mlp_loss(p_out).backward()
    for a, b in zip(p_out, j_out[:2]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=5e-3, rtol=0)
    p_gp = _flat({n: p.grad for n, p in mlp.named_parameters()})
    assert rel(p_gp, np.asarray(ravel_pytree(j_gp)[0])) < 2e-2
    assert rel(m.grad.numpy(), np.asarray(j_gm)) < 5e-2


def test_render_plain_version_matches_pallas_kernel_at_high_degrees(
        interpret):
    """Kernel 4 with normals and extras at deg_view 6, at
    tests/test_torch_fused_render.py's tolerances."""
    params, mlp = models()
    x = _level_inputs()
    want = jax.jit(lambda p, *xs: jax_k4(p, *xs, 5, 0, L, DV, -1.0, 0.0,
                                         False, True, True))(
        params, *(x[k] for k in ORDER))
    with torch.no_grad():
        got = fr.fused_render_level(
            mlp, *(torch.tensor(x[k]) for k in ORDER), min_deg=0, max_deg=L,
            deg_view=DV, density_bias=-1.0, rgb_padding=0.0,
            white_bkgd=False, need_normals=True, need_extras=True)
    for k, tol in (("rgb", 2e-2), ("distance", 2e-2), ("acc", 1e-2),
                   ("weights", 1e-2), ("albedo", 2e-2), ("roughness", 2e-2),
                   ("ort", 2e-2)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=tol, err_msg=k)
    cos = np.sum(got["normal"].numpy() * np.asarray(want["normal"]), -1)
    assert np.median(cos) > 0.998 and np.all(cos > 0.85), cos
