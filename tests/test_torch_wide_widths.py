"""The 512 / 256 builds of the kernels (trunk 257..512, view branch
129..256), on the CPU.

JAX sends a bf16 model of the standard topology to its Pallas kernels at
any width. The port's CUDA builds go up to trunk 512 and view branch 256
(`kernels/shapes.py` WIDTHS, VIEW_WIDTHS): a model of 257..512 / 129..256
runs zero-padded in the 512 / 256 build (`build_shape`), whose trunk
products split at 512 columns (csrc/mlp_rows.cuh `mm`). Here, with
numpy-made inputs and bridged parameters:

- `build_shape` and `kernel_build_gaps` on the card: 257..512 / 129..256
  to the 512 / 256 build, 513 / 257 refused naming the key;
  `MlpShape.defines` of the 512 / 256 builds (D, and Dm at one density
  channel); kernel 4's 64-row tiles in that build (`plan_tiles`);
- P3 (trunk 384, view branch 192) packed into D's layout and back, the
  padded slots zero; the weight-gradient pass's job table at D (fan-ins
  split at 256, at most 32 jobs, every packed weight once);
- the plain versions of kernels 2, 3 (forward and backward), 4 and 5 at
  W 512 / VW 256 against JAX's Pallas kernels in interpret mode, at the
  tolerances of tests/test_torch_kernel_shapes.py;
- one whole Pano-NeRF train step at 512 / 256 in f32 against JAX's, at
  tests/test_torch_train_step.py's tolerances (loss parts rel 1e-5,
  gradients rel-norm 1e-4 per leaf).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pano_nerf_tpu.kernels.fused_mlp_ipe import fused_mlp_ipe_apply as jax_k2
from pano_nerf_tpu.kernels.fused_mlp_normals import (
    fused_mlp_normals_apply as jax_k3)
from pano_nerf_tpu.kernels.fused_render import fused_render_level as jax_k4
from pano_nerf_tpu.kernels.fused_render_train import (
    fused_render_train as jax_k5)
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
from pano_nerf_tpu_torch.kernels import fused_render as fr
from pano_nerf_tpu_torch.kernels import fused_render_train as k5
from pano_nerf_tpu_torch.kernels import shapes
from pano_nerf_tpu_torch.models import build_model
from pano_nerf_tpu_torch.models.base import kernel_build_gaps
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax

from test_torch_plain_route import check_step_f64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
D = shapes.MlpShape(W=512, VW=256)
WIDE = ["nerf.mlp.net_width", "512", "nerf.mlp.net_width_condition", "256"]


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def cfg():
    return build_model(load_config(CONFIG)).cfg


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---- the build a width runs in ----

def test_widths_up_to_512_run_in_the_512_build(cfg):
    cuda = torch.device("cuda")
    for w in range(257, 513):
        assert shapes.build_shape(shapes.MlpShape(W=w)).W == 512, w
        c = dataclasses.replace(cfg, mlp_net_width=w)
        assert kernel_build_gaps(c, cuda) == [], w
    for vw in range(129, 257):
        assert shapes.build_shape(shapes.MlpShape(VW=vw)).VW == 256, vw
        c = dataclasses.replace(cfg, mlp_net_width_condition=vw)
        assert kernel_build_gaps(c, cuda) == [], vw
    assert shapes.build_shape(shapes.MlpShape(W=384, VW=192)) == D


@pytest.mark.parametrize("key,field,value", [
    ("nerf.mlp.net_width", "W", 513),
    ("nerf.mlp.net_width_condition", "VW", 257)])
def test_past_the_512_build_is_refused_naming_the_key(cfg, key, field,
                                                      value):
    with pytest.raises(ValueError, match="no kernel build takes"):
        shapes.build_shape(shapes.MlpShape(**{field: value}))
    attr = dict(W="mlp_net_width", VW="mlp_net_width_condition")[field]
    c = dataclasses.replace(cfg, **{attr: value})
    assert kernel_build_gaps(c, torch.device("cuda")) == [f"{key} {value}"]
    assert kernel_build_gaps(c, torch.device("cpu")) == []


def test_defines_of_the_512_builds():
    assert D.defines() == ("NERF_W=512", "NERF_VW=256")
    assert D.defines(with_channels=False) == ("NERF_W=512", "NERF_VW=256")
    assert D._replace(C=1).defines() == ("NERF_NDC=1", "NERF_W=512",
                                         "NERF_VW=256")


def test_kernel4_tiles_64_rows_in_the_512_build():
    """The 512 build's kernel 4 runs 64-row column-split tiles (one ray
    at S = 56, 12 at S = 5), the narrower builds 128-row ones."""
    assert fr.tile_rows(D) == 64 and fr.tile_rows() == 128
    assert fr.plan_tiles(1024, 56, D)[:2] == (1, 1024)
    assert fr.plan_tiles(10240, 5, D)[:2] == (12, 854)
    assert fr.plan_tiles(1024, 56)[:2] == (2, 512)


# ---- the packed layout and the job table ----

def _mlp(W, VW, C=5, seed=0):
    mlp = NerfMLP(96, 27, net_width=W, net_width_condition=VW,
                  num_density_channels=C, compute_dtype=torch.float32,
                  generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for n, p in mlp.named_parameters():
            if n.endswith("weight"):
                p.copy_(p.to(torch.bfloat16).float())
    return mlp


def test_p3_packs_into_the_512_layout_and_back():
    mlp = _mlp(384, 192)
    assert shapes.build_of(mlp) == D
    weights, biases = fr.pack_params(mlp)
    assert weights.numel() == k2.layout(D).W_TOTAL == 2_347_008
    assert biases.numel() == 8 * 512 + 16 + 512 + 256 + 16
    back = fr.unpack_params(mlp, weights.float(), biases)
    for n, p in mlp.named_parameters():
        assert torch.equal(back[n], p.detach()), n
    w_pad, b_pad = fr.padded_slots(mlp)
    assert torch.all(weights[w_pad] == 0) and torch.all(biases[b_pad] == 0)
    assert int((~w_pad).sum()) == sum(
        p.numel() for n, p in mlp.named_parameters() if n.endswith("weight"))
    assert int((~b_pad).sum()) == sum(
        p.numel() for n, p in mlp.named_parameters() if n.endswith("bias"))


@pytest.mark.parametrize("normals", [False, True])
def test_512_job_table_splits_fan_ins_and_covers_every_weight_once(normals):
    """At D the fan-ins of 512 split into jobs of 256 columns (the pass's
    wgmma N): 24 jobs, within the kernel's 32, each within the limits
    `fused_mlp_weight_grads` checks, every packed weight written once."""
    lay = k2.layout(D)
    jobs = k2.wgrad_jobs(normals, D)
    assert len(jobs) == 24 <= k2.MAX_JOBS
    width = lay.OPW_NRM if normals else lay.OPW_IPE
    assert (lay.OPW_IPE, lay.OPW_NRM) == (9888, 17664)
    hits = torch.zeros(lay.W_TOTAL)
    for b1, a1, b2, a2, n, k, out, ldo in jobs:
        assert 0 < n and 0 < k <= k2.MAX_FAN_IN and k % 4 == 0
        assert out % 4 == 0 and ldo % 4 == 0 and ldo >= k
        assert b1 + n <= width and a1 + k <= width
        if b2 >= 0:
            assert b2 + n <= width and a2 + k <= width
        hits.as_strided((n, k), (ldo, 1), out).add_(1)
    assert int(hits.min()) == 1 and int(hits.max()) == 1


# ---- the plain versions against JAX's Pallas kernels ----

@functools.lru_cache(maxsize=None)
def _jax_params(C, W, VW, x_dim, v_dim, seed=0):
    """NerfMLP parameters in JAX's tree (numpy), made once per shape from a
    torch seed (the port's initialiser: JAX's, run op by op on the CPU,
    takes seconds at 512 columns)."""
    mlp = NerfMLP(x_dim, v_dim, net_width=W, net_width_condition=VW,
                  num_density_channels=C,
                  generator=torch.Generator().manual_seed(seed))
    return params_to_jax(mlp.state_dict())


def models(C=5, W=512, VW=256, x_dim=96, v_dim=27):
    """Bridged bf16 MLPs (by default IPE degrees 0..16, deg-4 viewdirs
    with identity): (JAX params, a fresh port module)."""
    params = _jax_params(C, W, VW, x_dim, v_dim)
    mlp = NerfMLP(x_dim, v_dim, net_width=W, net_width_condition=VW,
                  num_density_channels=C)
    mlp.load_state_dict(params_from_jax(params))
    return params, mlp


def _mlp_loss(outs):
    xp = jnp if isinstance(outs[0], jax.Array) else torch
    loss = xp.sum(xp.sin(outs[0])) + xp.sum(xp.cos(outs[1]))
    if len(outs) == 3:
        loss = loss + xp.sum(xp.sin(0.1 * outs[2]))
    return loss


def _flat(grads):
    tree = params_to_jax(grads)
    return np.asarray(ravel_pytree(jax.tree.map(jnp.asarray, tree))[0])


@pytest.mark.parametrize("normals", [False, True], ids=["k2", "k3"])
def test_mlp_plain_versions_match_pallas_kernels_at_512(interpret, normals):
    """Kernel 2 (3) at 512 / 256: outputs atol 5e-3, the density gradient
    rel-norm 0.08, parameter gradients rel-norm 2e-2 (5e-2), moment
    gradients 5e-2."""
    params, mlp = models()
    rng = np.random.default_rng(1)
    M = 40
    means = (rng.normal(size=(M, 3)) * 2).astype(np.float32)
    covs = (np.abs(rng.normal(size=(M, 3))) * 0.01).astype(np.float32)
    v = (rng.normal(size=(M, 27)) * 0.5).astype(np.float32)
    jfn, pfn = ((jax_k3, k3.fused_mlp_normals_apply) if normals
                else (jax_k2, k2.fused_mlp_ipe_apply))

    def f(p, m):
        outs = jfn(p, m, jnp.asarray(covs), jnp.asarray(v), 5, 0, 16)
        return _mlp_loss(outs), outs
    (_, j_out), (j_gp, j_gm) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(means))
    m = torch.tensor(means, requires_grad=True)
    p_out = pfn(mlp, m, torch.tensor(covs), torch.tensor(v), min_deg=0,
                max_deg=16)
    _mlp_loss(p_out).backward()
    for a, b in zip(p_out[:2], j_out[:2]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=5e-3, rtol=0)
    if normals:
        assert rel(p_out[2].detach().numpy(), np.asarray(j_out[2])) < 0.08
    p_gp = _flat({n: p.grad for n, p in mlp.named_parameters()})
    assert rel(p_gp, np.asarray(ravel_pytree(j_gp)[0])) < (
        5e-2 if normals else 2e-2)
    assert rel(m.grad.numpy(), np.asarray(j_gm)) < 5e-2


def _level_inputs(R=6, S=8, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    return dict(
        means=(rng.normal(size=(R, S, 3)) * 2).astype(np.float32),
        covs=(np.abs(rng.normal(size=(R, S, 3))) * 0.01).astype(np.float32),
        viewdirs=(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32),
        t=np.sort(rng.uniform(size=(R, S + 1)) * 8, -1).astype(np.float32),
        dirs=d)


ORDER = ("means", "covs", "viewdirs", "t", "dirs")


def test_render_plain_version_matches_pallas_kernel_at_512(interpret):
    """Kernel 4 with normals and extras, at tests/test_torch_fused_render.py's
    tolerances."""
    params, mlp = models()
    x = _level_inputs()
    want = jax.jit(lambda p, *xs: jax_k4(p, *xs, 5, 0, 16, 4, -1.0, 0.0,
                                         False, True, True))(
        params, *(x[k] for k in ORDER))
    with torch.no_grad():
        got = fr.fused_render_level(
            mlp, *(torch.tensor(x[k]) for k in ORDER), min_deg=0, max_deg=16,
            deg_view=4, density_bias=-1.0, rgb_padding=0.0,
            white_bkgd=False, need_normals=True, need_extras=True)
    for k, tol in (("rgb", 2e-2), ("distance", 2e-2), ("acc", 1e-2),
                   ("weights", 1e-2), ("albedo", 2e-2), ("roughness", 2e-2),
                   ("ort", 2e-2)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=tol, err_msg=k)
    cos = np.sum(got["normal"].numpy() * np.asarray(want["normal"]), -1)
    assert np.median(cos) > 0.998 and np.all(cos > 0.85), cos


def test_train_render_plain_version_matches_pallas_kernel_at_512(interpret):
    """Kernel 5 at tests/test_torch_fused_render_train.py's bf16
    tolerances: outputs, and the gradients of a loss on all four w.r.t.
    the parameters (3e-2), means and t_samples (5e-2)."""
    params, mlp = models()
    x = _level_inputs()
    rng = np.random.default_rng(2)
    R, S = x["means"].shape[:2]
    coef = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("rgb", (R, 3)), ("acc", (R,)), ("distance", (R,)),
        ("weights", (R, S)))}
    c, v, d = (jnp.asarray(x[k]) for k in ("covs", "viewdirs", "dirs"))

    def f(p, m, t):
        out = jax_k5(p, m, c, v, t, d, 5, 0, 16, 4, -1.0, 0.0, False)
        return sum(jnp.sum(out[k] * coef[k]) for k in coef), out
    (_, j_out), (j_gp, j_gm, j_gt) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
            params, jnp.asarray(x["means"]), jnp.asarray(x["t"]))
    m = torch.tensor(x["means"], requires_grad=True)
    t = torch.tensor(x["t"], requires_grad=True)
    out = k5.fused_render_train(mlp, m, torch.tensor(x["covs"]),
                                torch.tensor(x["viewdirs"]), t,
                                torch.tensor(x["dirs"]), min_deg=0,
                                max_deg=16, deg_view=4, density_bias=-1.0,
                                rgb_padding=0.0, white_bkgd=False)
    sum(torch.sum(out[k] * torch.tensor(coef[k])) for k in coef).backward()
    for k, tol in (("rgb", 2e-2), ("distance", 2e-2), ("acc", 1e-2),
                   ("weights", 1e-2)):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(j_out[k]), atol=tol, err_msg=k)
    p_gp = _flat({n: p.grad for n, p in mlp.named_parameters()})
    assert rel(p_gp, np.asarray(ravel_pytree(j_gp)[0])) < 3e-2
    assert rel(m.grad.numpy(), np.asarray(j_gm)) < 5e-2
    assert rel(t.grad.numpy(), np.asarray(j_gt)) < 5e-2


# ---- a whole train step ----

def test_train_step_at_512_matches_jax_in_f32():
    """tests/test_torch_train_step.py's small batch at trunk 512 / view
    branch 256 in f32, the port on its kernel route (the kernels' plain
    versions), held as tests/test_torch_plain_route.py `check_step_f64`
    holds a step: loss parts rel 1e-5 and gradients rel-norm 1e-4 per
    leaf, with the port's float64 step as the arbiter of f32 rounding."""
    check_step_f64(WIDE, on_kernels=True, jit_init=True)
