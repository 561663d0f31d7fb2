"""The kernel route at the MLP widths and encodings beside the shipped one,
on the CPU.

JAX sends a bf16 model of the standard topology to its Pallas kernels
whatever its widths and encodings; the port's CUDA kernels are built per
shape (`pano_nerf_tpu_torch/kernels/shapes.py`), and their plain versions
take every shape a build takes. Three shapes beside the shipped one:

- A: trunk 128, view branch 64 (the narrow model);
- B: IPE degrees 0..10 and deg_view 2 at the shipped widths;
- C: mip-NeRF's one density channel at A's widths, without identity in
  the viewdir encoding (kernels 2 and 3 only: kernels 4 and 5 encode the
  view directions with identity, as JAX's do).

Here, with numpy-made inputs and bridged parameters:

- the plain versions of kernels 2, 3 (A, B, C), 4 and 5 (A, B) against
  JAX's Pallas kernels in interpret mode, at the tolerances of
  tests/test_torch_fused_mlp_ipe.py, test_torch_fused_mlp_normals.py,
  test_torch_fused_render.py and test_torch_fused_render_train.py;
- `pack_params` / `unpack_params` round trips and the weight-gradient
  pass's job table at each shape: `weight_grads_reference` of operand rows
  built from the plain MLP (float64) against torch autograd at rel-norm
  1e-5 per weight (tests/test_torch_wgrad.py's check);
- one bf16 train step of Pano-NeRF (kernel 5's key off and on) and one
  bf16 render at A and B against JAX's, at tests/test_torch_train_step.py's
  bf16 tolerances and tests/test_torch_render.py's;
- the route table (`kernel_build_gaps`), the eval gate without identity
  (JAX's :278) and kernel 5 without identity, which JAX cannot run;
- the narrow bf16 model (trunk 64, view branch 32) of
  tests/test_torch_train_step.py rendered through the model's `forward`
  on the CPU (kernel 4's plain version takes any width), held to JAX.
"""

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
from pano_nerf_tpu.kernels.fused_render import (
    fused_render_level as jax_k4)
from pano_nerf_tpu.kernels.fused_render_train import (
    fused_render_train as jax_k5)
from pano_nerf_tpu.models.mlp import NerfMLP as JaxMLP
from pano_nerf_tpu.ops import mip as jax_mip
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.engine.system import build_system
from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
from pano_nerf_tpu_torch.kernels import fused_render as fr
from pano_nerf_tpu_torch.kernels import fused_render_train as k5
from pano_nerf_tpu_torch.kernels.fused_render import (pack_params,
                                                      unpack_params)
from pano_nerf_tpu_torch.models import build_model
from pano_nerf_tpu_torch.models.base import kernel_build_gaps
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.ops import mip
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax

import test_torch_train_step as tt
from test_torch_plain_route import render_both, render_f64
from test_torch_train_step import KERNEL5
import torch_threads  # noqa: F401  (tests/torch_threads.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
MIP_CONFIG = os.path.join(REPO, "configs", "mipnerf.yaml")

# name -> (density channels, trunk, view branch, min_deg, max_deg,
# deg_view, identity)
SHAPES = {"A": (5, 128, 64, 0, 16, 4, True),
          "B": (5, 256, 128, 0, 10, 2, True),
          "C": (1, 128, 64, 0, 16, 4, False)}
# The same as config options.
OPTS = {"A": ["nerf.mlp.net_width", "128", "nerf.mlp.net_width_condition",
              "64"],
        "B": ["nerf.max_deg_point", "10", "nerf.deg_view", "2"],
        "C": ["nerf.mlp.net_width", "128", "nerf.mlp.net_width_condition",
              "64", "nerf.append_identity", "False"]}
# tests/test_torch_train_step.py's small model is 64 / 32 wide: B's step
# and render run at the shipped widths.
WIDE = ["nerf.mlp.net_width", "256", "nerf.mlp.net_width_condition", "128"]


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")


@functools.lru_cache(maxsize=None)
def _jax_params(name, seed=0):
    """JAX's parameters of shape `name` (numpy), made once per shape by
    its initialiser compiled whole (the same parameters bit for bit as op
    by op, in a fraction of the time)."""
    C, W, VW, lo, hi, dv, ident = SHAPES[name]
    jmlp = JaxMLP(net_width=W, net_width_condition=VW,
                  num_density_channels=C, dtype=jnp.bfloat16)
    return jax.tree.map(np.asarray, jax.jit(jmlp.init)(
        jax.random.PRNGKey(seed), jnp.zeros((2, 6 * (hi - lo))),
        jnp.zeros((2, 6 * dv + 3 * ident))))


def models(name, seed=0):
    """Bridged bf16 MLPs of shape `name`: (JAX params, a fresh port
    module, its encodings' keywords)."""
    C, W, VW, lo, hi, dv, ident = SHAPES[name]
    params = _jax_params(name, seed)
    mlp = NerfMLP(6 * (hi - lo), 6 * dv + 3 * ident, net_width=W,
                  net_width_condition=VW, num_density_channels=C)
    mlp.load_state_dict(params_from_jax(params))
    return params, mlp, dict(min_deg=lo, max_deg=hi, deg_view=dv)


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---- kernels 2 and 3 ----

def _mlp_loss(outs):
    xp = jnp if isinstance(outs[0], jax.Array) else torch
    loss = xp.sum(xp.sin(outs[0])) + xp.sum(xp.cos(outs[1]))
    if len(outs) == 3:
        loss = loss + xp.sum(xp.sin(0.1 * outs[2]))
    return loss


@pytest.mark.parametrize("normals", [False, True], ids=["k2", "k3"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_mlp_plain_versions_match_pallas_kernels(interpret, name, normals):
    """Kernel 2 (3) at tests/test_torch_fused_mlp_ipe.py's (normals')
    tolerances: outputs atol 5e-3, the density gradient rel-norm 0.08,
    parameter gradients rel-norm 2e-2 (5e-2), moment gradients 5e-2."""
    params, mlp, kw = models(name)
    C = mlp.num_density_channels
    rng = np.random.default_rng(1)
    M = 77
    means = (rng.normal(size=(M, 3)) * 2).astype(np.float32)
    covs = (np.abs(rng.normal(size=(M, 3))) * 0.01).astype(np.float32)
    v = (rng.normal(size=(M, mlp.view_dim)) * 0.5).astype(np.float32)
    jfn, pfn = ((jax_k3, k3.fused_mlp_normals_apply) if normals
                else (jax_k2, k2.fused_mlp_ipe_apply))

    def f(p, m):
        outs = jfn(p, m, jnp.asarray(covs), jnp.asarray(v), C,
                   kw["min_deg"], kw["max_deg"])
        return _mlp_loss(outs), outs
    (_, j_out), (j_gp, j_gm) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(means))
    m = torch.tensor(means, requires_grad=True)
    p_out = pfn(mlp, m, torch.tensor(covs), torch.tensor(v),
                min_deg=kw["min_deg"], max_deg=kw["max_deg"])
    _mlp_loss(p_out).backward()
    p_gp = params_to_jax({n: p.grad for n, p in mlp.named_parameters()})
    p_gp = np.asarray(ravel_pytree(jax.tree.map(jnp.asarray, p_gp))[0])
    assert p_out[1].shape == (M, C)
    for a, b in zip(p_out[:2], j_out[:2]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=5e-3, rtol=0)
    if normals:
        assert rel(p_out[2].detach().numpy(), np.asarray(j_out[2])) < 0.08
    assert rel(p_gp, np.asarray(ravel_pytree(j_gp)[0])) < (
        5e-2 if normals else 2e-2)
    assert rel(m.grad.numpy(), np.asarray(j_gm)) < 5e-2


# ---- kernels 4 and 5 ----

def _level_inputs(R=12, S=8, seed=0):
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


@pytest.mark.parametrize("need_normals", [False, True])
@pytest.mark.parametrize("name", ["A", "B"])
def test_render_plain_version_matches_pallas_kernel(interpret, name,
                                                    need_normals):
    """Kernel 4 at tests/test_torch_fused_render.py's tolerances."""
    params, mlp, kw = models(name)
    x = _level_inputs()
    want = jax.jit(lambda p, *xs: jax_k4(
        p, *xs, 5, kw["min_deg"], kw["max_deg"], kw["deg_view"], -1.0, 0.0,
        False, need_normals, need_normals))(params, *(x[k] for k in ORDER))
    with torch.no_grad():
        got = fr.fused_render_level(
            mlp, *(torch.tensor(x[k]) for k in ORDER), density_bias=-1.0,
            rgb_padding=0.0, white_bkgd=False, need_normals=need_normals,
            need_extras=need_normals, **kw)
    for k, tol in (("rgb", 2e-2), ("distance", 2e-2), ("acc", 1e-2),
                   ("weights", 1e-2)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=tol, err_msg=k)
    if need_normals:
        cos = np.sum(got["normal"].numpy() * np.asarray(want["normal"]), -1)
        assert np.median(cos) > 0.998 and np.all(cos > 0.85), cos
        for k in ("albedo", "roughness", "ort"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=2e-2, err_msg=k)


@pytest.mark.parametrize("name", ["A", "B"])
def test_train_render_plain_version_matches_pallas_kernel(interpret, name):
    """Kernel 5 at tests/test_torch_fused_render_train.py's bf16
    tolerances: outputs, and the gradients of a loss on all four w.r.t.
    the parameters (3e-2), means and t_samples (5e-2)."""
    params, mlp, kw = models(name)
    x = _level_inputs()
    rng = np.random.default_rng(2)
    R, S = x["means"].shape[:2]
    coef = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("rgb", (R, 3)), ("acc", (R,)), ("distance", (R,)),
        ("weights", (R, S)))}
    c, v, d = (jnp.asarray(x[k]) for k in ("covs", "viewdirs", "dirs"))

    def f(p, m, t):
        out = jax_k5(p, m, c, v, t, d, 5, kw["min_deg"], kw["max_deg"],
                     kw["deg_view"], -1.0, 0.0, False)
        return sum(jnp.sum(out[k] * coef[k]) for k in coef), out
    (_, j_out), (j_gp, j_gm, j_gt) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
            params, jnp.asarray(x["means"]), jnp.asarray(x["t"]))
    m = torch.tensor(x["means"], requires_grad=True)
    t = torch.tensor(x["t"], requires_grad=True)
    out = k5.fused_render_train(mlp, m, torch.tensor(x["covs"]),
                                torch.tensor(x["viewdirs"]), t,
                                torch.tensor(x["dirs"]), density_bias=-1.0,
                                rgb_padding=0.0, white_bkgd=False, **kw)
    sum(torch.sum(out[k] * torch.tensor(coef[k])) for k in coef).backward()
    for k, tol in (("rgb", 2e-2), ("distance", 2e-2), ("acc", 1e-2),
                   ("weights", 1e-2)):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(j_out[k]), atol=tol, err_msg=k)
    p_gp = params_to_jax({n: p.grad for n, p in mlp.named_parameters()})
    p_gp = np.asarray(ravel_pytree(jax.tree.map(jnp.asarray, p_gp))[0])
    assert rel(p_gp, np.asarray(ravel_pytree(j_gp)[0])) < 3e-2
    assert rel(m.grad.numpy(), np.asarray(j_gm)) < 5e-2
    assert rel(t.grad.numpy(), np.asarray(j_gt)) < 5e-2


# ---- the packed layout and the weight-gradient pass ----

def _operand_rows(mlp, d, normals, kw):
    """The row pass's operand rows [M, OPW] of the MLP's shape, from the
    plain MLP in its parameter dtype (float64 here): forward activations,
    the MLP backward from the head cotangents and, for NORMALS, the
    chain's sz_i and the walk's c_i of the dsig cotangent q; and the
    column sum of c_7 (the walk's part of Wd's sigma row, which the row
    pass adds itself). As tests/test_torch_wgrad.py's `operand_rows`, at
    any shape: x in XF columns (zero past 6 L), v in VP (zero past VF)."""
    sh = k2.shape_of(mlp)
    lay, W = k2.layout(sh), sh.W
    T = lambda a: torch.tensor(a, dtype=torch.float64)
    x = mip.integrated_pos_enc(T(d["means"]), T(d["covs"]), kw["min_deg"],
                               kw["max_deg"])
    Ws = [s[0].weight for s in mlp.layers]
    h, acts = x, []
    for i, w in enumerate(Ws):
        a = torch.relu(h @ w.t() + mlp.layers[i][0].bias)
        acts.append(a)
        h = torch.cat([a, x], -1) if i == 4 else a
    Wd, Wb = mlp.density_layer.weight, mlp.extra_layer.weight
    Wv, Wc = mlp.view_layers[0][0].weight, mlp.color_layer.weight
    btl = acts[7] @ Wb.t() + mlp.extra_layer.bias
    v = T(d["v"])
    hv = torch.relu(torch.cat([btl, v], -1) @ Wv.t()
                    + mlp.view_layers[0][0].bias)
    gr, gd = T(d["g_rgb"]), T(d["g_den"])
    dzv = (gr @ Wc) * (hv > 0)
    dbtl = (dzv @ Wv)[:, :W]
    da = gd @ Wd + dbtl @ Wb
    dz = [None] * 8
    for i in range(7, -1, -1):
        dz[i] = da * (acts[i] > 0)
        da = (dz[i] @ Ws[i])[:, :W]
    M = x.shape[0]
    ops = torch.zeros(M, lay.OPW_NRM if normals else lay.OPW_IPE,
                      dtype=torch.float64)

    def put(col, t):
        ops[:, col:col + t.shape[1]] = t
    put(lay.O_X, x)
    for i in range(8):
        put(lay.O_A + i * W, acts[i])
        put(lay.O_DZ + i * W, dz[i])
    put(lay.O_BTL, btl)
    put(lay.O_V, v)
    put(lay.O_HV, hv)
    put(lay.O_GD, gd)
    put(lay.O_DBTL, dbtl)
    put(lay.O_DZV, dzv)
    put(lay.O_GR, gr)
    if not normals:
        return ops, None
    # The chain from Wd's sigma row, then the walk of q through it.
    s = Wd[0].expand(M, W)
    for i in range(7, -1, -1):
        sz = s * (acts[i] > 0)
        put(lay.O_SZ + i * W, sz)
        s = (sz @ Ws[i])[:, :W]
    L, lo = kw["max_deg"] - kw["min_deg"], kw["min_deg"]
    scale = 2.0 ** torch.arange(lo, lo + L, dtype=torch.float64)
    qs = T(d["q"]).repeat(1, L) * scale.repeat_interleave(3)
    cgx = torch.cat([qs * x[:, 3 * L:], -qs * x[:, :3 * L]], -1)
    put(lay.O_CGX, cgx)
    c = cgx
    for i in range(8):
        inp = torch.cat([c, cgx], -1) if i == 5 else c
        c = (inp @ Ws[i].t()) * (acts[i] > 0)
        if i < 7:
            put(lay.O_C + i * W, c)
    return ops, c.sum(0)


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_packed_layout_and_weight_grad_jobs(name, normals):
    """`pack_params` -> `unpack_params` gives every parameter back; every
    packed weight element is written by exactly one job of the table
    (zero-padded columns included), inside its operand rows; and
    `weight_grads_reference` of float64 operand rows, in f32, matches
    torch autograd's weight gradients at rel-norm 1e-5 per weight."""
    _, mlp, kw = models(name)
    mlp = mlp.double()
    mlp.compute_dtype = torch.float64
    sh = k2.shape_of(mlp)
    lay = k2.layout(sh)
    w, b = pack_params(mlp)
    assert w.numel() == lay.W_TOTAL
    back = unpack_params(mlp, w.double(), b.double())
    for n, p in mlp.named_parameters():
        want = p.detach().to(torch.bfloat16).double() if n.endswith(
            "weight") else p.detach().float().double()
        assert torch.equal(back[n], want), n
    hits = torch.zeros(lay.W_TOTAL)
    width = lay.OPW_NRM if normals else lay.OPW_IPE
    for b1, a1, b2, a2, n, k, out, ldo in k2.wgrad_jobs(normals, sh):
        hits.as_strided((n, k), (ldo, 1), out).add_(1)
        assert max(b1, b2) + n <= width and max(a1, a2) + k <= width
        assert k <= 256 and k % 4 == 0
    assert torch.all(hits == 1)
    rng = np.random.default_rng(3)
    M = 40
    f = lambda *s: rng.normal(size=s)
    d = dict(means=f(M, 3) * 2, covs=np.abs(f(M, 3)) * 0.01,
             v=f(M, mlp.view_dim) * 0.5, g_rgb=f(M, 3),
             g_den=f(M, mlp.num_density_channels), q=f(M, 3))
    with torch.no_grad():
        ops, c7 = _operand_rows(mlp, d, normals, kw)
        dw = k2.weight_grads_reference(ops.float(), normals, sh).double()
    if normals:
        dw[lay.OFF_WD:lay.OFF_WD + sh.W] += c7
    got = unpack_params(mlp, dw, torch.zeros(b.numel(), dtype=torch.float64))
    T = lambda a: torch.tensor(a, dtype=torch.float64)
    args = (T(d["means"]), T(d["covs"]), T(d["v"]))
    deg = dict(min_deg=kw["min_deg"], max_deg=kw["max_deg"])
    mlp.zero_grad(set_to_none=True)
    if normals:
        rgb, den, dsig = k3.fused_mlp_normals_reference(mlp, *args, **deg)
        extra = torch.sum(dsig * T(d["q"]))
    else:
        rgb, den = k2.fused_mlp_ipe_reference(mlp, *args, **deg)
        extra = 0.0
    (torch.sum(rgb * T(d["g_rgb"])) + torch.sum(den * T(d["g_den"]))
     + extra).backward()
    for n, p in mlp.named_parameters():
        if n.endswith("weight"):
            assert float(torch.linalg.norm(got[n] - p.grad)
                         / torch.linalg.norm(p.grad)) < 1e-5, n


# ---- the train step and the render ----

def _step_both(extra):
    """One bf16 train step of JAX and of the port on the small batch of
    tests/test_torch_train_step.py, from the same parameters and draws:
    (JAX loss parts, JAX gradients clipped by their global norm as JAX's
    step clips them, port loss parts, port gradients after its step's
    clip). JAX's model runs on its kernel route (`use_fused_kernel`,
    every subgraph, its Pallas kernels in interpret mode): the route the
    port's kernel route reproduces. (Its XLA route rounds elsewhere in
    bf16: at shape A its surface loss reads 0.267 there and 0.317 on its
    kernels, where the port reads 0.317.)"""
    import dataclasses
    opts = tt.OPTS + ["train.precision", "'bf16'", *extra]
    jsys = tt.JaxSystem(tt.jax_load_config(CONFIG, opts))
    jsys.model = dataclasses.replace(jsys.model, use_fused_kernel=True,
                                     fused_scope="all")
    jsys.set_env_rays(tt.jax_lit(num=tt.D, far=10.0))
    state = jsys.create_state(jax.random.PRNGKey(0))
    rays_np, rgbs_np = tt._batch()
    key = jax.random.PRNGKey(7)

    def loss_fn(p):
        outs = jsys.model(p, jax.random.fold_in(key, 0),
                          tt.JaxRays(*rays_np), jsys.env_rays,
                          randomized=True, white_bkgd=False,
                          enable_surf=True, use_ort_loss=True,
                          use_vc_loss=True)
        parts = tt.jax_losses.pano_losses(
            outs, jnp.asarray(rgbs_np), jnp.asarray(rays_np.lossmult),
            jsys.hparams, True, step=jnp.int32(0))
        return parts["loss"], parts
    (_, j_parts), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params)
    jg = tt._leaves(jax.tree.map(np.asarray, j_grads))
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in jg.values()))
    clip = float(jsys.hparams["optimizer.grad_clip"])
    jg = {k: g * np.float32(clip / max(norm, clip)) for k, g in jg.items()}
    psys = build_system(load_config(CONFIG, opts), device="cpu")
    assert psys.model.kernels
    psys.model.mlp.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, state.params)))
    psys.set_env_rays(tt.generate_lit_rays(tt.D, 0.0, 10.0))
    parts = psys.make_train_step(True)(
        psys.create_state(), tt.rays_to_tensors(rays_np, torch.device("cpu")),
        torch.tensor(rgbs_np), tt._draws(key, 0))
    pg = tt._leaves(params_to_jax({n: p.grad for n, p in
                                   psys.model.mlp.named_parameters()}))
    return j_parts, jg, parts, pg


@pytest.mark.parametrize("key", [False, True], ids=["off", "k5"])
@pytest.mark.parametrize("name", ["A", "B"])
def test_bf16_train_step_tracks_jax(interpret, name, key):
    """One bf16 step, held as tests/test_torch_train_step.py holds the
    small model's: loss parts within 3%, gradients within 10% (rel-norm
    per leaf); with the key on both render the coarse level and the env
    queries through kernel 5."""
    extra = OPTS[name] + (WIDE if name == "B" else [])
    j_parts, jg, parts, pg = _step_both(extra + (KERNEL5 if key else []))
    for k in ("loss", "vol_coarse", "vol_fine", "vol_surface", "vc"):
        want, got = float(j_parts[k]), float(parts[k])
        assert abs(got - want) <= 3e-2 * abs(want), (k, got, want)
    assert jg.keys() == pg.keys()
    for k in jg:
        assert rel(pg[k], jg[k]) < 0.1, k


@pytest.mark.parametrize("name", ["A", "B"])
def test_bf16_render_tracks_jax(name):
    """The eval render through kernel 4's plain version against JAX's XLA
    render at tests/test_torch_render.py's bf16 tolerances."""
    extra = OPTS[name] + (WIDE if name == "B" else [])
    got, want, psys = render_both(extra, "bf16")
    assert psys.model.kernels
    _check_bf16_render(got, want)


def _check_bf16_render(got, want):
    for k in ("rgb_coarse", "dep_coarse", "rgb_fine", "dep_fine", "albedo",
              "roughness"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-2, err_msg=k)
    cos = np.sum(got["normal"] * want["normal"], -1)
    assert np.median(cos) > 0.998, np.median(cos)


def test_narrow_bf16_model_renders_on_the_cpu(monkeypatch):
    """The small model of tests/test_torch_train_step.py (trunk 64, view
    branch 32; no CUDA build takes it) is built on the kernel route on the
    CPU, and its eval render through `forward` (kernel 4's plain version)
    runs: in bf16 held to JAX's XLA render at tests/test_torch_render.py's
    bf16 tolerances, and put on the kernel route in f32 held to JAX's f32
    render at `test_torch_plain_route.check_render`'s tolerance (atol 1e-4
    on every ray where the port's f64 render, on the plain route, agrees
    with its f32 one at 1e-4; on at most one other ray the f64 render is
    held to JAX's)."""
    import copy
    import test_torch_plain_route as plain_route
    from pano_nerf_tpu_torch.models import pano_mip_nerf
    calls = []
    real = fr.fused_render_level

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(pano_mip_nerf, "fused_render_level", counted)
    got, want, psys = render_both([], "bf16")
    assert psys.model.kernels and psys.model.cfg.mlp_net_width == 64
    assert calls
    _check_bf16_render(got, want)
    calls.clear()
    real_systems = plain_route.systems

    def on_kernels(extra, precision="f32", **kw):
        jsys, params, psys = real_systems(extra, precision, **kw)
        return jsys, params, tt.f32_on_the_kernels(psys)
    monkeypatch.setattr(plain_route, "systems", on_kernels)
    got, want, psys = render_both([], "f32")
    assert psys.model.kernels and calls
    plain = copy.deepcopy(psys)
    plain.model.kernels = False
    f64 = render_f64(plain, tt._batch(1)[0])
    off = np.zeros(len(got["rgb_fine"]), bool)
    for k in got:
        off |= np.abs(got[k] - f64[k]).max(-1) > 1e-4
    assert off.sum() <= 1, np.flatnonzero(off)
    for k in want:
        np.testing.assert_allclose(got[k][~off], want[k][~off], atol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(f64[k][off], want[k][off], atol=1e-4,
                                   err_msg=k)


# ---- the route ----

@pytest.mark.parametrize("config,opts", [
    (CONFIG, OPTS["A"]), (CONFIG, OPTS["B"]), (MIP_CONFIG, OPTS["C"]),
    (CONFIG, ["nerf.min_deg_point", "2", "nerf.max_deg_point", "18"])],
    ids=["A", "B", "C", "deg2-18"])
def test_kernel_route_takes_the_built_shapes(config, opts):
    model = build_model(load_config(config, opts))
    assert model.kernels
    for dev in ("cuda", "cpu"):
        assert kernel_build_gaps(model.cfg, torch.device(dev)) == []


@pytest.mark.parametrize("width,key", [
    ("1025", "nerf.mlp.net_width 1025"),
    ("1536", "nerf.mlp.net_width 1536"),
    ("2048", "nerf.mlp.net_width 2048")])
def test_kernel_route_refuses_unbuilt_widths_on_the_card(width, key):
    """A trunk width no CUDA build takes (above 1024) is refused on the
    card, naming the key (the plain versions on the CPU take it)."""
    hp = load_config(CONFIG, ["nerf.mlp.net_width", width])
    model = build_model(hp)
    assert model.kernels
    assert kernel_build_gaps(model.cfg, torch.device("cuda")) == [key]
    assert kernel_build_gaps(model.cfg, torch.device("cpu")) == []


def test_eval_without_identity_takes_the_standard_render(monkeypatch,
                                                         interpret):
    """Without identity in the viewdir encoding the eval render takes
    `_render` (kernels 2 and 3), never kernel 4, as JAX's gate sends it
    to its standard path (pano_nerf_tpu/models/pano_mip_nerf.py:278)."""
    from pano_nerf_tpu.models import pano_mip_nerf as jax_pano
    from pano_nerf_tpu_torch.models import pano_mip_nerf
    from test_torch_env_modes import systems
    from test_torch_train_step import _batch
    from pano_nerf_tpu.core.rays import Rays as JaxRays
    from pano_nerf_tpu_torch.core.rays import rays_to_tensors

    def no_kernel4(*a, **k):
        raise AssertionError("kernel 4 on a model without identity")
    monkeypatch.setattr(pano_mip_nerf, "fused_render_level", no_kernel4)
    jax_fused = []
    monkeypatch.setattr(jax_pano.PanoMipNeRF, "_render_fused",
                        lambda *a, **k: jax_fused.append(1) or 1 / 0)
    jsys, params, psys = systems(["nerf.append_identity", "False",
                                  "val.chunk_size", "16"], "bf16")
    assert psys.model.kernels
    rays_np, _ = _batch(1)
    want = jsys.make_render_image(enable_surf=True)(params,
                                                    JaxRays(*rays_np))
    got = psys.make_render_image(True)(None, rays_to_tensors(
        rays_np, torch.device("cpu")))
    assert not jax_fused
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    _check_bf16_render(got, want)


def test_train_kernel_without_identity_is_refused_as_jax_raises(interpret):
    """JAX's kernel 5 encodes the view directions with identity whatever
    the model's view layer takes, so on an MLP without identity it raises;
    the port refuses `nerf.use_train_render_kernel` with
    `nerf.append_identity false`, naming both keys."""
    C, W, VW, lo, hi, dv, _ = SHAPES["A"]
    jmlp = JaxMLP(net_width=W, net_width_condition=VW,
                  num_density_channels=C, dtype=jnp.bfloat16)
    params = jmlp.init(jax.random.PRNGKey(0), jnp.zeros((2, 96)),
                       jnp.zeros((2, 24)))
    x = _level_inputs(R=4, S=8)
    with pytest.raises(TypeError):
        jax_k5(params, *(jnp.asarray(x[k]) for k in ORDER), 5, 0, 16, 4,
               -1.0, 0.0, False)
    mlp = NerfMLP(96, 24, net_width=W, net_width_condition=VW,
                  num_density_channels=C)
    with pytest.raises(ValueError, match="identity"):
        k5.fused_render_train(mlp, *(torch.tensor(x[k]) for k in ORDER),
                              min_deg=0, max_deg=16, deg_view=4,
                              density_bias=-1.0, rgb_padding=0.0,
                              white_bkgd=False)
    hp = load_config(CONFIG, ["nerf.append_identity", "False",
                              "nerf.use_train_render_kernel", "True"])
    with pytest.raises(NotImplementedError,
                       match="use_train_render_kernel with "
                             "nerf.append_identity false"):
        build_system(hp, device="cpu")
