"""Kernel 5's plain version against the JAX training render kernel, on the CPU.

`fused_render_train` of the port runs its plain version on CPU tensors
(IPE -> NerfMLP -> activations -> `volumetric_rendering`, torch autograd);
the JAX `fused_render_train` runs its Pallas forward and hand-derived
backward in interpret mode, as tests/test_fused_render_train.py does. Both
take the same numpy-made inputs and bridged parameters of a width-64 MLP,
12 rays x 8 samples.

Tolerances: in bf16 against the Pallas kernel, the JAX kernel test's
(rgb/distance 2e-2, acc/weights 1e-2 absolute; gradients of a
random-coefficient loss on all four outputs: parameters 3e-2, means and
t_samples 5e-2 rel-norm), since bf16 rounds in other places in the two; in
f32 against JAX's XLA composite, values 1e-5 absolute and gradients 1e-4
rel-norm (the same function in the same precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pano_nerf_tpu.kernels.fused_render_train import (
    fused_render_train as jax_k5)
from pano_nerf_tpu.models.mlp import NerfMLP as JaxMLP
from pano_nerf_tpu.ops import mip as jax_mip
from pano_nerf_tpu_torch.kernels import fused_render_train as k5
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax

DENSITY_BIAS = -1.0
KEYS = ("rgb", "acc", "distance", "weights")
KW = dict(min_deg=0, max_deg=16, deg_view=4, density_bias=DENSITY_BIAS,
          rgb_padding=0.0)


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")


def setup(R=12, S=8, seed=0, dtype="bf16"):
    """Inputs (numpy), the coefficients of a loss on every output, and the
    bridged width-64 MLPs (JAX params, port module)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    inputs = dict(
        means=(rng.normal(size=(R, S, 3)) * 2).astype(np.float32),
        covs=(np.abs(rng.normal(size=(R, S, 3))) * 0.01).astype(np.float32),
        viewdirs=(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32),
        t=np.sort(rng.uniform(size=(R, S + 1)) * 8, -1).astype(np.float32),
        dirs=d)
    coef = dict(rgb=rng.normal(size=(R, 3)), acc=rng.normal(size=(R,)),
                distance=rng.normal(size=(R,)),
                weights=rng.normal(size=(R, S)))
    coef = {k: v.astype(np.float32) for k, v in coef.items()}
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jmlp = JaxMLP(num_density_channels=5, net_width=64,
                  net_width_condition=32, dtype=jdt)
    enc = jax_mip.integrated_pos_enc(jnp.asarray(inputs["means"][:1]),
                                     jnp.asarray(inputs["covs"][:1]), 0, 16)
    venc = jax_mip.pos_enc(jnp.asarray(inputs["viewdirs"][:1]), 0, 4,
                           True)[..., None, :]
    params = jax.tree.map(np.asarray, jmlp.init(
        jax.random.PRNGKey(seed), enc, venc))
    mlp = NerfMLP(96, 27, net_width=64, net_width_condition=32,
                  num_density_channels=5,
                  compute_dtype=torch.bfloat16 if dtype == "bf16"
                  else torch.float32)
    mlp.load_state_dict(params_from_jax(params))
    return inputs, coef, jmlp, params, mlp


def jax_loss(out, coef):
    return sum(jnp.sum(out[k] * jnp.asarray(coef[k])) for k in KEYS)


def torch_loss(out, coef):
    return sum(torch.sum(out[k] * torch.tensor(coef[k])) for k in KEYS)


def jax_run(level, params, inputs, coef):
    """Outputs and the gradients w.r.t. (params, means, t_samples) of the
    loss, for `level(p, means, t) -> dict`."""
    def f(p, m, t):
        out = level(p, m, t)
        return jax_loss(out, coef), out
    (_, out), (gp, gm, gt) = jax.value_and_grad(f, argnums=(0, 1, 2),
                                                has_aux=True)(
        params, jnp.asarray(inputs["means"]), jnp.asarray(inputs["t"]))
    return ({k: np.asarray(out[k]) for k in KEYS},
            np.asarray(ravel_pytree(gp)[0]), np.asarray(gm), np.asarray(gt))


def port_run(mlp, inputs, coef, white_bkgd):
    mlp.zero_grad()
    T = torch.tensor
    m = T(inputs["means"], requires_grad=True)
    t = T(inputs["t"], requires_grad=True)
    out = k5.fused_render_train(mlp, m, T(inputs["covs"]),
                                T(inputs["viewdirs"]), t, T(inputs["dirs"]),
                                white_bkgd=white_bkgd, **KW)
    torch_loss(out, coef).backward()
    grads = params_to_jax({n: p.grad for n, p in mlp.named_parameters()})
    return ({k: out[k].detach().numpy() for k in KEYS},
            np.asarray(ravel_pytree(jax.tree.map(jnp.asarray, grads))[0]),
            m.grad.numpy(), t.grad.numpy())


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_kernel(inputs, white_bkgd, save_acts):
    c, v, d = (jnp.asarray(inputs[k]) for k in ("covs", "viewdirs", "dirs"))
    return lambda p, m, t: jax_k5(p, m, c, v, t, d, 5, 0, 16, 4,
                                  DENSITY_BIAS, 0.0, white_bkgd,
                                  save_acts=save_acts)


def jax_xla_level(jmlp, inputs, white_bkgd):
    """JAX's XLA composite (the standard path's arithmetic)."""
    c, v, d = (jnp.asarray(inputs[k]) for k in ("covs", "viewdirs", "dirs"))

    def level(p, m, t):
        enc = jax_mip.integrated_pos_enc(m, c, 0, 16)
        venc = jax_mip.pos_enc(v, 0, 4, True)[..., None, :]
        raw_rgb, raw_density = jmlp.apply(p, enc, venc)
        rgb = jax.nn.softplus(raw_rgb)
        density = jax.nn.softplus(raw_density[..., :1] + DENSITY_BIAS)
        comp, dist, acc, w = jax_mip.volumetric_rendering(rgb, density, t, d,
                                                          white_bkgd)
        return dict(rgb=comp, distance=dist, acc=acc, weights=w)
    return level


@pytest.mark.parametrize("save_acts", [False, True])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_plain_version_matches_pallas_kernel_in_bf16(interpret, white_bkgd,
                                                     save_acts):
    inputs, coef, _, params, mlp = setup()
    j_out, j_gp, j_gm, j_gt = jax_run(
        jax_kernel(inputs, white_bkgd, save_acts), params, inputs, coef)
    p_out, p_gp, p_gm, p_gt = port_run(mlp, inputs, coef, white_bkgd)
    for k, tol in (("rgb", 2e-2), ("distance", 2e-2), ("acc", 1e-2),
                   ("weights", 1e-2)):
        np.testing.assert_allclose(p_out[k], j_out[k], atol=tol, rtol=0,
                                   err_msg=k)
    assert rel(p_gp, j_gp) < 3e-2
    assert rel(p_gm, j_gm) < 5e-2
    assert rel(p_gt, j_gt) < 5e-2


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_plain_version_matches_xla_composite_in_f32(white_bkgd):
    inputs, coef, jmlp, params, mlp = setup(dtype="f32")
    j_out, j_gp, j_gm, j_gt = jax_run(
        jax_xla_level(jmlp, inputs, white_bkgd), params, inputs, coef)
    p_out, p_gp, p_gm, p_gt = port_run(mlp, inputs, coef, white_bkgd)
    for k in KEYS:
        np.testing.assert_allclose(p_out[k], j_out[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    # No ray's distance is clipped here (a weighted mean of the t_mids
    # lies inside (t_0, t_S) when acc > 1e-10), so the XLA composite's
    # gradient through the clip bounds, which the kernels treat as data,
    # is zero and the t_samples gradients compare too.
    assert rel(p_gp, j_gp) < 1e-4
    assert rel(p_gm, j_gm) < 1e-4
    assert rel(p_gt, j_gt) < 1e-4


def test_ragged_batch_with_an_empty_ray(interpret):
    """13 rays of 5 samples (two TPU blocks and, on the card, a second
    12-ray tile with one ray), one of them of zero length: every gradient
    is finite, and the empty ray's moment gradients are exactly zero in
    both versions."""
    inputs, coef, _, params, mlp = setup(R=13, S=5, seed=3)
    inputs["t"][4] = 2.0  # ray 4: all samples at one depth, dd = 0
    j_out, j_gp, j_gm, j_gt = jax_run(jax_kernel(inputs, False, False),
                                      params, inputs, coef)
    p_out, p_gp, p_gm, p_gt = port_run(mlp, inputs, coef, False)
    for res in ((j_out, j_gp, j_gm, j_gt), (p_out, p_gp, p_gm, p_gt)):
        out, gp, gm, gt = res
        assert all(np.isfinite(out[k]).all() for k in KEYS)
        assert np.isfinite(gp).all() and np.isfinite(gm).all()
        assert np.isfinite(gt).all()
        assert out["acc"][4] == 0.0 and not gm[4].any()
        assert np.abs(gm[:4]).sum() > 0
    np.testing.assert_allclose(p_out["weights"], j_out["weights"], atol=1e-2)
    assert rel(p_gm, j_gm) < 5e-2


def _torch_inputs(R=4, S=8):
    """Inputs and a full-width MLP (the width the CUDA kernels take)."""
    inputs = setup(R=R, S=S)[0]
    T = torch.tensor
    return (NerfMLP(96, 27, num_density_channels=5),
            [T(inputs[k]) for k in ("means", "covs", "viewdirs", "t",
                                    "dirs")])


def test_wrapper_rejects_unsupported_inputs():
    mlp, args = _torch_inputs()
    kw = dict(KW, white_bkgd=False)
    with pytest.raises(ValueError, match="1..64 samples"):
        big = torch.zeros(2, 65, 3)
        k5.fused_render_train(mlp, big, big, args[2][:2],
                              torch.zeros(2, 66), args[4][:2], **kw)
    # deg_view 2 for an MLP of the deg-4 encoding; 18 IPE degrees, past
    # the builds' 1..16.
    with pytest.raises(ValueError, match="deg_view"):
        k5.fused_render_train(mlp, *args, **dict(kw, deg_view=2))
    with pytest.raises(ValueError, match="topology"):
        k5.fused_render_train(mlp, *args, **dict(kw, max_deg=18))
    with pytest.raises(ValueError, match="t_samples"):
        k5.fused_render_train(mlp, *args[:3], args[3][:, :-1].contiguous(),
                              args[4], **kw)
    with pytest.raises(TypeError, match="float32"):
        k5.fused_render_train(mlp, args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError,
                       match="fused_render_train needs at least one ray"):
        k5.fused_render_train(mlp, *[a[:0] for a in args], **kw)
    with pytest.raises(ValueError, match="bf16"):
        k5.check_kernel_support(
            NerfMLP(96, 27, num_density_channels=5,
                    compute_dtype=torch.float32), 8, 0, 16, 4,
            torch.device("cuda"))


def test_no_cuda_tensor_reaches_the_plain_version(monkeypatch):
    """The wrapper picks the plain version by the tensor's device alone: a
    CUDA tensor goes to the kernel (here: the library build, which raises
    without nvcc or a card) and never to the plain version."""
    from pano_nerf_tpu_torch.kernels import build

    def no_plain(*a, **k):
        raise AssertionError("the plain version was called")

    def no_build(source):
        raise RuntimeError(f"building {source}")

    monkeypatch.setattr(k5, "fused_render_train_reference", no_plain)
    monkeypatch.setattr(build, "load_library", no_build)
    mlp, args = _torch_inputs()
    kw = dict(KW, white_bkgd=False)
    with pytest.raises(ValueError, match="cpu or cuda"):
        k5.fused_render_train(mlp, *[a.to("meta") for a in args], **kw)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda")))
    with pytest.raises(RuntimeError, match="building fused_mlp.cu"):
        k5.fused_render_train(mlp, *args, **kw)
