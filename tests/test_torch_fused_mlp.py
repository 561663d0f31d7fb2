"""Kernel 1's plain version against the JAX Pallas kernel, on the CPU.

`fused_mlp_apply` of the port runs its plain version on CPU tensors
(NerfMLP on the encoded rows, torch autograd); the JAX `fused_mlp_apply`
runs its Pallas forward and backward in interpret mode. Same numpy-made
features, bridged parameters of a width-64 MLP with 5 density channels,
M = 512 rows (one TPU block) and a ragged M. Tolerances are
tests/test_fused_kernel.py's: forward atol 5e-3, parameter gradients
rel-norm 5e-3, and the feature gradient d x held to the float32 truth at
least as well as twice the Pallas kernel's error, or 8% (d x carries bf16
round-off through 8 layers in any bf16 path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pano_nerf_tpu.kernels.fused_mlp import fused_mlp_apply as jax_k1
from pano_nerf_tpu.models.mlp import NerfMLP as JaxMLP
from pano_nerf_tpu_torch.kernels import fused_mlp as k1
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax
import torch_threads  # noqa: F401  (tests/torch_threads.py)


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")


def setup(M, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(M, 96)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(M, 27)) * 0.5).astype(np.float32)
    widths = dict(net_width=64, net_width_condition=32)
    jmlp = JaxMLP(num_density_channels=5, dtype=jnp.bfloat16, **widths)
    params = jax.tree.map(np.asarray, jmlp.init(
        jax.random.PRNGKey(seed), jnp.asarray(x[:2]), jnp.asarray(v[:2])))
    mlp = NerfMLP(96, 27, num_density_channels=5, **widths)
    mlp.load_state_dict(params_from_jax(params))
    return x, v, params, mlp, JaxMLP(num_density_channels=5,
                                     dtype=jnp.float32, **widths)


def jax_loss(out):
    return jnp.sum(jnp.sin(out[0])) + jnp.sum(jnp.cos(out[1]))


def jax_run(fn, params, x, v):
    (_, out), (gp, gx) = jax.value_and_grad(
        lambda p, xx: (jax_loss(fn(p, xx)), fn(p, xx)), argnums=(0, 1),
        has_aux=True)(params, jnp.asarray(x))
    return ([np.asarray(o) for o in out], np.asarray(ravel_pytree(gp)[0]),
            np.asarray(gx))


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("M", [512, 300])
def test_plain_version_matches_pallas_kernel(interpret, M):
    x, v, params, mlp, jmlp32 = setup(M)
    vj = jnp.asarray(v)
    j_out, j_gp, j_gx = jax_run(lambda p, xx: jax_k1(p, xx, vj, 5), params,
                                x, v)
    _, _, f32_gx = jax_run(lambda p, xx: jmlp32.apply(p, xx, vj), params,
                           x, v)
    xt = torch.tensor(x, requires_grad=True)
    outs = k1.fused_mlp_apply(mlp, xt, torch.tensor(v))
    (torch.sin(outs[0]).sum() + torch.cos(outs[1]).sum()).backward()
    grads = params_to_jax({n: p.grad for n, p in mlp.named_parameters()})
    p_gp = np.asarray(ravel_pytree(jax.tree.map(jnp.asarray, grads))[0])
    for a, b in zip(outs, j_out):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=5e-3, rtol=0)
    assert rel(p_gp, j_gp) < 5e-3
    p_gx = xt.grad.numpy()
    assert rel(p_gx, f32_gx) < max(2 * rel(j_gx, f32_gx), 0.08)


def _args(M=8):
    x, v, _, _, _ = setup(M)
    return NerfMLP(96, 27, num_density_channels=5), torch.tensor(x), \
        torch.tensor(v)


def test_wrapper_rejects_bad_inputs():
    mlp, x, v = _args()
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_mlp_apply(mlp, x.t().contiguous().t(), v)
    with pytest.raises(TypeError, match="float32"):
        k1.fused_mlp_apply(mlp, x.double(), v)
    with pytest.raises(ValueError, match="x_enc"):
        k1.fused_mlp_apply(mlp, x[:, :90].contiguous(), v)
    with pytest.raises(ValueError, match="v_enc"):
        k1.fused_mlp_apply(mlp, x, v[:, :20].contiguous())
    with pytest.raises(ValueError, match="topology"):
        k1.fused_mlp_apply(NerfMLP(96, 27, net_depth=6,
                                   num_density_channels=5), x, v)


def test_plain_version_takes_other_density_counts_on_the_cpu():
    """The CPU plain version is NerfMLP itself; only the card's kernels
    are compiled for 5 density channels."""
    mlp = NerfMLP(96, 27, num_density_channels=3)
    _, x, v = _args()
    rgb, density = k1.fused_mlp_apply(mlp, x, v)
    assert rgb.shape == (8, 3) and density.shape == (8, 3)


def test_no_cuda_tensor_reaches_the_plain_version(monkeypatch):
    from pano_nerf_tpu_torch.kernels import build

    def no_plain(*a, **k):
        raise AssertionError("the plain version was called")

    def no_build(source):
        raise RuntimeError(f"building {source}")

    monkeypatch.setattr(k1, "fused_mlp_apply_reference", no_plain)
    monkeypatch.setattr(build, "load_library", no_build)
    mlp, x, v = _args()
    with pytest.raises(ValueError, match="cpu or cuda"):
        k1.fused_mlp_apply(mlp, x.to("meta"), v.to("meta"))
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda")))
    with pytest.raises(RuntimeError, match="building fused_mlp.cu"):
        k1.fused_mlp_apply(mlp, x, v)
