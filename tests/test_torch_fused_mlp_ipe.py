"""Kernel 2's plain version against the JAX Pallas kernel, on the CPU.

`fused_mlp_ipe_apply` of the port runs its plain version on CPU tensors
(IPE -> NerfMLP, torch autograd); the JAX `fused_mlp_ipe_apply` runs its
Pallas forward and hand-written backward in interpret mode, as
tests/test_fused_normals.py does. Full width, bridged parameters, M = 192
and a ragged M, with Pano-NeRF's 5 density channels and mip-NeRF's 1.
Tolerances: forward atol 5e-3, parameter gradients of a loss on every
output rel-norm 2e-2, moment gradients rel-norm 5e-2 (bf16 rounds in
other places in the two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pano_nerf_tpu.kernels.fused_mlp_ipe import fused_mlp_ipe_apply as jax_k2
from pano_nerf_tpu.models.mlp import NerfMLP as JaxMLP
from pano_nerf_tpu.ops import mip as jax_mip
from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.utils.params import params_from_jax, params_to_jax
import torch_threads  # noqa: F401  (tests/torch_threads.py)


def setup(M, seed=0, C=5):
    """Moments, viewdir codes and bridged full-width MLPs (JAX, port)
    with C density channels."""
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(M, 3)) * 2).astype(np.float32)
    covs = (np.abs(rng.normal(size=(M, 3))) * 0.01).astype(np.float32)
    v = (rng.normal(size=(M, 27)) * 0.5).astype(np.float32)
    jmlp = JaxMLP(num_density_channels=C, dtype=jnp.bfloat16)
    x = jax_mip.integrated_pos_enc(jnp.asarray(means[:2]),
                                   jnp.asarray(covs[:2]), 0, 16)
    params = jax.tree.map(np.asarray, jmlp.init(
        jax.random.PRNGKey(seed), x, jnp.asarray(v[:2])))
    mlp = NerfMLP(96, 27, num_density_channels=C)
    mlp.load_state_dict(params_from_jax(params))
    return params, mlp, means, covs, v


def loss_of(outs):
    """A loss on every output (the JAX kernel tests' loss)."""
    xp = jnp if isinstance(outs[0], jax.Array) else torch
    loss = xp.sum(xp.sin(outs[0])) + xp.sum(xp.cos(outs[1]))
    if len(outs) == 3:
        loss = loss + xp.sum(xp.sin(0.1 * outs[2]))
    return loss


def jax_run(fn, params, means, covs, v, C=5):
    def f(p, m):
        outs = fn(p, m, jnp.asarray(covs), jnp.asarray(v), C, 0, 16)
        return loss_of(outs), outs
    (_, outs), (gp, gm) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(means))
    return ([np.asarray(o) for o in outs], np.asarray(ravel_pytree(gp)[0]),
            np.asarray(gm))


def port_run(fn, mlp, means, covs, v):
    mlp.zero_grad()
    m = torch.tensor(means, requires_grad=True)
    outs = fn(mlp, m, torch.tensor(covs), torch.tensor(v), min_deg=0,
              max_deg=16)
    loss_of(outs).backward()
    grads = params_to_jax({n: p.grad for n, p in mlp.named_parameters()})
    return ([o.detach().numpy() for o in outs],
            np.asarray(ravel_pytree(jax.tree.map(jnp.asarray, grads))[0]),
            m.grad.numpy())


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")


# (C, M): Pano-NeRF's 5 density channels keep their ids, mip-NeRF's 1
# are the C1 cases.
CASES = [pytest.param(5, 192, id="192"), pytest.param(5, 77, id="77"),
         pytest.param(1, 192, id="C1-192"), pytest.param(1, 77, id="C1-77")]


@pytest.mark.parametrize("C, M", CASES)
def test_plain_version_matches_pallas_kernel(interpret, C, M):
    params, mlp, means, covs, v = setup(M, C=C)
    j_out, j_gp, j_gm = jax_run(jax_k2, params, means, covs, v, C)
    p_out, p_gp, p_gm = port_run(k2.fused_mlp_ipe_apply, mlp, means, covs, v)
    assert p_out[1].shape == j_out[1].shape == (M, C)
    for a, b in zip(p_out, j_out):
        np.testing.assert_allclose(a, b, atol=5e-3, rtol=0)
    assert rel(p_gp, j_gp) < 2e-2
    assert rel(p_gm, j_gm) < 5e-2


def _args(M=8):
    _, mlp, means, covs, v = setup(M)
    return mlp, torch.tensor(means), torch.tensor(covs), torch.tensor(v)


@pytest.mark.parametrize("fn_name", ["fused_mlp_ipe", "fused_mlp_normals"])
def test_wrapper_rejects_bad_inputs(fn_name):
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    fn = dict(fused_mlp_ipe=k2.fused_mlp_ipe_apply,
              fused_mlp_normals=k3.fused_mlp_normals_apply)[fn_name]
    mlp, means, covs, v = _args()
    kw = dict(min_deg=0, max_deg=16)
    with pytest.raises(ValueError, match="contiguous"):
        fn(mlp, means.t().contiguous().t(), covs, v, **kw)
    with pytest.raises(TypeError, match="float32"):
        fn(mlp, means.double(), covs, v, **kw)
    with pytest.raises(ValueError, match="v_enc"):
        fn(mlp, means, covs, v[:, :20].contiguous(), **kw)
    with pytest.raises(ValueError, match="topology"):
        fn(NerfMLP(96, 27, net_depth=6, num_density_channels=5), means,
           covs, v, **kw)
    with pytest.raises(ValueError, match="topology"):
        fn(mlp, means, covs, v, min_deg=0, max_deg=12)


def test_unpack_params_inverts_pack_params():
    from pano_nerf_tpu_torch.kernels.fused_render import (pack_params,
                                                          unpack_params)
    _, mlp, _, _, _ = setup(4)
    got = unpack_params(mlp, *pack_params(mlp))
    for name, p in mlp.named_parameters():
        want = p.detach().to(torch.bfloat16) if name.endswith("weight") \
            else p.detach()
        assert torch.equal(got[name], want), name


def test_unpack_params_gives_the_one_channel_head_back():
    """At C = 1 the packed density head is [16, 256] with rows 1..15 and
    bias lanes 1..15 zero; unpacking returns the [1, 256] head and its
    [1] bias, and the padding never leaks into them."""
    from pano_nerf_tpu_torch.kernels.fused_render import (pack_params,
                                                          unpack_params)
    _, mlp, _, _, _ = setup(4, C=1)
    with torch.no_grad():
        mlp.density_layer.bias.fill_(0.25)
    weights, biases = pack_params(mlp)
    assert biases.numel() == 8 * 256 + 16 + 256 + 128 + 16
    head = weights[k2.OFF_WD:k2.OFF_WD + 16 * 256].view(16, 256)
    assert torch.equal(head[0], mlp.density_layer.weight[0].detach().to(
        torch.bfloat16))
    assert not head[1:].any()
    bd = biases[8 * 256:8 * 256 + 16]
    assert float(bd[0]) == 0.25 and not bd[1:].any()
    got = unpack_params(mlp, weights, biases)
    assert got["density_layer.weight"].shape == (1, 256)
    assert got["density_layer.bias"].shape == (1,)
    assert float(got["density_layer.bias"]) == 0.25
    assert torch.equal(got["extra_layer.bias"], mlp.extra_layer.bias.detach())


@pytest.mark.parametrize("C, ok", [(1, True), (5, True), (6, False)])
def test_kernels_take_one_or_five_density_channels_on_the_card(C, ok):
    """The CUDA library is built for C = 1 (mip-NeRF) and C = 5
    (Pano-NeRF); any other count is refused on the card and taken by the
    plain version on the CPU."""
    mlp = NerfMLP(96, 27, num_density_channels=C)
    k2.check_kernel_support(mlp, 0, 16, torch.device("cpu"))
    if ok:
        k2.check_kernel_support(mlp, 0, 16, torch.device("cuda"))
        assert k2.MlpShape(C=C).defines() == (
            () if C == 5 else ("NERF_NDC=1",))
    else:
        with pytest.raises(ValueError, match="num_density_channels"):
            k2.check_kernel_support(mlp, 0, 16, torch.device("cuda"))


def test_widths_other_than_the_kernels_raise_for_the_card_only():
    """Widths past the widest build (trunk 1024, view branch 512) raise on
    the card only; narrower ones run padded in the next build."""
    wide = NerfMLP(96, 27, net_width=1100, net_width_condition=600,
                   num_density_channels=5)
    k2.check_kernel_support(wide, 0, 16, torch.device("cpu"))
    with pytest.raises(ValueError, match="net_width"):
        k2.check_kernel_support(wide, 0, 16, torch.device("cuda"))
    narrow = NerfMLP(96, 27, net_width=64, net_width_condition=32,
                     num_density_channels=5)
    k2.check_kernel_support(narrow, 0, 16, torch.device("cuda"))
    f32 = NerfMLP(96, 27, num_density_channels=5,
                  compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        k2.check_kernel_support(f32, 0, 16, torch.device("cuda"))


@pytest.mark.parametrize("fn_name", ["fused_mlp_ipe", "fused_mlp_normals"])
def test_no_cuda_tensor_reaches_a_plain_version(fn_name, monkeypatch):
    """The wrappers pick the plain version by the tensor's device alone:
    a CUDA tensor goes to the kernel (here: the library build, which
    raises without nvcc or a card) and never to the plain version."""
    from pano_nerf_tpu_torch.kernels import build
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    mod, fn, plain = dict(
        fused_mlp_ipe=(k2, k2.fused_mlp_ipe_apply,
                       "fused_mlp_ipe_reference"),
        fused_mlp_normals=(k3, k3.fused_mlp_normals_apply,
                           "fused_mlp_normals_reference"))[fn_name]

    def no_plain(*a, **k):
        raise AssertionError("a plain version was called")

    def no_build(source):
        raise RuntimeError(f"building {source}")

    monkeypatch.setattr(mod, plain, no_plain)
    monkeypatch.setattr(build, "load_library", no_build)
    mlp, means, covs, v = _args()
    meta = [t.to("meta") for t in (means, covs, v)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn(mlp, *meta, min_deg=0, max_deg=16)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda")))
    with pytest.raises(RuntimeError, match="building fused_mlp.cu"):
        fn(mlp, means, covs, v, min_deg=0, max_deg=16)


@pytest.mark.parametrize("fn_name", ["fused_mlp_ipe", "fused_mlp_normals"])
def test_one_channel_mlp_asks_for_the_one_channel_build(fn_name,
                                                        monkeypatch):
    """A CUDA tensor with a 1-channel MLP goes to the library built with
    NERF_NDC=1 (here: its build, which raises without nvcc or a card)."""
    from pano_nerf_tpu_torch.kernels import build
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    fn = dict(fused_mlp_ipe=k2.fused_mlp_ipe_apply,
              fused_mlp_normals=k3.fused_mlp_normals_apply)[fn_name]

    def no_build(source, defines=()):
        raise RuntimeError(f"building {source} with {list(defines)}")

    monkeypatch.setattr(build, "load_library", no_build)
    _, mlp, means, covs, v = setup(8, C=1)
    args = [torch.tensor(x) for x in (means, covs, v)]
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda")))
    with pytest.raises(RuntimeError,
                       match=r"building fused_mlp.cu with \['NERF_NDC=1'\]"):
        fn(mlp, *args, min_deg=0, max_deg=16)
