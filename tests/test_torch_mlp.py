"""The port's NerfMLP, normal chain and weight bridge against the JAX package.

Parameters come from the JAX `model.init` and are carried over with
`params_from_jax`; encoded inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.models import normals as jnormals
from pano_nerf_tpu.models.pano_mip_nerf import PanoMipNeRF as JaxPanoMipNeRF
from pano_nerf_tpu.utils.import_torch import export_mlp_state_dict
from pano_nerf_tpu_torch.models import normals as tnormals
from pano_nerf_tpu_torch.models.mlp import NerfMLP
from pano_nerf_tpu_torch.utils import params as bridge
import torch_threads  # noqa: F401  (tests/torch_threads.py)

WIDTH = 64


def make_pair(dtype_j, dtype_t, width=WIDTH, seed=0):
    jm = JaxPanoMipNeRF(mlp_net_width=width, mlp_net_width_condition=width // 2,
                        compute_dtype=dtype_j)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm = NerfMLP(xyz_dim=96, view_dim=27, net_width=width,
                 net_width_condition=width // 2, num_density_channels=5,
                 compute_dtype=dtype_t)
    tm.load_state_dict(bridge.params_from_jax(params))
    return jm, params, tm


def encoded_inputs(seed=1, rows=(6, 8)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, rows + (96,)).astype(np.float32)
    v = rng.uniform(-1, 1, rows[:1] + (1, 27)).astype(np.float32)
    return x, v


def test_forward_f32_matches_jax():
    jm, params, tm = make_pair(jnp.float32, torch.float32)
    x, v = encoded_inputs()
    rgb_j, den_j = jm.mlp.apply(params, x, v)
    with torch.no_grad():
        rgb_t, den_t = tm(torch.tensor(x), torch.tensor(v))
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=1e-5)
    np.testing.assert_allclose(den_t.numpy(), den_j, atol=1e-5)


def test_forward_bf16_matches_jax():
    # bf16 rounding happens at different places in the two frameworks:
    # flax rounds each layer's product and adds the bias in bf16, the port
    # (like the tensor cores) rounds only the operands and accumulates and
    # adds the bias in float32. Hence the bf16-level tolerance.
    jm, params, tm = make_pair(jnp.bfloat16, torch.bfloat16)
    x, v = encoded_inputs()
    rgb_j, den_j = jm.mlp.apply(params, x, v)
    with torch.no_grad():
        rgb_t, den_t = tm(torch.tensor(x), torch.tensor(v))
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, atol=2e-2)
    np.testing.assert_allclose(den_t.numpy(), den_j, atol=2e-2)


def test_density_grad_chain_matches_jax_and_autograd():
    jm, params, tm = make_pair(jnp.float32, torch.float32)
    rng = np.random.default_rng(2)
    means = rng.uniform(-1, 1, (5, 4, 3)).astype(np.float32)
    covs = rng.uniform(0, 1e-3, (5, 4, 3)).astype(np.float32)
    from pano_nerf_tpu.ops import mip as jmip
    from pano_nerf_tpu_torch.ops import mip as tmip
    enc_j = jmip.integrated_pos_enc(means, covs, 0, 16)
    venc = np.asarray(jmip.pos_enc(rng.normal(size=(5, 3)).astype(
        np.float32), 0, 4, True))[:, None, :]
    _, _, g_j = jnormals.mlp_with_density_grad(params, enc_j, venc, 4,
                                               jnp.float32)
    d_j = jnormals.density_means_grad(g_j, enc_j, 0, 16)

    m_t = torch.tensor(means, requires_grad=True)
    enc_t = tmip.integrated_pos_enc(m_t, torch.tensor(covs), 0, 16)
    _, den_t, g_t = tnormals.mlp_with_density_grad(tm, enc_t,
                                                   torch.tensor(venc))
    d_t = tnormals.density_means_grad(g_t, enc_t, 0, 16)
    np.testing.assert_allclose(g_t.detach().numpy(), g_j, atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(d_t.detach().numpy(), d_j, atol=1e-4,
                               rtol=1e-4)
    (auto,) = torch.autograd.grad(den_t[..., 0].sum(), m_t)
    np.testing.assert_allclose(d_t.detach().numpy(), auto.numpy(), atol=1e-4,
                               rtol=1e-3)


def test_bridge_round_trips_bit_exactly(tmp_path):
    _, params, tm = make_pair(jnp.float32, torch.float32)
    state = bridge.params_from_jax(params)
    back = bridge.params_to_jax(state)
    assert set(back["params"]) == set(params["params"])
    for mod, leaves in params["params"].items():
        for leaf, val in leaves.items():
            np.testing.assert_array_equal(back["params"][mod][leaf], val)
    bridge.save_npz(str(tmp_path / "p.npz"), params)
    loaded = bridge.load_npz(str(tmp_path / "p.npz"))
    for mod, leaves in params["params"].items():
        for leaf, val in leaves.items():
            np.testing.assert_array_equal(loaded["params"][mod][leaf], val)


def test_state_dict_uses_reference_names():
    _, params, tm = make_pair(jnp.float32, torch.float32)
    ref = export_mlp_state_dict(params, prefix="")
    ours = tm.state_dict()
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)


@pytest.mark.parametrize("seed", [0, 1])
def test_xavier_init_is_seeded(seed):
    def make():
        return NerfMLP(96, 27, num_density_channels=5,
                       generator=torch.Generator().manual_seed(seed))
    a, b = make(), make()
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.layers[5][0].weight.detach()
    bound = np.sqrt(6.0 / (352 + 256))
    assert w.shape == (256, 352)
    assert float(w.abs().max()) <= bound
    assert float(w.abs().max()) > 0.9 * bound
    assert float(a.layers[5][0].bias.detach().abs().max()) == 0.0
