"""The weight-gradient pass's plain version and its column layout, on the CPU.

The backward of kernels 1, 2, 3 and 5 is two launches: a row pass that
writes every operand of every weight-gradient product as bf16 rows
(`ops`, column layout of csrc/mlp_rows.cuh) and a pass that reduces
dW = B^T A over the rows (job table of `fused_mlp_weight_grads`). Here the
operand rows of a small batch are filled from the plain MLP's activations
and cotangents (for NORMALS also the chain's sz and the walk's c), and
`weight_grads_reference` of them is held against torch autograd's weight
gradients of `fused_mlp_ipe_reference` / `fused_mlp_normals_reference`
(the chain in float64 on both sides, the pass in f32; rel-norm 1e-5 per
parameter), and against the JAX Pallas kernels'
weight gradients (interpret mode) at the tolerances of
tests/test_torch_fused_mlp_ipe.py (2e-2) and test_torch_fused_mlp_normals.py
(5e-2). The CUDA pass is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.kernels.fused_mlp_ipe import fused_mlp_ipe_apply as jax_k2
from pano_nerf_tpu.kernels.fused_mlp_normals import (
    fused_mlp_normals_apply as jax_k3)
from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
from pano_nerf_tpu_torch.kernels.fused_render import pack_params, unpack_params
from pano_nerf_tpu_torch.models.mlp import round_to
from pano_nerf_tpu_torch.ops import mip
import torch_threads  # noqa: F401  (tests/torch_threads.py)

W = 256


def _rows(M, seed):
    """Moments, viewdir codes and output cotangents, made with numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(means=f(M, 3) * 2, covs=np.abs(f(M, 3)) * 0.01,
                v=f(M, 27) * 0.5, g_rgb=f(M, 3), g_den=f(M, 5), q=f(M, 3))


def _setup(M, seed=0):
    """Inputs and a full-width MLP bridged from a JAX init (as the kernel
    tests make it), with f32 compute."""
    from tests.test_torch_fused_mlp_ipe import setup
    params, mlp, _, _, _ = setup(4, seed)
    mlp.compute_dtype = torch.float32
    return params, mlp, _rows(M, seed + 10)


def operand_rows(mlp, d, normals, dt=torch.float32):
    """The row pass's operand rows [M, OPW] from the plain MLP: forward
    activations, the MLP backward from the head cotangents and, for
    NORMALS, the chain sz_i = m_i s_i and the walk c_i of the dsig
    cotangent q. `dt` bf16 rounds where the kernels round (every product
    operand and every operand row), f32 rounds nothing; the rows are
    computed in the MLP's parameter dtype (float64 for the autograd
    check). Also returns the
    column sum of c_7, the walk's part of Wd's sigma row (the row pass
    adds it into dw itself)."""
    R = lambda t: round_to(t, dt)
    ft = mlp.layers[0][0].weight.dtype   # float64 for the autograd check
    T = lambda a: torch.tensor(a, dtype=ft)
    means, covs = T(d["means"]), T(d["covs"])
    M = means.shape[0]
    x32 = mip.integrated_pos_enc(means, covs, 0, 16)
    x = R(x32)
    Ws = [R(s[0].weight) for s in mlp.layers]
    h, acts = x, []
    for i, w in enumerate(Ws):
        a = R(torch.relu(h @ w.t() + mlp.layers[i][0].bias))
        acts.append(a)
        h = torch.cat([a, x], -1) if i == 4 else a
    a7 = acts[7]
    Wd, Wb = R(mlp.density_layer.weight), R(mlp.extra_layer.weight)
    Wv, Wc = R(mlp.view_layers[0][0].weight), R(mlp.color_layer.weight)
    btl = R(a7 @ Wb.t() + mlp.extra_layer.bias)
    v = R(T(d["v"]))
    hv = R(torch.relu(torch.cat([btl, v], -1) @ Wv.t()
                      + mlp.view_layers[0][0].bias))
    gr, gd = R(T(d["g_rgb"])), R(T(d["g_den"]))
    dzv = R((gr @ Wc) * (hv > 0))
    dbtl = R((dzv @ Wv)[:, :W])
    da = gd @ Wd + dbtl @ Wb
    dz = [None] * 8
    for i in range(7, -1, -1):
        dz[i] = R(da * (acts[i] > 0))
        da = (dz[i] @ Ws[i])[:, :W]
    ops = torch.zeros(M, k2.OPW_NRM if normals else k2.OPW_IPE, dtype=ft)

    def put(col, t):
        ops[:, col:col + t.shape[1]] = t
    put(k2.O_X, x)
    for i in range(8):
        put(k2.O_A + i * W, acts[i])
        put(k2.O_DZ + i * W, dz[i])
    put(k2.O_BTL, btl)
    put(k2.O_V, v)
    put(k2.O_HV, hv)
    put(k2.O_GD, gd)
    put(k2.O_DBTL, dbtl)
    put(k2.O_DZV, dzv)
    put(k2.O_GR, gr)
    if not normals:
        return ops, None
    # The chain from Wd's sigma row, then the walk of q through it.
    s = Wd[0].expand(M, W)
    for i in range(7, -1, -1):
        sz = R(s * (acts[i] > 0))
        put(k2.O_SZ + i * W, sz)
        s = (sz @ Ws[i])[:, :W]
    q = T(d["q"])
    scale = 2.0 ** torch.arange(16, dtype=ft).repeat_interleave(3)
    qs = q.repeat(1, 16) * scale
    cgx = R(torch.cat([qs * x32[:, 48:], -qs * x32[:, :48]], -1))
    put(k2.O_CGX, cgx)
    c = cgx
    for i in range(8):
        inp = torch.cat([c, cgx], -1) if i == 5 else c
        c = R((inp @ Ws[i].t()) * (acts[i] > 0))
        if i < 7:
            put(k2.O_C + i * W, c)
    return ops, c.sum(0)


def _autograd_grads(mlp, d, normals):
    """Weight gradients of sum(g . outputs) (+ q . dsig) by torch autograd
    of the plain version, in the MLP's parameter dtype."""
    mlp.zero_grad(set_to_none=True)
    T = lambda a: torch.tensor(a, dtype=mlp.layers[0][0].weight.dtype)
    args = (T(d["means"]), T(d["covs"]), T(d["v"]))
    if normals:
        rgb, den, dsig = k3.fused_mlp_normals_reference(
            mlp, *args, min_deg=0, max_deg=16)
        extra = torch.sum(dsig * T(d["q"]))
    else:
        rgb, den = k2.fused_mlp_ipe_reference(mlp, *args, min_deg=0,
                                              max_deg=16)
        extra = 0.0
    (torch.sum(rgb * T(d["g_rgb"]))
     + torch.sum(den * T(d["g_den"])) + extra).backward()
    return {n: p.grad.clone() for n, p in mlp.named_parameters()
            if n.endswith("weight")}


def _reference_grads(mlp, d, normals, dt=torch.float32):
    with torch.no_grad():
        ops, c7_sum = operand_rows(mlp, d, normals, dt)
        dw = k2.weight_grads_reference(ops.to(dt), normals)
    if normals:
        dw[k2.OFF_WD:k2.OFF_WD + W] += c7_sum
    db = torch.zeros(pack_params(mlp)[1].numel())
    return {n: g for n, g in unpack_params(mlp, dw, db).items()
            if n.endswith("weight")}


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("M", [192, 77])
def test_reference_matches_autograd_weight_grads(M, normals):
    """The chain (activations, cotangents, sz, c) runs in float64 on both
    sides, so only what is under test rounds: the operand rows to f32 and
    `weight_grads_reference`'s f32 products. Run in f32, two chains of 8
    layers sum in orders that MKL picks by host CPU and thread count, and
    layer 0's gradient differs between them by up to ~1e-5 on its own."""
    _, mlp, d = _setup(M)
    mlp.double()
    want = _autograd_grads(mlp, d, normals)
    got = _reference_grads(mlp, d, normals)
    assert set(got) == set(want)
    for name in want:
        rel = _rel(got[name], want[name])
        assert rel < 1e-5, f"{name}: rel-norm {rel:.3e} >= 1e-5"


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("M", [192, 77])
def test_reference_matches_pallas_weight_grads(interpret, M, normals):
    params, mlp, d = _setup(M)
    got = _reference_grads(mlp, d, normals, torch.bfloat16)

    def loss(p, m):
        outs = (jax_k3 if normals else jax_k2)(
            p, m, jnp.asarray(d["covs"]), jnp.asarray(d["v"]), 5, 0, 16)
        val = (jnp.sum(outs[0] * d["g_rgb"]) + jnp.sum(outs[1] * d["g_den"]))
        if normals:
            val = val + jnp.sum(outs[2] * d["q"])
        return val
    gp = jax.grad(loss)(params, jnp.asarray(d["means"]))
    want = {n: torch.tensor(np.asarray(v)) for n, v in params_to_jax_names(
        gp).items()}
    tol = 5e-2 if normals else 2e-2
    flat = lambda g: torch.cat([g[n].reshape(-1).float() for n in sorted(g)])
    assert _rel(flat(got), flat(want)) < tol
    for name in want:
        assert got[name].shape == want[name].shape, name


def params_to_jax_names(jax_grads):
    """JAX gradients as {port weight name: [out, in] array}."""
    from pano_nerf_tpu_torch.utils.params import params_from_jax
    sd = params_from_jax(jax.tree.map(np.asarray, jax_grads))
    return {n: v for n, v in sd.items() if n.endswith("weight")}


def test_reference_rejects_the_wrong_width():
    with pytest.raises(ValueError, match="rows"):
        k2.weight_grads_reference(torch.zeros(64, k2.OPW_IPE), True)


def test_job_table_covers_every_packed_weight_once():
    """Every packed weight element is written by at most one job pair,
    and every real (unpadded) weight by exactly one job."""
    for normals in (False, True):
        hits = torch.zeros(k2.W_TOTAL)
        for b1, a1, b2, a2, n, k, out, ldo in k2.wgrad_jobs(normals):
            hits.as_strided((n, k), (ldo, 1), out).add_(1)
            assert (b2 >= 0) == (normals and n == W and b1 < k2.O_GD)
        assert int(hits.max()) == 1
        assert int((hits == 0).sum()) == 0


def test_reference_in_bf16_rounds_only_the_operands():
    _, mlp, d = _setup(64, seed=3)
    with torch.no_grad():
        ops, _ = operand_rows(mlp, d, False)
    a = k2.weight_grads_reference(ops.to(torch.bfloat16), False)
    b = k2.weight_grads_reference(ops.to(torch.bfloat16).float(), False)
    assert torch.equal(a, b)


@pytest.mark.parametrize("normals", [False, True])
def test_job_table_meets_the_kernel_limits(normals):
    """The flat C table the CUDA pass is handed is `wgrad_jobs`, and each
    job is within the limits `fused_mlp_weight_grads` checks: at most 16
    jobs, fan-in <= 256 (one wgmma N) in whole 16-byte pieces of dw,
    operand columns inside the rows, the output inside the packed
    buffer."""
    jobs = k2.wgrad_jobs(normals)
    assert list(k2._job_table(normals)) == [v for j in jobs for v in j]
    assert 0 < len(jobs) <= 16
    width = k2.OPW_NRM if normals else k2.OPW_IPE
    for b1, a1, b2, a2, n, k, out, ldo in jobs:
        assert 0 < n and 0 < k <= 256 and k % 4 == 0
        assert out % 4 == 0 and ldo % 4 == 0 and ldo >= k
        assert 0 <= b1 and b1 + n <= width and 0 <= a1 and a1 + k <= width
        if b2 >= 0:
            assert b2 + n <= width and 0 <= a2 and a2 + k <= width
        assert out + (n - 1) * ldo + k <= k2.W_TOTAL
