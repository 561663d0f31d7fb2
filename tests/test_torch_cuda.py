"""The CUDA kernels of the port against their plain versions, on the card.

These tests need a CUDA card (a CUDA kernel has no CPU mode) and skip
without one. The file imports no JAX, so it also runs on a machine that
has the card but not JAX; there, skip the JAX-importing conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from pano_nerf_tpu_torch.kernels import fused_render as fr
from pano_nerf_tpu_torch.models.mlp import NerfMLP

KW = dict(min_deg=0, max_deg=16, deg_view=4, density_bias=-1.0,
          rgb_padding=0.0, white_bkgd=False)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); "
                    "chip_smoke.py runs this comparison on the card")
    return torch.device("cuda")


def _inputs(R, S, device):
    g = torch.Generator().manual_seed(0)
    t = torch.sort(torch.rand(R, S + 1, generator=g) * 5, -1).values
    d = torch.randn(R, 3, generator=g)
    args = [torch.randn(R, S, 3, generator=g),
            torch.rand(R, S, 3, generator=g) * 1e-3,
            d / torch.linalg.norm(d, dim=-1, keepdim=True), t, d]
    return [a.to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,need_normals", [
    (37, 56, False), (37, 56, True), (131, 5, False), (3, 64, True),
    (1023, 56, True), (10239, 5, False), (300, 1, True)])
def test_fused_render_kernel_matches_plain_version(cuda_device, R, S,
                                                   need_normals):
    mlp = NerfMLP(96, 27, num_density_channels=5,
                  generator=torch.Generator().manual_seed(1)).to(cuda_device)
    args = _inputs(R, S, cuda_device)
    kw = dict(KW, need_normals=need_normals, need_extras=need_normals)
    before = fr.fused_render_level.launches
    with torch.no_grad():
        got = fr.fused_render_level(mlp, *args, **kw)
        want = fr.fused_render_level_reference(mlp, *args, **kw)
    assert fr.fused_render_level.launches == before + 1
    for k, tol in (("rgb", 2e-2), ("distance", 2e-2), ("acc", 1e-2),
                   ("weights", 1e-2), ("albedo", 2e-2), ("roughness", 2e-2)):
        if want[k] is not None:
            torch.testing.assert_close(got[k], want[k], atol=tol, rtol=0)
    if need_normals:
        cos = torch.sum(got["normal"] * want["normal"], -1)
        assert float(cos.median()) > 0.998 and float(cos.min()) > 0.85


@pytest.mark.cuda
def test_fused_render_rejects_f32_compute_on_the_card(cuda_device):
    mlp = NerfMLP(96, 27, num_density_channels=5,
                  compute_dtype=torch.float32).to(cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        fr.fused_render_level(mlp, *_inputs(2, 8, cuda_device), **KW,
                              need_normals=False, need_extras=False)


def _mlp_rows(M, device, seed=0):
    """Moments, viewdir encodings and a full-width MLP, as the JAX kernel
    tests make them (means ~ 2 N(0,1), covs ~ 0.01 |N(0,1)|)."""
    g = torch.Generator().manual_seed(seed)
    means = torch.randn(M, 3, generator=g) * 2
    covs = torch.randn(M, 3, generator=g).abs() * 0.01
    v = torch.randn(M, 27, generator=g) * 0.5
    mlp = NerfMLP(96, 27, num_density_channels=5,
                  generator=torch.Generator().manual_seed(seed + 1))
    return mlp.to(device), means.to(device), covs.to(device), v.to(device)


def _grads(fn, mlp, means, covs, v):
    """Outputs and the gradients of a loss on all of them: params (flat)
    and means."""
    mlp.zero_grad()
    means = means.clone().requires_grad_(True)
    outs = fn(mlp, means, covs, v, min_deg=0, max_deg=16)
    loss = torch.sin(outs[0]).sum() + torch.cos(outs[1]).sum()
    if len(outs) == 3:
        loss = loss + torch.sin(0.1 * outs[2]).sum()
    loss.backward()
    flat = torch.cat([p.grad.reshape(-1) for p in mlp.parameters()])
    return [o.detach() for o in outs], flat, means.grad


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.cuda
@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("M", [1000, 28672])
def test_fused_mlp_kernels_match_plain_versions(cuda_device, normals, M):
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    kernel, plain, counter = (
        (k3.fused_mlp_normals_apply, k3.fused_mlp_normals_reference,
         k3.fused_mlp_normals_apply) if normals else
        (k2.fused_mlp_ipe_apply, k2.fused_mlp_ipe_reference,
         k2.fused_mlp_ipe_apply))
    mlp, means, covs, v = _mlp_rows(M, cuda_device)
    before = (counter.launches, counter.backward_launches)
    got, g_got, m_got = _grads(kernel, mlp, means, covs, v)
    torch.cuda.synchronize()
    assert (counter.launches, counter.backward_launches) == (
        before[0] + 1, before[1] + 2)
    want, g_want, m_want = _grads(plain, mlp, means, covs, v)
    for a, b in zip(got[:2], want[:2]):
        assert float((a - b).abs().max()) <= 2e-2
    if normals:
        assert _rel(got[2], want[2]) < 0.08
    assert _rel(g_got, g_want) < (5e-2 if normals else 2e-2)
    assert _rel(m_got, m_want) < 5e-2


@pytest.mark.cuda
def test_fused_mlp_kernels_reject_f32_compute_on_the_card(cuda_device):
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    mlp, means, covs, v = _mlp_rows(8, cuda_device)
    mlp.compute_dtype = torch.float32
    with pytest.raises(ValueError, match="bf16"):
        k2.fused_mlp_ipe_apply(mlp, means, covs, v, min_deg=0, max_deg=16)


def _render_grads(fn, mlp, args, white_bkgd, **kw):
    """Outputs of a train level and the gradients of a random-coefficient
    loss on all four w.r.t. the parameters (flat), means and t_samples."""
    g = torch.Generator().manual_seed(5)
    R, S = args[0].shape[:2]
    coef = {k: torch.randn(shape, generator=g).to(args[0].device)
            for k, shape in (("rgb", (R, 3)), ("acc", (R,)),
                             ("distance", (R,)), ("weights", (R, S)))}
    mlp.zero_grad()
    means = args[0].clone().requires_grad_(True)
    t = args[3].clone().requires_grad_(True)
    out = fn(mlp, means, args[1], args[2], t, args[4],
             **dict(KW, white_bkgd=white_bkgd), **kw)
    sum(torch.sum(out[k] * c) for k, c in coef.items()).backward()
    flat = torch.cat([p.grad.reshape(-1) for p in mlp.parameters()])
    return {k: v.detach() for k, v in out.items()}, flat, means.grad, t.grad


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,white_bkgd", [
    (37, 56, False), (37, 56, True), (131, 5, False), (13, 5, False)])
def test_fused_render_train_kernels_match_plain_version(cuda_device, R, S,
                                                        white_bkgd):
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    mlp = NerfMLP(96, 27, num_density_channels=5,
                  generator=torch.Generator().manual_seed(1)).to(cuda_device)
    args = _inputs(R, S, cuda_device)
    args[3][R // 2] = 1.0  # one empty ray: all samples at one depth
    want, gp_want, gm_want, gt_want = _render_grads(
        k5.fused_render_train_reference, mlp, args, white_bkgd)
    runs = {}
    for save_acts in (False, True):
        before = (k5.fused_render_train.launches,
                  k5.fused_render_train.backward_launches)
        runs[save_acts] = _render_grads(k5.fused_render_train, mlp, args,
                                        white_bkgd, save_acts=save_acts)
        torch.cuda.synchronize()
        assert (k5.fused_render_train.launches,
                k5.fused_render_train.backward_launches) == (
            before[0] + 1, before[1] + 2)
        got, gp, gm, gt = runs[save_acts]
        # Weights at 2e-3, a tenth of a typical weight at S = 56: the
        # backward recomputes them, so only this check sees the written ones.
        for k, tol in (("rgb", 2e-2), ("distance", 2e-2), ("acc", 1e-2),
                       ("weights", 2e-3)):
            torch.testing.assert_close(got[k], want[k], atol=tol, rtol=0)
        assert _rel(gp, gp_want) < 2e-2
        assert _rel(gm, gm_want) < 5e-2 and _rel(gt, gt_want) < 5e-2
        assert not gm[R // 2].any() and torch.isfinite(gt).all()
    for k in want:
        assert torch.equal(runs[False][0][k], runs[True][0][k]), k
    assert torch.equal(runs[False][2], runs[True][2])


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1000, 28672])
def test_fused_mlp_apply_kernels_match_plain_version(cuda_device, M):
    from pano_nerf_tpu_torch.kernels import fused_mlp as k1
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(M, 96, generator=g) * 0.5).to(cuda_device)
    v = (torch.randn(M, 27, generator=g) * 0.5).to(cuda_device)
    mlp = NerfMLP(96, 27, num_density_channels=5,
                  generator=torch.Generator().manual_seed(1)).to(cuda_device)
    res = []
    for fn in (k1.fused_mlp_apply, k1.fused_mlp_apply_reference):
        before = (k1.fused_mlp_apply.launches,
                  k1.fused_mlp_apply.backward_launches)
        mlp.zero_grad()
        xr = x.clone().requires_grad_(True)
        outs = fn(mlp, xr, v)
        (torch.sin(outs[0]).sum() + torch.cos(outs[1]).sum()).backward()
        torch.cuda.synchronize()
        launched = (k1.fused_mlp_apply.launches - before[0],
                    k1.fused_mlp_apply.backward_launches - before[1])
        assert launched == ((1, 2) if fn is k1.fused_mlp_apply else (0, 0))
        res.append(([o.detach() for o in outs], torch.cat(
            [p.grad.reshape(-1) for p in mlp.parameters()]), xr.grad))
    (got, gp, gx), (want, gp_want, gx_want) = res
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 2e-2
    assert _rel(gp, gp_want) < 2e-2
    assert _rel(gx, gx_want) < 5e-2


@pytest.mark.cuda
def test_fused_mlp_apply_rejects_other_density_counts_on_the_card(
        cuda_device):
    from pano_nerf_tpu_torch.kernels import fused_mlp as k1
    mlp = NerfMLP(96, 27, num_density_channels=4).to(cuda_device)
    x = torch.zeros(8, 96, device=cuda_device)
    v = torch.zeros(8, 27, device=cuda_device)
    with pytest.raises(ValueError, match="num_density_channels"):
        k1.fused_mlp_apply(mlp, x, v)


def _job_blocks(dw, normals):
    """The packed weight gradient per job of the weight-gradient pass."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    return [dw.as_strided((n, k), (ldo, 1), out)
            for _, _, _, _, n, k, out, ldo in k2.wgrad_jobs(normals)]


@pytest.mark.cuda
@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("rows", [1088, 28672])
def test_weight_grad_kernel_matches_plain_version(cuda_device, normals,
                                                  rows):
    """The TMA + wgmma weight-gradient pass against its plain version on
    the same bf16 operand rows: only the order of the f32 sums differs,
    so rel-norm 1e-4 per job."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    width = k2.OPW_NRM if normals else k2.OPW_IPE
    g = torch.Generator(device=cuda_device).manual_seed(rows + normals)
    ops = torch.randn(rows, width, generator=g, device=cuda_device,
                      dtype=torch.float32).to(torch.bfloat16)
    dw = torch.zeros(k2.W_TOTAL, device=cuda_device)
    k2.launch_weight_grads(k2.kernel_library(), ops, dw, normals)
    want = k2.weight_grads_reference(ops, normals)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(_job_blocks(dw, normals),
                                   _job_blocks(want, normals))):
        assert _rel(a, b) <= 1e-4, i


@pytest.mark.cuda
def test_weight_grad_kernel_refuses_a_bad_job_table(cuda_device):
    """A job wider than one wgmma N (256 fan-in columns) is refused
    before launch, and the wrapper raises."""
    import ctypes
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    lib = k2.kernel_library()
    ops = torch.zeros(64, k2.OPW_IPE, dtype=torch.bfloat16,
                      device=cuda_device)
    dw = torch.zeros(k2.W_TOTAL, device=cuda_device)
    bad = (ctypes.c_int * 8)(k2.O_DZ, k2.O_A, -1, -1, 256, 288, 0, 288)
    err = lib.fused_mlp_weight_grads(
        ops.data_ptr(), dw.data_ptr(), 64, 0, bad, 1,
        torch.cuda.current_stream(cuda_device).cuda_stream)
    with pytest.raises(RuntimeError, match="weight gradients"):
        k2.check_launch(lib, "fused_mlp weight gradients", err)
