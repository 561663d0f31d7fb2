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


def _mlp_rows(M, device, seed=0, C=5):
    """Moments, viewdir encodings and a full-width MLP with C density
    channels, as the JAX kernel tests make them (means ~ 2 N(0,1), covs ~
    0.01 |N(0,1)|)."""
    g = torch.Generator().manual_seed(seed)
    means = torch.randn(M, 3, generator=g) * 2
    covs = torch.randn(M, 3, generator=g).abs() * 0.01
    v = torch.randn(M, 27, generator=g) * 0.5
    mlp = NerfMLP(96, 27, num_density_channels=C,
                  generator=torch.Generator().manual_seed(seed + 1))
    return mlp.to(device), means.to(device), covs.to(device), v.to(device)


def _grads(fn, mlp, means, covs, v, min_deg=0, max_deg=16):
    """Outputs and the gradients of a loss on all of them: params (flat)
    and means."""
    mlp.zero_grad()
    means = means.clone().requires_grad_(True)
    outs = fn(mlp, means, covs, v, min_deg=min_deg, max_deg=max_deg)
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
@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("M", [1000, 131072])
def test_one_channel_kernels_match_plain_versions(cuda_device, normals, M):
    """Kernels 2 and 3 built for mip-NeRF's one density channel, at a
    ragged M and at a batch-2048 level (2048 x 64 rows): outputs, every
    gradient and, apart, the density head's (its 15 padded rows must add
    nothing), at kernel 2 and 3's tolerances."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    kernel, plain, counter = (
        (k3.fused_mlp_normals_apply, k3.fused_mlp_normals_reference,
         k3.fused_mlp_normals_apply) if normals else
        (k2.fused_mlp_ipe_apply, k2.fused_mlp_ipe_reference,
         k2.fused_mlp_ipe_apply))
    mlp, means, covs, v = _mlp_rows(M, cuda_device, C=1)
    heads = {}

    def run(fn):
        got = _grads(fn, mlp, means, covs, v)
        heads[fn] = torch.cat([mlp.density_layer.weight.grad.reshape(-1),
                               mlp.density_layer.bias.grad])
        return got

    before = (counter.launches, counter.backward_launches)
    got, g_got, m_got = run(kernel)
    torch.cuda.synchronize()
    assert (counter.launches, counter.backward_launches) == (
        before[0] + 1, before[1] + 2)
    want, g_want, m_want = run(plain)
    assert got[1].shape == want[1].shape == (M, 1)
    for a, b in zip(got[:2], want[:2]):
        assert float((a - b).abs().max()) <= 2e-2
    if normals:
        assert _rel(got[2], want[2]) < 0.08
    tol = 5e-2 if normals else 2e-2
    assert _rel(g_got, g_want) < tol
    assert _rel(heads[kernel], heads[plain]) < tol
    assert _rel(m_got, m_want) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1000, 25600])
def test_ipe_kernel_matches_plain_version_at_tight_covariances(cuda_device,
                                                               M):
    """Kernel 2 on the HDR presets' tight re-read: covariances x 0.01
    (`nerf.env_tight_rgb`), where the in-kernel IPE damps its high
    degrees least, at a ragged M and at a batch-512 env march (512 x 10
    x 5 rows), forward and backward at kernel 2's tolerances."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    mlp, means, covs, v = _mlp_rows(M, cuda_device, seed=2)
    covs = covs * 0.01
    got, g_got, m_got = _grads(k2.fused_mlp_ipe_apply, mlp, means, covs, v)
    want, g_want, m_want = _grads(k2.fused_mlp_ipe_reference, mlp, means,
                                  covs, v)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 2e-2
    assert _rel(g_got, g_want) < 2e-2
    assert _rel(m_got, m_want) < 5e-2


@pytest.mark.cuda
def test_normals_kernel_eval_forward_saves_no_trunk(cuda_device):
    """Kernel 3's forward at 5 density channels without a gradient (the
    presets' eval fine level, 1,024 x 56 rows): one launch, no backward,
    outputs at kernel 3's tolerances; with a gradient the same forward
    saves its trunk (the backward then runs)."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    mlp, means, covs, v = _mlp_rows(57344, cuda_device, seed=3)
    counter = k3.fused_mlp_normals_apply
    before = (counter.launches, counter.backward_launches)
    with torch.no_grad():
        got = k3.fused_mlp_normals_apply(mlp, means, covs, v, min_deg=0,
                                         max_deg=16)
        want = k3.fused_mlp_normals_reference(mlp, means, covs, v,
                                              min_deg=0, max_deg=16)
    torch.cuda.synchronize()
    assert (counter.launches, counter.backward_launches) == (
        before[0] + 1, before[1])
    assert got[1].shape == (57344, 5) and not got[0].requires_grad
    for a, b in zip(got[:2], want[:2]):
        assert float((a - b).abs().max()) <= 2e-2
    assert _rel(got[2], want[2]) < 0.08


@pytest.mark.cuda
def test_fused_mlp_kernels_refuse_other_density_counts_on_the_card(
        cuda_device):
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    mlp, means, covs, v = _mlp_rows(8, cuda_device, C=4)
    for fn in (k2.fused_mlp_ipe_apply, k3.fused_mlp_normals_apply):
        with pytest.raises(ValueError, match="num_density_channels"):
            fn(mlp, means, covs, v, min_deg=0, max_deg=16)


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
             **{**KW, "white_bkgd": white_bkgd, **kw})
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
    sync = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    err = lib.fused_mlp_weight_grads(
        ops.data_ptr(), dw.data_ptr(), 64, 0, bad, 1, sync.data_ptr(), 3,
        torch.cuda.current_stream(cuda_device).cuda_stream)
    with pytest.raises(RuntimeError, match="weight gradients"):
        k2.check_launch(lib, "fused_mlp weight gradients", err)


def _graph_system(cuda_device, render_kernel, n_rays=16384,
                  config="panonerf.yaml"):
    """A shipped config at full width on the card, random weights, and a
    random resident ray set of `n_rays` rays inside a scene-sized box."""
    import os
    from pano_nerf_tpu_torch.core.config import load_config
    from pano_nerf_tpu_torch.core.rays import Rays
    from pano_nerf_tpu_torch.data.pano_dataset import generate_lit_rays
    from pano_nerf_tpu_torch.engine.system import build_system
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hp = load_config(os.path.join(repo, "configs", config),
                     ["val.chunk_size", "256"])
    hp["nerf.use_train_render_kernel"] = render_kernel
    system = build_system(hp, device=cuda_device, init_seed=0)
    if system.surface:
        system.set_env_rays(generate_lit_rays(hp["nerf.num_ray_samples"],
                                              far=10.0, radius=0.0142))
    g = torch.Generator().manual_seed(1)
    d = torch.randn(n_rays, 3, generator=g)
    ones = torch.ones(n_rays, 1)
    rays = Rays(origins=(torch.rand(n_rays, 3, generator=g) - 0.5) * 0.6,
                directions=d,
                viewdirs=d / torch.linalg.norm(d, dim=-1, keepdim=True),
                radii=ones * 0.0142, lossmult=ones, near=ones * 0.0,
                far=ones * 10.0, noise_var=ones * 0.0)
    rays = Rays(*(x.to(cuda_device).contiguous() for x in rays))
    rgbs = torch.rand(n_rays, 3, generator=g).to(cuda_device)
    return system, (rays, rgbs)


@pytest.mark.cuda
@pytest.mark.parametrize("render_kernel", [False, True])
def test_graphed_train_steps_match_eager(cuda_device, render_kernel):
    """16 steps at batch 512 from one state as two replays of an 8-step
    CUDA graph and, four times, eagerly (as chip_smoke.py holds them on
    the trained system): the generator ends in the same state, and the
    graph's median distance to the eager runs (parameters, per-step
    losses) is at most twice the largest eager-vs-eager distance or f32
    rounding (the backwards add their f32 partials in a fixed order, so
    that spread is 0 where every op of the step is deterministic); each
    replay adds one capture's worth of launches to the counters."""
    system, data = _graph_system(cuda_device, render_kernel)
    _check_graphed_against_eager(cuda_device, system, data, 512)


@pytest.mark.cuda
def test_graphed_mipnerf_train_steps_match_eager(cuda_device):
    """The same for `configs/mipnerf.yaml` at its batch of 2048 (kernels 2
    and 3 at one density channel)."""
    system, data = _graph_system(cuda_device, False, config="mipnerf.yaml")
    _check_graphed_against_eager(cuda_device, system, data, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["panonerf_hdr.yaml",
                                    "panonerf_shadow.yaml"])
def test_graphed_preset_train_steps_match_eager(cuda_device, config):
    """The same for the HDR presets at batch 512: the tight re-read on
    kernel 2 and, for the shadow preset, the env-distill march and its
    scheduled tie."""
    system, data = _graph_system(cuda_device, False, config=config)
    _check_graphed_against_eager(cuda_device, system, data, 512)


def _check_graphed_against_eager(cuda_device, system, data, batch):
    import statistics
    from pano_nerf_tpu_torch.kernels import counters
    mlp = system.model.mlp
    start = {k: v.clone() for k, v in mlp.state_dict().items()}

    def run(graphed):
        mlp.load_state_dict(start)
        state = system.create_state()
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        if graphed:
            fn = system.make_train_step_device_data(state, data, gen, True,
                                                    batch, 8)
            first = fn(state)[1].clone()
            before = counters.launch_counts()
            losses = torch.cat([first, fn(state)[1].clone()])
            after = counters.launch_counts()
            assert fn.graph.replays == 2
            assert {k: after[k] - before[k] for k in after
                    if after[k] != before[k]} == fn.graph.launches
        else:
            one = system.make_device_step(data, gen, True, batch)
            losses = torch.stack([one(state)["loss"] for _ in range(16)])
        assert state.step == 16 and int(state.step_t) == 16
        flat = torch.cat([p.detach().reshape(-1) for p in mlp.parameters()])
        return flat.clone(), losses.cpu(), gen.get_state()

    eager = [run(False) for _ in range(4)]
    graph = run(True)
    assert bool(torch.isfinite(graph[1]).all())
    assert all(torch.equal(graph[2], e[2]) for e in eager)
    for dist, floor in (
            (lambda a, b: _rel(a[0], b[0]), 1e-6),
            (lambda a, b: float((a[1] - b[1]).abs().max()),
             1e-6 * float(eager[0][1].abs().max()))):
        spread = max(dist(a, b) for i, a in enumerate(eager)
                     for b in eager[:i])
        got = statistics.median(dist(graph, e) for e in eager)
        assert got <= max(2 * spread, floor), (got, spread)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k2", "k3", "k1", "k5"])
def test_backward_gives_the_same_bits_at_every_run(cuda_device, kernel):
    """Each backward, three times on the same inputs: the same gradients
    bit for bit (the bias sums over tiles and the weight-gradient pass's
    row chunks add in a fixed order, csrc/mlp_rows.cuh `bias_sums`), at a
    ragged row count and at a batch-512 train step's (28,672 rows: 448
    tiles, 14 groups of the bias sums, 5 chunks of the weight-gradient
    pass)."""
    from pano_nerf_tpu_torch.kernels import fused_mlp as k1
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    for M in (1000, 28672):
        if kernel == "k5":
            R, S = M // 56 + 1, 56
            mlp = NerfMLP(96, 27, num_density_channels=5, generator=torch.
                          Generator().manual_seed(1)).to(cuda_device)
            args = _inputs(R, S, cuda_device)
            runs = [_render_grads(k5.fused_render_train, mlp, args, False)[1:]
                    for _ in range(3)]
        elif kernel == "k1":
            mlp, *_ = _mlp_rows(M, cuda_device)
            g = torch.Generator().manual_seed(3)
            x = (torch.randn(M, 96, generator=g) * 0.5).to(cuda_device)
            v = (torch.randn(M, 27, generator=g) * 0.5).to(cuda_device)

            def run():
                mlp.zero_grad()
                xr = x.clone().requires_grad_(True)
                raw = k1.fused_mlp_apply(mlp, xr, v)
                torch.sin(raw[0]).sum().backward()
                return (torch.cat([p.grad.reshape(-1)
                                   for p in mlp.parameters()]), xr.grad)
            runs = [run() for _ in range(3)]
        else:
            fn = (k3.fused_mlp_normals_apply if kernel == "k3"
                  else k2.fused_mlp_ipe_apply)
            mlp, means, covs, v = _mlp_rows(M, cuda_device)
            runs = [_grads(fn, mlp, means, covs, v)[1:] for _ in range(3)]
        for r in runs[1:]:
            for a, b in zip(r, runs[0]):
                assert torch.equal(a, b), (kernel, M)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k2", "k3", "k5"])
def test_bias_gradients_match_plain_version_per_leaf(cuda_device, kernel):
    """Each bias gradient leaf (the fixed-order sums over tiles, the last
    group's write of db) against the plain version at a batch-512 train
    step's 28,672 rows and a ragged 1,000, per leaf at the flat gradient's
    rel-norm tolerance (2e-2; kernel 3 5e-2), so no layer's bias hides
    under the others."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    for M in (1000, 28672):
        if kernel == "k5":
            R, S = M // 56 + 1, 56
            mlp = NerfMLP(96, 27, num_density_channels=5, generator=torch.
                          Generator().manual_seed(1)).to(cuda_device)
            args = _inputs(R, S, cuda_device)
            leaves = []
            for fn in (k5.fused_render_train, k5.fused_render_train_reference):
                _render_grads(fn, mlp, args, False)
                leaves.append({n: p.grad.clone() for n, p in
                               mlp.named_parameters() if n.endswith("bias")})
        else:
            kern, plain = ((k3.fused_mlp_normals_apply,
                            k3.fused_mlp_normals_reference) if kernel == "k3"
                           else (k2.fused_mlp_ipe_apply,
                                 k2.fused_mlp_ipe_reference))
            mlp, means, covs, v = _mlp_rows(M, cuda_device)
            leaves = []
            for fn in (kern, plain):
                _grads(fn, mlp, means, covs, v)
                leaves.append({n: p.grad.clone() for n, p in
                               mlp.named_parameters() if n.endswith("bias")})
        got, want = leaves
        tol = 5e-2 if kernel == "k3" else 2e-2
        for n in want:
            assert _rel(got[n], want[n]) < tol, (kernel, M, n)


@pytest.mark.cuda
@pytest.mark.parametrize("config, render_kernel, batch", [
    ("panonerf.yaml", False, 512), ("panonerf.yaml", True, 512),
    ("mipnerf.yaml", False, 2048)])
def test_eager_train_steps_give_the_same_bits_at_every_run(
        cuda_device, config, render_kernel, batch):
    """Four eager train steps from one state, twice: the same parameters
    bit for bit, so the graphed-vs-eager checks' spread is 0 on the kernel
    route."""
    system, data = _graph_system(cuda_device, render_kernel, config=config)
    start = {k: v.clone() for k, v in system.model.param_state().items()}

    def run():
        system.model.load_params(start)
        state = system.create_state()
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        one = system.make_device_step(data, gen, True, batch)
        for _ in range(4):
            one(state)
        return torch.cat([p.detach().reshape(-1)
                          for p in system.params()]).clone()
    first = run()
    assert torch.equal(run(), first)


@pytest.mark.cuda
def test_eval_chunk_graph_matches_eager_chunks(cuda_device):
    """A ragged 600-ray render through the chunk graph (3 replays of a
    256-ray chunk) against `render_chunk` run eagerly on the same chunks,
    f32 atol 1e-4; new weights are seen by the next call."""
    system, (rays, _) = _graph_system(cuda_device, False)
    _check_chunk_graph(system, rays, 21)


@pytest.mark.cuda
def test_mipnerf_chunk_graph_matches_eager_chunks(cuda_device):
    """The same for `configs/mipnerf.yaml`: 5 products (11 columns) per
    ray, through kernel 2 (coarse) and kernel 3's forward (fine)."""
    system, (rays, _) = _graph_system(cuda_device, False,
                                      config="mipnerf.yaml")
    _check_chunk_graph(system, rays, 11)


@pytest.mark.cuda
def test_preset_chunk_graph_matches_eager_chunks(cuda_device):
    """The same for `configs/panonerf_hdr.yaml`: 9 products (21 columns)
    per ray through kernel 2 (coarse, env march, tight re-read) and
    kernel 3's forward (fine), with plain compositing."""
    system, (rays, _) = _graph_system(cuda_device, False,
                                      config="panonerf_hdr.yaml")
    _check_chunk_graph(system, rays, 21)


def _check_chunk_graph(system, rays, width):
    from pano_nerf_tpu_torch.core.rays import rays_map
    from pano_nerf_tpu_torch.kernels.fused_render import pack_params
    rays = rays_map(lambda x: x[:600].contiguous(), rays)
    render_fn = system.make_render_image()

    def eager():
        padded = rays_map(lambda x: torch.cat(
            [x, x[-1:].expand(168, x.shape[-1])], 0), rays)
        with torch.no_grad():
            packed = pack_params(system.model.mlp)
            return torch.cat([system.render_chunk(rays_map(
                lambda x: x[i:i + 256].contiguous(), padded), packed)
                for i in range(0, 768, 256)])[:600].cpu()

    for _ in range(2):
        got = render_fn(None, rays)
        want = eager()
        got = torch.cat([got[k] for k in got], 1)
        assert got.shape == want.shape == (600, width)
        assert float((got - want).abs().max()) <= 1e-4
        with torch.no_grad():
            for p in system.model.mlp.parameters():
                p.mul_(0.9)


@pytest.mark.cuda
def test_resumed_graphed_run_continues_the_random_stream(cuda_device,
                                                         tmp_path):
    """16 graphed steps (K = 4) in one run, and 8 then a resume to 16 (the
    second trainer restores the checkpoint, then captures its graphs):
    the same generator state and step at the end, the same log steps, and
    losses within the weight-gradient pass's run-to-run noise."""
    import json
    import os
    from pano_nerf_tpu_torch import train as train_entry
    from pano_nerf_tpu_torch.data.synthetic import generate_scene
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = str(tmp_path / "scene")
    generate_scene(scene, n_views=3, height=32, width=64, seed=0)

    def fit(out, steps):
        return train_entry.main([
            "--data_path", scene, "--out_dir", out, "--config",
            os.path.join(repo, "configs", "panonerf.yaml"), "--init_seed",
            "0", "train.factor", "1", "val.factor", "1", "train.sample_num",
            "'n0_1'", "train.batch_size", "64", "log_every_n_step", "4",
            "val.check_every_n_epoch", "1", "train.steps_per_call", "4",
            "optimizer.max_steps", str(steps)])

    straight = fit(str(tmp_path / "a"), 16)
    fit(str(tmp_path / "b"), 8)
    resumed = fit(str(tmp_path / "b"), 16)
    a, b = straight.ckpt.restore(), resumed.ckpt.restore()
    assert a["step"] == b["step"] == 16
    assert torch.equal(a["generator"], b["generator"])
    losses = []
    for out in ("a", "b"):
        with open(os.path.join(str(tmp_path / out), "panonerf_0_1",
                               "metrics.jsonl")) as fp:
            recs = [r for r in map(json.loads, fp) if r["kind"] == "train"]
        assert [r["step"] for r in recs] == [4, 8, 12, 16]
        losses.append([r["loss"] for r in recs])
    assert max(abs(x - y) / abs(y) for x, y in zip(*losses)) < 0.05


# The shapes the kernels are built for beside the shipped one
# (kernels/shapes.py): name -> (density channels, trunk width, view-branch
# width, min_deg, max_deg, deg_view, identity). A: the narrow model; B:
# IPE degrees 0..10 (30-column sin block: the fold of kernel 4 takes each
# feature alone) and deg_view 2; C: mip-NeRF's one channel, narrow,
# without identity (kernels 2 and 3 only: kernels 4 and 5 encode with
# identity); D: 7 degrees from 2 (42 features padded to 48), deg_view 1.
SHAPES = {"A": (5, 128, 64, 0, 16, 4, True),
          "B": (5, 256, 128, 0, 10, 2, True),
          "C": (1, 128, 64, 0, 16, 4, False),
          "D": (5, 128, 128, 2, 9, 1, True)}
# Narrower widths, zero-padded into a build (kernels/shapes.py
# `build_shape`): P1 in A's 128 / 64 build, P2 in the shipped one, P2m
# mip-NeRF's one channel in the one-channel build.
PADDED = {"P1": (5, 64, 32, 0, 16, 4, True),
          "P2": (5, 200, 100, 0, 16, 4, True),
          "P2m": (1, 200, 100, 0, 16, 4, True)}
# The 512 / 256 builds (chip_smoke.py's D, Dm and P3): the trunk's
# products split at 512 columns, two ring stages per K step; P3 (384 /
# 192) runs zero-padded in W512's build.
WIDE = {"W512": (5, 512, 256, 0, 16, 4, True),
        "W512m": (1, 512, 256, 0, 16, 4, True),
        "P3": (5, 384, 192, 0, 16, 4, True)}


def _shape_mlp(name, device, seed=1):
    """A random MLP of shape `name` and its encodings' keywords."""
    C, W, VW, lo, hi, dv, ident = {**SHAPES, **PADDED, **WIDE}[name]
    mlp = NerfMLP(6 * (hi - lo), 6 * dv + 3 * ident, net_width=W,
                  net_width_condition=VW, num_density_channels=C,
                  generator=torch.Generator().manual_seed(seed))
    return mlp.to(device), dict(min_deg=lo, max_deg=hi, deg_view=dv)


@pytest.mark.cuda
@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES) + sorted(PADDED)
                         + sorted(WIDE))
def test_fused_mlp_kernels_match_plain_versions_at_other_shapes(
        cuda_device, shape, normals):
    """Kernels 2 and 3 built for each other shape, forward and backward,
    at kernel 2 and 3's tolerances (and the padded feature columns add
    nothing: the moment gradient matches)."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3
    kernel, plain = ((k3.fused_mlp_normals_apply,
                      k3.fused_mlp_normals_reference) if normals else
                     (k2.fused_mlp_ipe_apply, k2.fused_mlp_ipe_reference))
    mlp, kw = _shape_mlp(shape, cuda_device)
    g = torch.Generator().manual_seed(0)
    M = 1000
    means = (torch.randn(M, 3, generator=g) * 2).to(cuda_device)
    covs = (torch.randn(M, 3, generator=g).abs() * 0.01).to(cuda_device)
    v = (torch.randn(M, mlp.view_dim, generator=g) * 0.5).to(cuda_device)
    deg = dict(min_deg=kw["min_deg"], max_deg=kw["max_deg"])
    got, g_got, m_got = _grads(kernel, mlp, means, covs, v, **deg)
    torch.cuda.synchronize()
    want, g_want, m_want = _grads(plain, mlp, means, covs, v, **deg)
    for a, b in zip(got[:2], want[:2]):
        assert float((a - b).abs().max()) <= 2e-2
    if normals:
        assert _rel(got[2], want[2]) < 0.08
    assert _rel(g_got, g_want) < (5e-2 if normals else 2e-2)
    assert _rel(m_got, m_want) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,need_normals", [(37, 56, True),
                                              (131, 5, False)])
@pytest.mark.parametrize("shape", ["A", "B", "D", "P1", "P2", "W512", "P3"])
def test_fused_render_kernel_matches_plain_version_at_other_shapes(
        cuda_device, shape, R, S, need_normals):
    mlp, kw = _shape_mlp(shape, cuda_device)
    args = _inputs(R, S, cuda_device)
    kw = dict(KW, **kw, need_normals=need_normals, need_extras=need_normals)
    with torch.no_grad():
        got = fr.fused_render_level(mlp, *args, **kw)
        want = fr.fused_render_level_reference(mlp, *args, **kw)
    for k, tol in (("rgb", 2e-2), ("distance", 2e-2), ("acc", 1e-2),
                   ("weights", 1e-2), ("albedo", 2e-2), ("roughness", 2e-2)):
        if want[k] is not None:
            torch.testing.assert_close(got[k], want[k], atol=tol, rtol=0)
    if need_normals:
        cos = torch.sum(got["normal"] * want["normal"], -1)
        assert float(cos.median()) > 0.998 and float(cos.min()) > 0.85


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(37, 56), (131, 5)])
@pytest.mark.parametrize("shape", ["A", "B", "D", "P1", "P2", "W512", "P3"])
def test_fused_render_train_kernels_match_plain_version_at_other_shapes(
        cuda_device, shape, R, S):
    from pano_nerf_tpu_torch.kernels import fused_render_train as k5
    mlp, kw = _shape_mlp(shape, cuda_device)
    args = _inputs(R, S, cuda_device)
    want, gp_want, gm_want, gt_want = _render_grads(
        k5.fused_render_train_reference, mlp, args, False, **kw)
    for save_acts in (False, True):
        got, gp, gm, gt = _render_grads(k5.fused_render_train, mlp, args,
                                        False, save_acts=save_acts, **kw)
        torch.cuda.synchronize()
        for k, tol in (("rgb", 2e-2), ("distance", 2e-2), ("acc", 1e-2),
                       ("weights", 2e-3)):
            torch.testing.assert_close(got[k], want[k], atol=tol, rtol=0)
        assert _rel(gp, gp_want) < 2e-2
        assert _rel(gm, gm_want) < 5e-2 and _rel(gt, gt_want) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["A", "D", "P1", "P2", "W512", "P3"])
def test_fused_mlp_apply_kernels_match_plain_version_at_other_shapes(
        cuda_device, shape):
    from pano_nerf_tpu_torch.kernels import fused_mlp as k1
    mlp, _ = _shape_mlp(shape, cuda_device)
    g = torch.Generator().manual_seed(0)
    M = 1000
    x = (torch.randn(M, mlp.xyz_dim, generator=g) * 0.5).to(cuda_device)
    v = (torch.randn(M, mlp.view_dim, generator=g) * 0.5).to(cuda_device)
    res = []
    for fn in (k1.fused_mlp_apply, k1.fused_mlp_apply_reference):
        mlp.zero_grad()
        xr = x.clone().requires_grad_(True)
        outs = fn(mlp, xr, v)
        (torch.sin(outs[0]).sum() + torch.cos(outs[1]).sum()).backward()
        res.append(([o.detach() for o in outs], torch.cat(
            [p.grad.reshape(-1) for p in mlp.parameters()]), xr.grad))
    torch.cuda.synchronize()
    (got, gp, gx), (want, gp_want, gx_want) = res
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 2e-2
    assert _rel(gp, gp_want) < 2e-2
    assert _rel(gx, gx_want) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES) + ["W512", "W512m"])
def test_weight_grad_kernel_matches_plain_version_at_other_shapes(
        cuda_device, shape, normals):
    """The weight-gradient pass of each other shape's build, over that
    shape's job table (128- and 64-wide products, 16-wide viewdir codes;
    at 512 wide 24 jobs, the fan-ins split at 256) on random operand rows,
    per job at rel-norm 1e-4."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    mlp, _ = _shape_mlp(shape, cuda_device)
    sh = k2.shape_of(mlp)
    lay = k2.layout(sh)
    width = lay.OPW_NRM if normals else lay.OPW_IPE
    g = torch.Generator(device=cuda_device).manual_seed(int(normals))
    ops = torch.randn(1088, width, generator=g, device=cuda_device,
                      dtype=torch.float32).to(torch.bfloat16)
    dw = torch.zeros(lay.W_TOTAL, device=cuda_device)
    k2.launch_weight_grads(k2.kernel_library(sh), ops, dw, normals)
    want = k2.weight_grads_reference(ops, normals, sh)
    torch.cuda.synchronize()
    for i, (_, _, _, _, n, k, out, ldo) in enumerate(
            k2.wgrad_jobs(normals, sh)):
        a = dw.as_strided((n, k), (ldo, 1), out)
        b = want.as_strided((n, k), (ldo, 1), out)
        assert _rel(a, b) <= 1e-4, i



@pytest.mark.cuda
@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("shape", sorted(PADDED) + ["P3"])
def test_padded_gradient_slots_are_zero(cuda_device, shape, normals):
    """A backward of kernel 2 (3) on a model padded into a wider build:
    the packed weight and bias gradients in the padded slots are exactly
    0, and the rest unpack to the model's own shapes."""
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    mlp, kw = _shape_mlp(shape, cuda_device)
    weights, biases = fr.pack_params(mlp)
    lib = k2.kernel_library(k2.build_of(mlp))
    g = torch.Generator().manual_seed(2)
    M = 1000
    means = (torch.randn(M, 3, generator=g) * 2).to(cuda_device)
    covs = (torch.randn(M, 3, generator=g).abs() * 0.01).to(cuda_device)
    v = (torch.randn(M, mlp.view_dim, generator=g) * 0.5).to(cuda_device)
    mc, vr = k2.rows_of(means, covs, v, (M,))
    _, _, acts = k2.launch_forward(lib, mc, vr, weights, biases,
                                   kw["min_deg"], normals, save_acts=normals)
    ops, dw, db = k2.backward_buffers(lib, weights, biases,
                                      k2.tile_rows(lib, M), normals)
    dmc = torch.empty((M, 8), device=cuda_device)
    gout = torch.randn(M, k2.OUT_W, device=cuda_device)
    q = torch.randn(M, 3, device=cuda_device) if normals else None
    k2.launch_backward_rows(lib, mc, vr, weights, biases, gout, q, acts, ops,
                            dmc, dw, db, kw["min_deg"], normals)
    k2.launch_weight_grads(lib, ops, dw, normals)
    torch.cuda.synchronize()
    w_pad, b_pad = fr.padded_slots(mlp)
    assert torch.count_nonzero(dw[w_pad]) == 0
    assert torch.count_nonzero(db[b_pad]) == 0
    assert torch.count_nonzero(dw[~w_pad]) > 0
    grads = fr.unpack_params(mlp, dw, db)
    for n, p in mlp.named_parameters():
        assert grads[n].shape == p.shape, n
