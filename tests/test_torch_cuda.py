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
    (37, 56, False), (37, 56, True), (131, 5, False), (3, 64, True)])
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
