"""Kernel 3's plain version against the JAX Pallas kernel, on the CPU.

As tests/test_torch_fused_mlp_ipe.py, for `fused_mlp_normals_apply`: the
port's plain version (the explicit chain of models/normals.py, torch
autograd) against the Pallas forward and hand-written adjoint in
interpret mode, at 5 and 1 density channels. Tolerances: forward atol
5e-3, d raw_sigma / d means rel-norm 0.08, parameter gradients rel-norm
5e-2, moment gradients rel-norm 5e-2.
"""

import numpy as np
import pytest

from pano_nerf_tpu.kernels.fused_mlp_normals import (
    fused_mlp_normals_apply as jax_k3)
from pano_nerf_tpu_torch.kernels import fused_mlp_normals as k3

from test_torch_fused_mlp_ipe import CASES, jax_run, port_run, rel, setup
import torch_threads  # noqa: F401  (tests/torch_threads.py)


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("PANO_NERF_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("C, M", CASES)
def test_plain_version_matches_pallas_kernel(interpret, C, M):
    params, mlp, means, covs, v = setup(M, C=C)
    j_out, j_gp, j_gm = jax_run(jax_k3, params, means, covs, v, C)
    p_out, p_gp, p_gm = port_run(k3.fused_mlp_normals_apply, mlp, means,
                                 covs, v)
    assert p_out[1].shape == j_out[1].shape == (M, C)
    for a, b in zip(p_out[:2], j_out[:2]):
        np.testing.assert_allclose(a, b, atol=5e-3, rtol=0)
    assert rel(p_out[2], j_out[2]) < 0.08
    assert rel(p_gp, j_gp) < 5e-2
    assert rel(p_gm, j_gm) < 5e-2
