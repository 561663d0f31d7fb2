"""The last loss terms of the port against the JAX package, on the CPU.

`loss.vc_sat_mask` (the per-channel view-consistency tie on unsaturated
channels), `loss.vc_chroma` with `loss.vc_chroma_sg` (the log-chroma
cross-view tie, one-way with the switch), `loss.scale_distill` and
`loss.scale_distill_dist` (the primary ray re-marched at the secondary
rays' sampling, tied to the fine level) and `loss.emission_sparsity`:

- each term of `pano_losses` against JAX's on the same LevelOutputs:
  loss parts and the loss's gradients with respect to the outputs, which
  show each stop-gradient;
- one f32 train step with all of them against JAX's (loss parts rel 1e-5,
  gradients rel-norm 1e-4 per leaf), the re-march's uniforms replayed
  from JAX's key (`fold_in(key, 0x5D)`), on the plain route (f32), and
  one bf16 step at the two-way rule on the kernel route (the kernels'
  plain versions), where the re-march is one more call of kernel 2;
- a default run draws the TrainDraws it drew before, bit for bit, and the
  re-march's uniforms come last.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pano_nerf_tpu.engine import losses as jax_losses
from pano_nerf_tpu.models.base import LevelOutput as JaxLevelOutput
from pano_nerf_tpu_torch.core.config import load_config
from pano_nerf_tpu_torch.engine import losses
from pano_nerf_tpu_torch.models import build_model
from pano_nerf_tpu_torch.models.base import LevelOutput

from test_torch_plain_route import check_bf16, check_step_f64, step_both
from test_torch_train_step import D, N, OPTS, S
import torch_threads  # noqa: F401  (tests/torch_threads.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "panonerf.yaml")
TERMS = {
    "vc_sat_mask": {"loss.vc_sat_mask": True},
    "vc_chroma": {"loss.vc_chroma": 0.1},
    "vc_chroma_sg": {"loss.vc_chroma": 0.1, "loss.vc_chroma_sg": True},
    "scale_distill": {"loss.scale_distill": 0.1},
    "scale_distill_dist": {"loss.scale_distill_dist": 0.1},
    "both_scale_distill": {"loss.scale_distill": 0.1,
                           "loss.scale_distill_dist": 0.2},
    "emission_sparsity": {"loss.emission_sparsity": 0.05},
}
ALL = ["loss.scale_distill", "0.1", "loss.scale_distill_dist", "0.1",
       "loss.vc_chroma", "0.1", "loss.vc_chroma_sg", "True",
       "loss.vc_sat_mask", "True"]
NAMES = ("vcc", "scale_distill", "scale_distill_dist")
FIELDS = ("rgb", "rgb_alt", "rgb_scale", "dist_scale", "distance",
          "emission")


def _outputs(seed=2, n=24):
    rng = np.random.default_rng(seed)
    f = {k: rng.uniform(0.0, 9.0, (n, 3)).astype(np.float32)
         for k in ("rgb", "rgb_alt", "rgb_scale", "emission")}
    f["rgb_alt"][:3] = -0.5   # below zero: the relu of the ties
    f.update(dist_scale=rng.uniform(0.5, 6, n).astype(np.float32),
             distance=rng.uniform(0.5, 6, n).astype(np.float32))
    gt = rng.uniform(0.0, 12.0, (n, 3)).astype(np.float32)
    mask = (rng.uniform(size=(n, 1)) > 0.2).astype(np.float32)
    coarse = rng.uniform(0.0, 3.0, (n, 3)).astype(np.float32)
    return f, gt, mask, coarse


@pytest.mark.parametrize("term", list(TERMS))
def test_term_matches_jax(term):
    hp = losses.prepare_hparams(dict(load_config(CONFIG), **{
        "loss.view_consistency": 0.1, "loss.emission_sparsity": 0.0,
        **TERMS[term]}))
    f, gt, mask, coarse = _outputs()

    def jax_loss(fields):
        outs = [JaxLevelOutput(rgb=jnp.asarray(coarse), distance=None,
                               acc=None),
                JaxLevelOutput(acc=None, **fields)]
        parts = jax_losses.pano_losses(outs, jnp.asarray(gt),
                                       jnp.asarray(mask), hp, False)
        return parts["loss"], parts

    (_, j_parts), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in f.items()})
    t = {k: torch.tensor(v, requires_grad=True) for k, v in f.items()}
    outs = [LevelOutput(rgb=torch.tensor(coarse), distance=None, acc=None),
            LevelOutput(acc=None, **t)]
    parts = losses.pano_losses(outs, torch.tensor(gt), torch.tensor(mask),
                               hp, False)
    parts["loss"].backward()
    got = {k: float(v.detach()) for k, v in parts.items() if v is not None}
    want = {k: float(v) for k, v in j_parts.items() if v is not None}
    assert got.keys() == want.keys()
    key = {"vc_sat_mask": "vc", "vc_chroma_sg": "vcc", "vc_chroma": "vcc",
           "both_scale_distill": "scale_distill_dist",
           "emission_sparsity": "emission"}.get(term, term)
    assert key in got and got[key] > 0
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    for k in FIELDS:
        g = t[k].grad
        np.testing.assert_allclose(
            np.zeros_like(f[k]) if g is None else g.numpy(),
            np.asarray(j_grads[k]), rtol=1e-5, atol=1e-8, err_msg=k)


def test_vc_sat_mask_adds_to_the_luma_tie_only_with_it():
    f, gt, mask, coarse = _outputs(3)
    vals = []
    for on in (False, True):
        hp = losses.prepare_hparams(dict(load_config(CONFIG), **{
            "loss.vc_sat_mask": on}))
        outs = [LevelOutput(rgb=torch.tensor(coarse), distance=None,
                            acc=None),
                LevelOutput(acc=None, **{k: torch.tensor(v)
                                         for k, v in f.items()})]
        vals.append(float(losses.pano_losses(
            outs, torch.tensor(gt), torch.tensor(mask), hp, False)["vc"]))
    assert vals[1] > vals[0] > 0


def test_train_step_matches_jax_in_f32():
    """All the switches on, f32 on the plain route, against JAX."""
    check_step_f64(ALL, names=NAMES, scale_distill=True)


def test_train_step_on_the_kernel_route_at_the_two_way_rule():
    """All the switches on, bf16 on the kernel route (the kernels' plain
    versions), against JAX's bf16 and f32 steps."""
    check_bf16(ALL, scale_distill=True, names=NAMES)


def test_scale_distill_is_one_more_kernel2_call(monkeypatch):
    from pano_nerf_tpu_torch.kernels import fused_mlp_ipe as k2
    calls = []
    plain = k2.fused_mlp_ipe_reference

    def counted(mlp, means, *a, **k):
        calls.append(tuple(means.shape))
        return plain(mlp, means, *a, **k)

    monkeypatch.setattr(k2, "fused_mlp_ipe_reference", counted)
    step_both(["loss.scale_distill", "0.1"], "bf16", scale_distill=True)
    assert len(calls) == 4 and calls.count((16, S, 3)) == 1


def _draws(opts, seed=0):
    model = build_model(load_config(CONFIG, OPTS + opts))
    gen = torch.Generator().manual_seed(seed)
    sd = losses.use_scale_distill(load_config(CONFIG, opts))
    return model.make_draws(16, D, gen, scale_distill=sd)


def test_default_draws_are_unchanged():
    """The four draws of every step, in their order, bit for bit; the
    re-march's uniforms only with a scale-distill weight on, after
    them."""
    g = torch.Generator().manual_seed(0)
    want = (torch.rand((16, N + 1), generator=g),
            torch.rand((16, N + 1), generator=g),
            torch.rand((16, D, S + 1), generator=g),
            torch.randn((16, 3), generator=g))
    t_sd = torch.rand((16, S + 1), generator=g)
    default = _draws([])
    assert all(torch.equal(a, b) for a, b in zip(default[:4], want))
    assert all(x is None for x in default[4:])
    for opts in (["loss.scale_distill", "0.1"],
                 ["loss.scale_distill_dist", "0.1"]):
        on = _draws(opts)
        assert all(torch.equal(a, b) for a, b in zip(on[:4], want))
        assert torch.equal(on.t_sd, t_sd)
        assert all(x is None for x in on[4:-1])
