"""The HDR presets' gradients against the JAX package at
`nerf.env_tight_rgb 1`, on the CPU.

At the presets' tight scale (0.01) the f32 rounding of the surface point
moves either framework's trunk gradients by up to ~1e-2, so
tests/test_torch_presets.py holds them to 1e-4 per leaf or twice JAX's
own change under 1e-6 shifts of the rays. At scale 1 that rounding is
damped: here every variant of the tight re-read (with the shadow
preset's distill pair on) and the shadow preset's train step inside its
fall window (chromaticity prior, illuminant compensation, the distill
tie) are held at rel-norm 1e-4 per leaf with no allowance, so that a
gradient-wiring fault (a missing or extra detach, the chroma combine)
cannot hide in it.
"""

import pytest

from test_torch_presets import MID_FALL, SHADOW, VARIANTS, check_step, \
    check_variant


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tight_read_variant_grads_match_jax_at_tight1(variant):
    check_variant(variant, "tight1")


def test_shadow_train_step_matches_jax_at_tight1():
    check_step(SHADOW, MID_FALL, "tight1")
