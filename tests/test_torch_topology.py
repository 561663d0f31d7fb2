"""Each MLP topology key the port's plain route lifts, against the JAX
package's XLA route, on the CPU (the encoding keys and no view
directions: tests/test_torch_encodings.py).

For each key (the trunk's depth, width and skip index, the view branch's
depth and width), one f32 Pano-NeRF render (atol 1e-4,
`tests/test_torch_plain_route.py` `check_render`) and one f32 train step
(loss parts rel 1e-5, gradients rel-norm 1e-4 per leaf, with
`check_step_f64`'s float64 arbiter) on the small
model of tests/test_torch_train_step.py; and the mip-NeRF topology of
`chip_smoke.py` phase 16 (4 trunk layers, no view directions), render and
step.
"""

import pytest

from test_torch_plain_route import (check_render, check_step_f64,
                                    mip_render_both, mip_step_both)
import torch_threads  # noqa: F401  (tests/torch_threads.py)

KEYS = {
    "net_depth": ["nerf.mlp.net_depth", "6"],
    "net_width": ["nerf.mlp.net_width", "48"],
    "skip_index": ["nerf.mlp.skip_index", "3"],
    "net_depth_condition": ["nerf.mlp.net_depth_condition", "2"],
    "net_width_condition": ["nerf.mlp.net_width_condition", "24"],
}


@pytest.mark.parametrize("key", list(KEYS))
def test_render_and_step_match_jax(key):
    check_render(KEYS[key])
    check_step_f64(KEYS[key])


def test_mip_topology_of_the_chip_check_matches_jax():
    extra = ["nerf.mlp.net_depth", "4", "nerf.use_viewdirs", "False"]
    mip_render_both(extra)
    mip_step_both(extra)
