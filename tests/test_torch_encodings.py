"""Each encoding key the port's plain route lifts, and no view
directions, against the JAX package's XLA route, on the CPU.

For each key (no view directions, the IPE degrees, the viewdir
encoding's degree and identity), one f32 Pano-NeRF render (atol 1e-4,
`tests/test_torch_plain_route.py` `check_render`) and one f32 train step
(loss parts rel 1e-5, gradients rel-norm 1e-4 per leaf, with
`check_step_f64`'s float64 arbiter) on the small model of
tests/test_torch_train_step.py, as tests/test_torch_topology.py holds
the topology keys.
"""

import pytest

from test_torch_plain_route import check_render, check_step_f64
import torch_threads  # noqa: F401  (tests/torch_threads.py)

KEYS = {
    "use_viewdirs": ["nerf.use_viewdirs", "False"],
    "min_deg_point": ["nerf.min_deg_point", "2"],
    "max_deg_point": ["nerf.max_deg_point", "12"],
    "deg_view": ["nerf.deg_view", "2"],
    "append_identity": ["nerf.append_identity", "False"],
}


@pytest.mark.parametrize("key", list(KEYS))
def test_render_and_step_match_jax(key):
    check_render(KEYS[key])
    check_step_f64(KEYS[key])
