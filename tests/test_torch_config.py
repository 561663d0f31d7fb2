"""The port's YAML-subset config loader against pano_nerf_tpu.core.config.

The port parses YAML without PyYAML; every shipped config must flatten to
exactly the dict the JAX package's PyYAML-based loader produces.
"""

import glob
import os

import pytest
import yaml

from pano_nerf_tpu.core import config as jax_config
from pano_nerf_tpu_torch.core import config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def test_six_configs_are_shipped():
    assert len(CONFIGS) == 6


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_shipped_config_loads_identically(path):
    got = port_config.load(path)
    want = jax_config.load(path)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {
        k: type(v) for k, v in want.items()}


SNIPPETS = {
    "scalars": "a: 1\nb: 2.5\nc: 1e-3\nd: 0.\ne: -3\nf: .5\n",
    "bools_nulls": "a: True\nb: false\nc: yes\nd: Off\ne: ~\nf: null\n"
                   "g:\n",
    "quoted": "a: 'n45_46_72'\nb: \"x # y\"\nc: 'None'\nd: 'it''s'\n",
    "comments": "# head\na: 1   # trailing\n\n  # indented comment\nb: x#y\n",
    "nested": "n:\n    m:\n        k: 3\n    j: 'q'\nz: 0\n",
    "flow_list": "r: [0, 10]\ns: ['a', 2.0, True]\nt: []\n",
    "typo_string": "append_identity: Ture\nname: panonerf\n",
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_yaml_subset_matches_pyyaml(name):
    text = SNIPPETS[name]
    assert (port_config.flatten(port_config.parse_yaml(text))
            == jax_config.flatten(yaml.safe_load(text)))


def test_empty_document_is_empty_config():
    assert port_config.flatten(port_config.parse_yaml("# only\n\n")) == {}


def test_cli_overrides_and_base_chain(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text("nerf:\n  num_samples: 56\n  name: 'a'\n")
    child = tmp_path / "child.yaml"
    child.write_text("_base_: base.yaml\nnerf:\n  num_samples: 8\n")
    cfg = port_config.load_config(str(child), ["nerf.name", "'b'",
                                               "val.chunk_size", "1024"])
    assert cfg == {"nerf.num_samples": 8, "nerf.name": "b",
                   "val.chunk_size": 1024}


def test_bad_indentation_raises():
    with pytest.raises(ValueError):
        port_config.parse_yaml("a: 1\n   b: 2\n")
