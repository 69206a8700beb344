"""The port's scene configs (activesplat_tpu_torch/configs) against the JAX
package's: its YAML reader against yaml.safe_load (equal dicts on every
bundled env file and on yaml.safe_dump of the tests' env dict, refusal of
what lies outside the subset), the loaders equal to the JAX package's, and
mapper_config_from_scene field by field."""

import dataclasses
import glob
import os

import pytest
import yaml

from activesplat_tpu import configs as jconfigs
from activesplat_tpu_torch import configs as tconfigs
from activesplat_tpu_torch.configs.yaml_subset import YamlSubsetError, loads
from tests.test_torch_habitat import env_dict

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

SCENE_CONFIGS = ("synthetic", "synthetic_small", "gibson", "gibson_high_resolution",
                 "gibson_large", "mp3d", "mp3d_large")
SCENE_LISTS = ("gibson_small", "gibson_big", "mp3d_small", "mp3d_big")


def test_yaml_reader_on_safe_dump():
    """The tests' small env dict (tests/test_habitat_episode.py's) as
    yaml.safe_dump writes it: block sequences without indentation."""
    text = yaml.safe_dump(env_dict(48, 48, 30.0))
    assert "- 1.25" in text  # the indentless block sequence
    assert loads(text) == yaml.safe_load(text) == env_dict(48, 48, 30.0)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(tconfigs.CONFIG_DIR, "env",
                                                               "*.yaml"))),
                         ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path):
    text = open(path).read()
    want = yaml.safe_load(text)
    got = loads(text)
    assert got == want
    sim = got["habitat"]["simulator"]
    assert isinstance(sim["action_space_config"], str) and sim["action_space_config"] == "v1"
    assert isinstance(sim["forward_step_size"], float) and sim["forward_step_size"] == 0.065
    assert sim["habitat_sim_v0"]["allow_sliding"] is False
    assert got["habitat"]["dataset"]["scenes_dir"] == ""
    # the port's copy is the JAX package's file, byte for byte
    assert text == open(os.path.join(jconfigs.CONFIG_DIR, "env", os.path.basename(path))).read()


@pytest.mark.parametrize("text,why", [
    ("a: &x 1\nb: *x\n", "anchor"),
    ("a: *x\n", "alias"),
    ("a: !!str 1\n", "tag"),
    ("a: |\n  one\n  two\n", "block scalar"),
    ("a: >\n  one\n", "folded scalar"),
    ("a: one\n  two\n", "multi-line plain scalar"),
    ("a: \"one\n  two\"\n", "multi-line quoted scalar"),
    ("a:\n\tb: 1\n", "tab indent"),
    ("a: 1\tb\n", "tab inside"),
    ("a: {b: 1}\n", "flow mapping"),
    ("a: [[1], 2]\n", "nested flow"),
    ("a: 1e5\n", "exponent without a point"),
    ("a: yes\n", "YAML 1.1 boolean"),
    ("a:\n", "null"),
    ("a: ~\n", "null"),
    ("a: 1\na: 2\n", "duplicate key"),
    ("---\na: 1\n", "document marker"),
    ("a: 0x1f\n", "hex int"),
    ("a: 2024-01-01\n", "date"),
])
def test_yaml_reader_refuses(text, why):
    with pytest.raises(YamlSubsetError):
        loads(text)


@pytest.mark.parametrize("name", SCENE_CONFIGS)
def test_scene_configs_equal(name):
    got = tconfigs.load_scene_config(name)
    assert got == jconfigs.load_scene_config(name)
    assert tconfigs.dataset_kwargs_from_scene(got) == jconfigs.dataset_kwargs_from_scene(got)
    t, j = tconfigs.mapper_config_from_scene(got), jconfigs.mapper_config_from_scene(got)
    for field in dataclasses.fields(j):
        want = getattr(j, field.name)
        have = getattr(t, field.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(have) == dataclasses.asdict(want), field.name
        else:
            assert have == want, field.name
    assert {f.name for f in dataclasses.fields(t)} == {f.name for f in dataclasses.fields(j)}


def test_scene_config_by_path_lists_and_user_config(tmp_path):
    path = os.path.join(tconfigs.CONFIG_DIR, "datasets", "gibson.json")
    assert tconfigs.load_scene_config(path) == jconfigs.load_scene_config(path)
    for name in SCENE_LISTS:
        assert tconfigs.load_scene_list(name) == jconfigs.load_scene_list(name)
    assert sum(len(tconfigs.load_scene_list(n)) for n in SCENE_LISTS) == 13
    assert tconfigs.load_user_config() == jconfigs.load_user_config()
    user = tmp_path / "user.json"
    user.write_text('{"datasets": {"gibson": {"root": "/g"}}}')
    assert tconfigs.load_user_config(str(user)) == jconfigs.load_user_config(str(user))


def test_mapper_config_overrides_and_mesh_refused():
    """Overrides beat the config; a config's use_mesh is taken, equal to the
    JAX package's MapperConfig field by field."""
    cfg = tconfigs.load_scene_config("gibson_high_resolution")
    assert tconfigs.mapper_config_from_scene(cfg).mapping_iters == 10
    assert tconfigs.mapper_config_from_scene(cfg, mapping_iters=3).mapping_iters == 3
    meshed = dict(cfg, mapper=dict(cfg["mapper"], use_mesh=True))
    for scene in ({"mapper": {"use_mesh": True}}, meshed):
        got = tconfigs.mapper_config_from_scene(scene)
        want = jconfigs.mapper_config_from_scene(scene)
        assert got.use_mesh is want.use_mesh is True
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
