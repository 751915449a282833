"""PyTorch port: the configuration tree (aux/yaml_reader.py, aux/config.py
and the CLI's composition) against PyYAML and the JAX package's CLI.

The port's YAML reader must give ``yaml.safe_load``'s value for every file
under ``cfg/`` and for the override values a command line carries; the
composed and instantiated tree of the port's CLI must equal the JAX CLI's
(caught at its mode function) for every mode, every environment group and
both rendering files, with config classes compared field by field (a field
the port dropped, such as MPPIConfig's TPU-only ones, must sit at its
default on the JAX side)."""

import dataclasses
import math
from pathlib import Path

import pytest
import yaml

from husky_rover_mppi_isaacsim_torch import cli
from husky_rover_mppi_isaacsim_torch.aux import config as tconfig
from husky_rover_mppi_isaacsim_torch.aux import yaml_reader
from husky_rover_mppi_isaacsim_torch.mppi.controller import MPPIConfig
from husky_rover_mppi_isaacsim_tpu import cli as jcli
from husky_rover_mppi_isaacsim_tpu.aux import config as jconfig

REPO = Path(__file__).resolve().parents[1]
CFG_FILES = sorted(p.relative_to(REPO).as_posix() for p in (REPO / "cfg").rglob("*.yaml"))
MODES = ("standalone", "closed_loop", "largescale", "evaluation", "sdg")
ENVIRONMENTS = sorted(p.stem for p in (REPO / "cfg" / "environment").glob("*.yaml"))
RENDERINGS = sorted(p.stem for p in (REPO / "cfg" / "rendering").glob("*.yaml"))


def test_the_tree_has_the_files_the_cli_reads():
    assert len(CFG_FILES) == 22 and len(ENVIRONMENTS) == 13 and len(RENDERINGS) == 2


@pytest.mark.parametrize("path", CFG_FILES)
def test_reader_equals_safe_load(path):
    text = (REPO / path).read_text()
    assert yaml_reader.loads(text) == yaml.safe_load(text)


SCALARS = ["", "1", "-1", "+3", "0", "017", "08", "0x1F", "0b101", "1_000", "1:30", "1.5",
           "1e-3", "1.0e-3", "-.inf", ".nan", "1.", "true", "True", "yes", "off", "null", "~",
           "abc", "a b", "[1, 2, [3, 4]]", "{a: 1, b: [x, y]}", "[]", "{}", "'q: #x'",
           '"a\\nb"', "[a, b,]", "/tmp/x", "a: 1", "2024-01-01", "0.016666666666666666",
           "- a\n- b", "a:\n- 1\n- 2\nb: 3", "x: {a: 1,\n  b: 2}\ny: [1,\n 2]",
           "- k: 1\n  j: 2\n- k: 3", "a: 'it''s'", "a: b # c", "a: b#c", "[1, {a: 2}]",
           "a:\n  b:\n    c: 1\n  d: 2\ne: 3", "key with space: v", "a: ~", "a:", "{width: 64}"]


@pytest.mark.parametrize("text", SCALARS)
def test_reader_values_equal_safe_load(text):
    got, want = yaml_reader.loads(text), yaml.safe_load(text)
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("text", ["&a 1", "*a", "!!str 1", "a: |\n  b", "2024-01-01 10:00:00",
                                  "---\na: 1\n---\nb: 2", "[1, 2", "a:\n\tb: 1"])
def test_reader_refuses_what_it_does_not_know(text):
    with pytest.raises(yaml_reader.YamlSubsetError):
        yaml_reader.loads(text)


def _same(got, want, path="tree"):
    """Equal trees: config classes by the port's fields (a JAX-only field at
    its default), dicts by key, lists and tuples by item, scalars by value
    and type."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        names = {f.name for f in dataclasses.fields(got)}
        for f in dataclasses.fields(want):
            if f.name in names:
                _same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
            else:  # a field the port dropped (TPU-only, or the native tile pool's)
                assert getattr(want, f.name) == getattr(type(want)(), f.name), path
    elif hasattr(want, "_fields"):
        assert type(got).__name__ == type(want).__name__ and got._fields == want._fields, path
        for name in want._fields:
            _same(getattr(got, name), getattr(want, name), f"{path}.{name}")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _jax_tree(monkeypatch, argv):
    """The tree the JAX CLI hands its mode function."""
    caught = {}

    def catch(tree):
        caught["tree"] = tree
        return {}

    for mode in jcli.MODES:
        monkeypatch.setitem(jcli.MODES, mode, catch)
    assert jcli.main(argv) == 0
    return caught["tree"]


OVERRIDES = ["seed=3", "mppi.horizon=50", "sdg.camera={width: 64}", "world.half_width=12.5",
             "evaluation.ks=[16, 32]", "physics.rover.mass=50.0"]


@pytest.mark.parametrize("environment", ENVIRONMENTS)
@pytest.mark.parametrize("mode", MODES)
def test_composed_tree_equals_jax(monkeypatch, capsys, mode, environment):
    for rendering in RENDERINGS:
        argv = [f"mode={mode}", f"environment={environment}", f"rendering={rendering}",
                "physics=default_physics", *OVERRIDES]
        got = cli.compose(argv)
        _same(got, _jax_tree(monkeypatch, argv))
        assert isinstance(got["mppi"], MPPIConfig) and got["mppi"].horizon == 50
        assert got["mode"] == mode
    capsys.readouterr()


@pytest.mark.parametrize("argv", [
    ["--config=cfg/config.yaml", "mode=standalone", "goal.x=1.5"],
    ["--config=cfg/environment/lunaryard_20m4SDG.yaml", "sdg.num_images=2"],
    ["--config=cfg/environment/largescale_alt_rocks.yaml", "mode=largescale", "seed=9"],
], ids=["config", "sdg_env_file", "largescale_env_file"])
def test_config_argument_equals_jax(monkeypatch, capsys, argv):
    """``--config=`` names the top file; groups and modes resolve beside
    it (where they exist)."""
    monkeypatch.chdir(REPO)
    _same(cli.compose(argv), _jax_tree(monkeypatch, argv))
    capsys.readouterr()


def test_default_tree_is_the_jax_default(monkeypatch, capsys):
    """No argument: cfg/config.yaml with its groups, mode standalone."""
    got = cli.compose([])
    _same(got, _jax_tree(monkeypatch, []))
    assert got["mode"] == "standalone" and "largescale" in got["environment"]
    capsys.readouterr()


def test_tpu_only_fields_are_refused_by_name():
    for field in sorted(MPPIConfig.TPU_ONLY_FIELDS):
        with pytest.raises(ValueError, match=field + ".*TPU-only"):
            cli.compose([f"mppi.{field}=1"])
    with pytest.raises(ValueError, match="unknown keys"):
        cli.compose(["mppi.no_such_field=1"])
    # no file under cfg/ sets one: every mppi section holds port fields only
    port_fields = {f.name for f in dataclasses.fields(MPPIConfig)}

    def mppi_sections(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "mppi" and isinstance(v, dict):
                    yield v
                yield from mppi_sections(v)
    sections = [s for p in CFG_FILES
                for s in mppi_sections(yaml.safe_load((REPO / p).read_text()))]
    assert sections and all(set(s) <= port_fields for s in sections)


def test_factory_registers_the_jax_names_with_the_port_classes():
    tf, jf = tconfig.default_factory(), jconfig.default_factory()
    assert set(tf._registry) == set(jf._registry) and len(tf._registry) == 11
    for name, cls in tf._registry.items():
        assert cls.__module__.startswith("husky_rover_mppi_isaacsim_torch.")
        assert cls.__name__ == jf._registry[name].__name__
    # the port's streamer has no native tile pool: its default is "never"
    tree = {"rover": {"mass": 40.0}, "terrain_streamer": {"native_pool": "never"},
            "stellar_engine": None, "other": {"a": 1}}
    _same(tconfig.instantiate_configs(dict(tree)), jconfig.instantiate_configs(dict(tree)))


def test_load_config_and_overrides_equal_jax(tmp_path):
    """``defaults:`` of both kinds (a group entry, a sibling file) and
    dotted overrides of new and existing keys."""
    (tmp_path / "grp").mkdir()
    (tmp_path / "grp" / "a.yaml").write_text("x: 1\ny: {z: [1, 2]}\n")
    (tmp_path / "base.yaml").write_text("b: 2\nnested: {k: v}\n")
    (tmp_path / "top.yaml").write_text("defaults:\n  - grp: a\n  - base\nc: 3\n")
    ov = ["nested.k=w", "new.deep.key=[1, 2.5]", "c=off"]
    assert tconfig.load_config(tmp_path / "top.yaml", ov) == \
        jconfig.load_config(tmp_path / "top.yaml", ov)
    with pytest.raises(ValueError, match="key=value"):
        tconfig.apply_overrides({}, ["mode"])
