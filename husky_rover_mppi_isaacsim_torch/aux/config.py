"""Configuration system: YAML + dotted overrides -> registered dataclasses
(counterpart of the JAX ``aux/config.py``).

Replaces the reference's Hydra/OmegaConf pipeline (run.py:30-73
``omegaconfToDict`` + ``instantiateConfigs`` + configFactory): a plain YAML
tree is composed with ``key=value`` dot-list overrides and instantiated into
the port's dataclasses through a name registry. The YAML comes through
:mod:`.yaml_reader`, the port's reader of the subset ``cfg/`` uses, so the
same code reads the tree on every machine (the card's has no PyYAML).
"""

from __future__ import annotations

import dataclasses
import typing
from pathlib import Path

from . import yaml_reader


class ConfigFactory:
    """Name -> dataclass registry (run.py:56-73 configFactory)."""

    def __init__(self):
        self._registry: dict[str, type] = {}

    def register(self, name: str, cls: type) -> None:
        self._registry[name] = cls

    def __contains__(self, name: str) -> bool:
        return name in self._registry

    def instantiate(self, name: str, data: dict):
        if name not in self._registry:
            raise ValueError(f"Unknown configuration: {name}")
        return build_dataclass(self._registry[name], data)


def _refuse_unknown(cls, data: dict, known) -> None:
    unknown = set(data) - set(known)
    dropped = unknown & getattr(cls, "TPU_ONLY_FIELDS", frozenset())
    if dropped:
        raise ValueError(f"{cls.__name__}: {sorted(dropped)} are TPU-only fields of the JAX "
                         "package, which this port does not have")
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown keys {sorted(unknown)}")


def build_dataclass(cls, data):
    """Build ``cls`` from a dict, instantiating nested dataclass and
    NamedTuple fields and turning lists into tuples where the field is a
    tuple (the reference's __post_init__ expansion pattern,
    src/configurations/environments.py:126-290). Unknown keys raise; a key
    the class lists in ``TPU_ONLY_FIELDS`` raises as TPU-only."""
    if data is None:
        return cls()
    if not dataclasses.is_dataclass(cls):
        if hasattr(cls, "_fields") and isinstance(data, dict):  # NamedTuple configs
            _refuse_unknown(cls, data, cls._fields)
            return cls(**data)
        return data
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for field in dataclasses.fields(cls):
        if field.name not in data:
            continue
        value = data[field.name]
        ftype = hints.get(field.name, field.type)
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[field.name] = build_dataclass(ftype, value)
        elif hasattr(ftype, "_fields") and isinstance(value, dict):
            kwargs[field.name] = ftype(**value)  # NamedTuple configs
        elif isinstance(value, list):
            kwargs[field.name] = tuple(value) if _wants_tuple(ftype) else value
        else:
            kwargs[field.name] = value
    _refuse_unknown(cls, data, (f.name for f in dataclasses.fields(cls)))
    return cls(**kwargs)


def _wants_tuple(ftype) -> bool:
    return ftype is tuple or typing.get_origin(ftype) is tuple


def apply_overrides(tree: dict, overrides: list[str]) -> dict:
    """Hydra-style ``a.b.c=value`` dot-list overrides; each value is read
    as YAML (``[1, 2]``, ``true``, ``0.5``, a string)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, _, raw = item.partition("=")
        value = yaml_reader.loads(raw)
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def load_config(path: str | Path, overrides: list[str] | None = None) -> dict:
    """Load a YAML tree, resolve ``defaults:`` includes relative to the file
    (single-level Hydra-style composition), apply overrides."""
    path = Path(path)
    tree = yaml_reader.load(path) or {}
    defaults = tree.pop("defaults", [])
    merged: dict = {}
    for entry in defaults:
        if isinstance(entry, dict):
            (group, name), = entry.items()
            merged[group] = load_config(path.parent / group / f"{name}.yaml")
        else:
            merged.update(load_config(path.parent / f"{entry}.yaml"))
    merged.update(tree)
    if overrides:
        apply_overrides(merged, overrides)
    return merged


def default_factory() -> ConfigFactory:
    """Factory pre-loaded with the port's config classes under the JAX
    package's names."""
    from ..env.closed_loop import ClosedLoopConfig
    from ..env.rover_sim import RoverParams
    from ..mppi.controller import MPPIConfig
    from ..physics import PhysicsSceneConf
    from ..physics.deformation import DeformationEngineConf
    from ..physics.terramechanics import RobotParameter, TerrainMechanicalParameter
    from ..terrain.craters import CraterSamplerConf
    from ..terrain.rocks import RockDistConf
    from ..terrain.streaming import StreamerConf
    from .stellar import StellarEngineConf

    factory = ConfigFactory()
    for name, cls in (("mppi", MPPIConfig), ("closed_loop", ClosedLoopConfig),
                      ("rover", RoverParams), ("physics_scene", PhysicsSceneConf),
                      ("deformation_engine", DeformationEngineConf),
                      ("terramechanics_robot", RobotParameter),
                      ("terramechanics_terrain", TerrainMechanicalParameter),
                      ("crater_sampler", CraterSamplerConf),
                      ("rock_distribution", RockDistConf),
                      ("terrain_streamer", StreamerConf),
                      ("stellar_engine", StellarEngineConf)):
        factory.register(name, cls)
    return factory


def instantiate_configs(tree: dict, factory: ConfigFactory | None = None) -> dict:
    """Instantiate every top-level key with a registered class; other keys
    pass through as they are (run.py:56-73 semantics)."""
    factory = factory or default_factory()
    return {key: factory.instantiate(key, value)
            if key in factory and isinstance(value, (dict, type(None))) else value
            for key, value in tree.items()}
