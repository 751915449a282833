"""Checkpoint / resume for simulation state.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/aux/checkpoint.py``: a tree
of NamedTuples, dicts, lists and tuples with tensor, array or number leaves
round-trips through one ``.npz`` file. Leaves are stored flat under their
tree-path key (NamedTuple fields by name, dict keys as strings, sequence
items by index, joined by ``/``; ``_root`` for a bare leaf), the keys the
JAX package writes for the same trees, so each package reads the files the
other wrote. :func:`restore` maps the stored arrays back onto a
caller-provided template of the same structure; nothing is pickled.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Callable

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``[(key, leaf), ...]`` in the JAX package's leaf order (dict keys
    sorted, as ``jax.tree_util`` sorts them). ``None`` is an empty subtree."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [("/".join(prefix) if prefix else "_root", tree)]
    out = []
    for name, child in items:
        out.extend(flatten(child, prefix + (str(name),)))
    return out


def map_leaves(fn: Callable[[str, Any], Any], tree: Any, prefix: tuple = ()) -> Any:
    """A tree of the same structure with every leaf replaced by
    ``fn(key, leaf)``."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(map_leaves(fn, c, prefix + (n,)) for n, c in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, c, prefix + (str(i),)) for i, c in enumerate(tree))
    return fn("/".join(prefix) if prefix else "_root", tree)


def _as_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _norm_path(path: str | pathlib.Path) -> pathlib.Path:
    """``np.savez_compressed`` appends ``.npz``; normalise here so that a
    config saying ``checkpoint: {path: traverse.ckpt}`` saves and resumes
    through the same file."""
    path = pathlib.Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(path.suffix + ".npz")


def save(path: str | pathlib.Path, state: Any, metadata: dict | None = None) -> None:
    """Write a checkpoint: one array per leaf, keyed by tree path, and the
    metadata dict as JSON."""
    arrays = {key: _as_array(leaf) for key, leaf in flatten(state)}
    arrays["__metadata__"] = np.frombuffer(json.dumps(metadata or {}).encode(), dtype=np.uint8)
    path = _norm_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_metadata(path: str | pathlib.Path) -> dict:
    """Only the metadata dict of a checkpoint: callers with
    dynamic-structure payloads store the structure here and build the
    :func:`restore` template from it."""
    with np.load(_norm_path(path)) as data:
        return json.loads(bytes(data["__metadata__"].tobytes()).decode() or "{}")


def leaf_shapes(path: str | pathlib.Path) -> dict:
    """``{key: shape}`` of the leaves a checkpoint holds."""
    with np.load(_norm_path(path)) as data:
        return {k: data[k].shape for k in data.files if k != "__metadata__"}


def restore(path: str | pathlib.Path, template: Any, device=None) -> tuple[Any, dict]:
    """Load a checkpoint back onto ``template``'s structure. Returns
    ``(state, metadata)``. Every leaf of ``template`` must be in the file
    with its shape; dtypes follow the stored arrays. Python bools, ints and
    floats in the template come back as such, tensors as tensors on
    ``device`` (default: the template leaf's), anything else as numpy."""
    with np.load(_norm_path(path)) as data:
        meta = json.loads(bytes(data["__metadata__"].tobytes()).decode() or "{}")

        def load(key, tmpl):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            want = tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor) else np.shape(tmpl)
            if tuple(arr.shape) != tuple(want):
                raise ValueError(f"checkpoint leaf {key!r} shape {arr.shape} != template "
                                 f"{tuple(want)}")
            if isinstance(tmpl, (bool, int, float)):
                return type(tmpl)(arr.item())
            if isinstance(tmpl, torch.Tensor):
                return torch.from_numpy(np.array(arr)).to(device or tmpl.device)
            return np.array(arr)

        return map_leaves(load, template), meta
