"""Auxiliary machinery: checkpoint / resume of simulation state (counterpart
of the JAX ``aux`` package; its config loader, labeling, render effects and
visualization are not ported yet)."""

from . import checkpoint

__all__ = ["checkpoint"]
