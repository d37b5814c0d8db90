"""Leaf naming of the universal checkpoint layout (the part of
``deepspeed_tpu/checkpoint/universal/layout.py`` the port needs).

The JAX package names a leaf by its path in the parameter tree, joined
with :data:`SEP` (``flat_values``, ``layout.py:187-198``):
``{"layers": {"wq": ...}}`` → ``layers/wq``. The port holds the same
leaves flat, under dotted names (``layers.wq``), so a leaf's universal
name is its dotted path joined with :data:`SEP`, and the two packages
name every leaf alike.
"""
from __future__ import annotations

SEP = "/"


def universal_name(name: str) -> str:
    """A port parameter name (``layers.wq``) → its universal name
    (``layers/wq``)."""
    return SEP.join(name.split("."))


def param_name(name: str) -> str:
    """A universal name → the port's dotted parameter name."""
    return ".".join(name.split(SEP))
