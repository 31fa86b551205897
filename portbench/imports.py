"""The whole-name import check: JAX and the JAX package stay out.

A module counts by its top-level name, the part before the first dot,
compared whole: ``repro_torch`` is the program and passes, ``repro`` and
``repro.core`` are the JAX package and do not.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(modules=None) -> list[str]:
    """Top-level names among ``modules`` (default: the loaded ones) that
    the measuring process must not hold."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
