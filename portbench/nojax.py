"""The check that a run loaded neither JAX nor the JAX package.

A module counts by its top-level name, the part before the first dot,
compared whole: ``collocfem_tpu.ops`` is the JAX package and
``collocfem_tpu_torch.ops`` is not.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "collocfem_tpu"})


def forbidden_modules(names=None) -> list[str]:
    """The loaded module names (``sys.modules`` by default) whose top-level
    name is forbidden, sorted."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
