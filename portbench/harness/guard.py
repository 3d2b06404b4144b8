"""No JAX in the process: the top-level names that may not be loaded.

A module's top-level name is the part before its first dot, compared whole:
``multimodal_fusion_tpu_torch`` (the port) begins with the JAX package's
name and is not it.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "multimodal_fusion_tpu"})


def forbidden(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among module names ``names``."""
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def loaded() -> List[str]:
    """The forbidden top-level names this process has loaded."""
    return forbidden(name for name, mod in list(sys.modules.items()) if mod is not None)
