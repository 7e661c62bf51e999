"""The benchmark measures the PyTorch port alone: no module of JAX, of
its libraries or of the JAX package may be loaded in the process that
prints the result.  Names are compared by their top-level part, whole
(the port's own name begins with the JAX package's)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})
