"""The modules a run may not load: JAX and the JAX package the port was
made from.  Names are compared whole, by the part before the first dot,
because the port's own name begins with the JAX package's."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
