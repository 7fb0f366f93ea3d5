"""What a run may not load: JAX, its relatives, the JAX package of this
repository and the scripts that drive it. Names are compared whole, by
the part before the first dot, since the program's own name begins
with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nr3d_lib_tpu", "bench",
                       "experiments"})


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The top-level names in `names` (default: `sys.modules`) that are
    forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
