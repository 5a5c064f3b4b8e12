"""The import guard: the benchmark measures the port alone, so the
process that prints a result may hold none of the JAX stack or the JAX
package. Names are compared whole, by their top-level part:
``dmlp_tpu_torch`` is the port and passes, ``dmlp_tpu`` does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

BANNED = frozenset({"jax", "jaxlib", "flax", "dmlp_tpu"})


def banned_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is banned, sorted."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(m for m in names if m.split(".", 1)[0] in BANNED)
