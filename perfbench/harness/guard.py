"""What the measured process may not hold: JAX, and the JAX package that
the program was ported from. Top-level module names are compared whole, so
the program (``mmt_psm_tpu_torch``) is not the JAX package."""

from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "mmt_psm_tpu"})


def banned_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & BANNED)
