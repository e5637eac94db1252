"""The import check: no module of JAX or of the JAX package in the process.

Modules are compared by their top-level name (the part before the first
dot) as a whole, so ``hpfrec_tpu_torch`` (the measured port) is not
``hpfrec_tpu`` (the JAX package it was ported from).
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "hpfrec_tpu")


def forbidden_modules(names=None) -> list:
    """The loaded module names (or those of ``names``) whose top-level
    name is one of ``FORBIDDEN``."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def check(when: str) -> None:
    """Exit with code 3, naming what was found on standard error, if a
    forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        print("hpfbench: forbidden modules loaded %s: %s" % (when, ", ".join(found)),
              file=sys.stderr)
        raise SystemExit(3)
