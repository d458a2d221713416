"""Kernel roles, one file a role: the work whose device time a roofline
metric holds against the least time the chip could take for it. A role's
file ``<role>.py`` gives

* ``WRAPPER``: (module, attribute) of the program's launch wrapper whose
  calls it records, as strings, so that the file imports nothing of the
  program. The attribute ends in ``_cuda``, and the same module holds the
  role's plain version under the same name ending in ``_plain``, with the
  same arguments: the CPU rehearsals route through it;
* ``keep(args, out)``: what one call keeps, from the wrapper's positional
  arguments and its output, no more than its count reads;
* ``work(*kept)``: that call's (bytes, operations), a function of
  ``counts/kernels.py``, where every role's count lives.

The recorders wrap every role found here, and a roofline metric's file
names its role under ``count``, so a new kernel brings its role as a new
file."""

from __future__ import annotations

import importlib
import pkgutil


def names() -> list:
    return sorted(m.name for m in pkgutil.iter_modules(__path__))


def role(name: str):
    return importlib.import_module(f"{__name__}.{name}")
