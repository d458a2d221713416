"""Records of the kernel roles' calls in a traced segment, for the
rooflines: the program's launch wrapper of every role under
``perfbench/counts/roles/`` is wrapped for the segment's length and put
back after. Each call keeps what its role's ``keep`` gives: what its count
reads, and no feature map or mask."""

from __future__ import annotations

import contextlib
import importlib

from ..counts import roles


def _wrap(module, name: str, keep, into: list):
    orig = getattr(module, name)

    def recorded(*args):
        out = orig(*args)
        into.append(keep(args, out))
        return out

    # the wrapper counts launches where the original does (``<fn>.launches``)
    recorded.launches = orig.launches
    setattr(module, name, recorded)
    return module, name, orig, recorded


@contextlib.contextmanager
def kernel_calls():
    """role -> the list of its calls' records, filled while the block runs."""
    calls, wrapped = {}, []
    try:
        for name in roles.names():
            role = roles.role(name)
            module, attr = role.WRAPPER
            calls[name] = []
            wrapped.append(_wrap(importlib.import_module(module), attr, role.keep, calls[name]))
        yield calls
    finally:
        for module, name, orig, recorded in reversed(wrapped):
            orig.launches = recorded.launches
            setattr(module, name, orig)
