"""Replacing a module attribute of the port within a block: the benchmark's
named ranges (portbench.tracing) and its planted faults (portbench.faults)
both wrap functions that the timed path looks up at call time."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(owner, attr, make):
    """owner.attr replaced by make(original) within the block. A function
    that counts its calls on its own global name (the port's `.launches`)
    counts on the replacement; the count is added back."""
    fn = getattr(owner, attr)
    new = make(fn)
    start = getattr(fn, "launches", None)
    if start is not None:
        new.launches = start
    setattr(owner, attr, new)
    try:
        yield
    finally:
        setattr(owner, attr, fn)
        if start is not None:
            fn.launches += new.launches - start
