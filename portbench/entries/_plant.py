"""Faults planted in the program, for the tests that see ``correct`` come out
false and for the calibration of the limits."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patch(owner, name: str, value):
    """``owner.name`` is ``value`` inside the block."""
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, real)
