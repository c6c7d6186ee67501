"""The kernel dispatchers that count their launches, in one registry.

A dispatcher joins where it is defined, ``@counted(fragment, ...)``: its
``launches`` starts at 0 and it adds one where it launches its kernel, and
nowhere else; ``kernels`` names the ``__global__`` functions it launches
by a fragment of their mangled symbol (the length-prefixed name, with the
template arguments where two dispatchers launch one template), as a CUDA
graph's dump or a profile shows them.  ``COUNTED`` holds every dispatcher
of the modules imported so far, so any dispatcher that has run is in it.
A CUDA graph's capture runs no kernel and a replay no Python, so a
captured loop captures through ``uncounted`` and adds, a replay, the
launches it returns: ``utils/graphs.CountedGraph`` does both.
"""

from __future__ import annotations

from typing import Callable, Tuple

COUNTED: list = []


def counted(*kernels: str) -> Callable:
    """Register the decorated dispatcher, which launches ``kernels``."""

    def register(fn: Callable) -> Callable:
        fn.launches = 0
        fn.kernels = kernels
        COUNTED.append(fn)
        return fn

    return register


def uncounted(fn: Callable, *args) -> Tuple[object, tuple]:
    """``fn(*args)`` (a capture) with every dispatcher's count put back
    where it stood: (its result, ((dispatcher, launches it counted in
    ``fn``), ...) for each dispatcher that counted any)."""
    before = {c: c.launches for c in COUNTED}
    try:
        out = fn(*args)
        return out, tuple((c, c.launches - before.get(c, 0)) for c in COUNTED
                          if c.launches != before.get(c, 0))
    finally:
        for c in COUNTED:
            c.launches = before.get(c, 0)
