"""Named ranges of the port's host work on the profiler's timeline.

``span(name)`` is a ``torch.profiler.record_function`` range while some
profiler records (``MultiChainSampler.run(profile_dir=...)``, the card
benchmark's traced runs, an operator's own ``torch.profiler``), and a
shared null context otherwise, so that a span costs one check when
nothing records.  The ranges are host events on the same clock as the
profiler's CUDA kernels; a range nests in the one open around it on the
same thread, and its count in a trace is its counter.  Every name starts
with ``mcmc.``.  No span goes inside a captured CUDA graph's body: a
replay runs no Python.
"""

from __future__ import annotations

import contextlib

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

_IDLE = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler
    records, else a null context."""
    if _profiler_enabled():
        return record_function(name)
    return _IDLE
