"""CUDA graph capture, shared by the sampler's captured segments
(``parallel/sampler.py``) and the captured chunks of ``geostats/sgs.py``.
"""

from __future__ import annotations

from typing import Callable

import torch


def capture_graph(body: Callable, generator=None, keep_graph: bool = False):
    """A ``torch.cuda.CUDAGraph`` of ``body()``'s CUDA work, captured on a
    side stream; ``generator`` (a CUDA ``torch.Generator``, or None) is
    registered first, so that each replay draws on from where the last
    draw left it, as the eager calls would.  ``keep_graph`` keeps the
    captured graph beside its instantiation (for ``debug_dump``)."""
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    if generator is not None:
        graph.register_generator_state(generator)
    # thread_local: a capture-unsafe call of another thread of the process
    # (a process group's watchdog, the profiler) does not void the capture
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        body()
    if keep_graph:
        graph.instantiate()
    return graph
