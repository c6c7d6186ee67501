"""CUDA graph capture, shared by the sampler's captured segments
(``parallel/sampler.py``) and the captured chunks of ``geostats/sgs.py``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.launch_counts import uncounted


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


class CountedGraph:
    """The graph ``capture(body, *args)`` returns (``capture_graph``, or a
    stand-in with a ``replay()``), captured through
    ``ops/launch_counts.uncounted``: a capture runs no kernel and a replay
    no Python, so each ``replay()`` adds the launches each dispatcher
    counted in the capture (``launches``, (dispatcher, count) pairs), and
    ``replays`` counts the replays."""

    def __init__(self, capture: Callable, body: Callable, *args):
        self.graph, self.launches = uncounted(capture, body, *args)
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        for counter, n in self.launches:
            counter.launches += n
        self.replays += 1
