"""The reduction of a ``torch.profiler`` window to what the per-layer
metrics read: the device's busy intervals, its idle gaps and what the host
was doing in each, kernel times by name, and the harness's own spans.

Spans are the harness's ``record_function`` ranges named ``cardbench.*``
around its calls into the program (``cardbench.segment``: one
``run_segment``; ``cardbench.copy``: the segment's traces to the host;
``cardbench.bed``: one initial bed).
"""

from __future__ import annotations

import dataclasses

import numpy as np

SPAN_PREFIX = "cardbench."
GAP_ATTRIBUTED_NS = 10_000  # shorter gaps sit between kernels
TOP = 10


def _end_ns(e) -> int:
    end = getattr(e, "end_ns", None)
    return int(end()) if callable(end) else int(e.start_ns() + e.duration_ns())


@dataclasses.dataclass
class TraceView:
    """A profiled window, reduced.  Times in seconds unless named _ns."""

    window_s: float
    busy_s: float
    kernels: dict          # device op name -> (launches, seconds)
    boundary_gaps_s: list  # device idle across each segment boundary
    idle_gaps: list        # [(host op, seconds)] of the longest idle
    steps: int = 0         # units of work in the window: MH steps, chunks
    chains: int = 0
    segments: list = dataclasses.field(default_factory=list)  # traces
    info: dict = dataclasses.field(default_factory=dict)      # the farm's

    def kernel(self, *patterns) -> tuple:
        """(launches, seconds) of the device ops whose names hold any of
        ``patterns``."""
        n, s = 0, 0.0
        for name, (k, t) in self.kernels.items():
            if any(p in name for p in patterns):
                n, s = n + k, s + t
        return n, s

    def device_ops(self) -> list:
        """The device ops that took most time, [(name, seconds)]."""
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
        return [[name[:64], t] for name, (_, t) in ops]


def _union(starts, ends):
    """Merged [start, end) intervals of sorted ``starts``."""
    out = []
    for s, e in zip(starts, ends):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_profile(prof) -> TraceView:
    """The window the harness's spans in ``prof`` cover, reduced."""
    dev, cpu, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = int(e.start_ns()), _end_ns(e)
        if str(e.device_type()).endswith("CUDA"):
            if not name.startswith(SPAN_PREFIX) and not (
                    hasattr(e, "is_user_annotation")
                    and e.is_user_annotation()):
                dev.append((s, t, name))
        elif name.startswith(SPAN_PREFIX):
            spans.append((s, t, name))
        else:
            cpu.append((s, t, name))
    if not spans:
        raise RuntimeError("the profile holds none of the harness's spans")
    lo = min(s for s, _, _ in spans)
    hi = max(t for _, t, _ in spans)
    dev = sorted((max(s, lo), min(t, hi), n) for s, t, n in dev
                 if t > lo and s < hi)
    kernels = {}
    for s, t, n in dev:
        k, d = kernels.get(n, (0, 0.0))
        kernels[n] = (k + 1, d + (t - s) * 1e-9)
    busy = _union([s for s, _, _ in dev], [t for _, t, _ in dev])
    busy_ns = sum(t - s for s, t in busy)
    gaps = []
    edge = lo
    for s, t in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    if hi > edge:
        gaps.append((edge, hi))
    ends = np.array([t for _, t in busy], np.int64)
    starts = np.array([s for s, _ in busy], np.int64)
    boundaries = sorted(t for s, t, n in spans if n == SPAN_PREFIX + "copy")
    boundary = []
    for b in boundaries[:-1]:
        i = np.searchsorted(ends, b, side="right") - 1
        j = np.searchsorted(starts, b, side="left")
        if 0 <= i and j < len(starts):
            boundary.append((starts[j] - ends[i]) * 1e-9)
    return TraceView(window_s=(hi - lo) * 1e-9, busy_s=busy_ns * 1e-9,
                     kernels=kernels, boundary_gaps_s=boundary,
                     idle_gaps=_attribute(gaps, cpu, spans))


def _attribute(gaps, cpu, spans) -> list:
    """Idle seconds by the innermost host op (or harness span) running at
    each gap's middle; gaps under ``GAP_ATTRIBUTED_NS`` pooled as
    between kernels."""
    host = sorted(cpu + spans)
    starts = np.array([s for s, _, _ in host], np.int64)
    by = {}
    short = 0.0
    for s, t in gaps:
        if t - s < GAP_ATTRIBUTED_NS:
            short += (t - s) * 1e-9
            continue
        mid = (s + t) // 2
        name = "host, outside any op"
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        for k in range(i, max(i - 5000, -1), -1):
            if host[k][1] > mid:
                name = host[k][2]
                break
        by[name] = by.get(name, 0.0) + (t - s) * 1e-9
    if short:
        by["between kernels (gaps under 10 us)"] = short
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:TOP]]
