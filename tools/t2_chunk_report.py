#!/usr/bin/env python3
"""A T2 bed's replays on the card, timed on the host's clock.

    python3 tools/t2_chunk_report.py [--seed <n>] [--beds <k>]

From the root of a checkout on a machine with an NVIDIA GPU; no profiler
runs.  Builds ``crf512.initbeds``'s problem and configuration from
``--seed``, makes one warm bed, then ``--beds`` more, and prints one JSON
line with each bed's seconds and cells/s, its chunks, the draw kernel's
launches, and the host's time a replay: ``perf_counter`` from one
replay's start to the next, over all of a bed's replays (the loop's time
over its chunks) and over its first 64; ``drain_ms``, from the last
replay's start to the grid on the host, is the work the host left queued
for the card.  The kernel's own time is ``chip_smoke.py``'s
``[bounded-draw]``.
"""

import argparse
import functools
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 64


class _TimedGraph:
    """A captured graph whose replays note the host's clock."""

    def __init__(self, graph, marks):
        self.graph, self.marks = graph, marks

    def replay(self):
        self.marks.append(time.perf_counter())
        self.graph.replay()


def bed_numbers(seed: int, beds: int) -> list:
    from cardbench import core, initbeds
    from mcmc_tpu_torch.ops.bounded_draw_kernel import bounded_draw

    S = importlib.import_module("mcmc_tpu_torch.geostats.sgs")
    c = core.cell(core.load_spec(), "crf512.initbeds")
    st = initbeds.setup(c["cfg"], c["traffic"], seed, "cuda")
    marks = []

    def capture(body, generator=None):
        return _TimedGraph(S.capture_graph(body, generator), marks)

    loops = S._chunk_loops
    S._chunk_loops = lambda device: (
        functools.partial(S._sgs_loop_captured, capture=capture),
        loops(device)[1])
    cells = int(np.isnan(st.p["cond_bed"]).sum())
    out = []
    try:
        initbeds._bed(st, 0)
        for i in range(1, beds + 1):
            marks.clear()
            before = bounded_draw.launches
            t0 = time.perf_counter()
            initbeds._bed(st, i)
            t1 = time.perf_counter()
            gaps = np.diff(marks) * 1e6
            out.append({"seconds": t1 - t0, "cells_per_s": cells / (t1 - t0),
                        "chunks": -(-cells // CHUNK), "replays": len(marks),
                        "draw_launches": bounded_draw.launches - before,
                        "replay_us_first64": float(gaps[:63].mean()),
                        "replay_us": float(gaps.mean()),
                        "replay_us_median": float(np.median(gaps)),
                        "drain_ms": (t1 - marks[-1]) * 1e3})
    finally:
        S._chunk_loops = loops
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 77)
    ap.add_argument("--beds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from cardbench import core

    if not torch.cuda.is_available():
        print("t2_chunk_report: no CUDA device (no fallback to the CPU)",
              file=sys.stderr)
        return 2
    beds = bed_numbers(args.seed, args.beds)
    result = {"device": torch.cuda.get_device_name(0),
              "gpu": core.query_gpu(), "seed": args.seed, "beds": beds,
              "replay_us_median": statistics.median(
                  b["replay_us"] for b in beds)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
