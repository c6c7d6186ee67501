#!/usr/bin/env python3
"""The port's spans in one traced window of a card benchmark cell.

    python3 tools/span_report.py --workload <name> --seed <n> [--seconds <s>]

From the root of a checkout on a machine with an NVIDIA GPU.  Sets the
cell up as ``cardbench/run.py`` does and runs its window with
``--trace 1``'s profiler (the first ``traced_beds`` beds or
``traced_segments`` segments), judging nothing.  Prints one JSON line:

- ``per_layer``: the cell's per-layer metrics, by the benchmark's readers;
- ``idle_gaps``: the card's idle time named after the innermost host op or
  span at each gap (``cardbench/trace.py``), and ``device_ops``;
- ``spans``: each ``mcmc.*`` span's count, mean and total;
- ``device_annotations``: the profiler's device-side copies of the spans,
  and how many carry the user-annotation flag that keeps them out of the
  card's busy time;
- what the spans give: the mean ``mcmc.sgs.draw``, ``.wait`` and
  ``.replay`` (``draw_us``, ``wait_us``, ``launch_us``); a bed's fixed
  cost, each ``mcmc.sgs`` less the ``mcmc.sgs.chunk`` spans in it
  (``bed_fixed_ms``), and the beds' ``mcmc.sgs`` against the harness's
  ``cardbench.bed``; a segment's prologue, each ``mcmc.run_chains`` from
  its start to its first ``mcmc.run_chains.replay``
  (``segment_prologue_us``), beside ``segment_gap_ms.farm``;
- ``rates``: each unit of the window, traced ones first, as the run logs.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def host_spans(prof) -> list:
    """[(start_ns, end_ns, name)] of the host events named ``mcmc.*`` or
    ``cardbench.*``, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (name.startswith(("mcmc.", "cardbench."))
                and not str(e.device_type()).endswith("CUDA")):
            s = int(e.start_ns())
            out.append((s, s + int(e.duration_ns()), name))
    return sorted(out)


def device_annotations(prof) -> dict:
    """The device-side events named ``mcmc.*``, and those flagged as user
    annotations."""
    found = [e for e in prof.profiler.kineto_results.events()
             if str(e.device_type()).endswith("CUDA")
             and e.name().startswith("mcmc.")]
    return {"count": len(found),
            "flagged": sum(bool(getattr(e, "is_user_annotation",
                                        lambda: False)())
                           for e in found)}


def _inside(spans, outer, name) -> list:
    s, t = outer[:2]
    return [x for x in spans if x[2] == name and s <= x[0] and x[1] <= t]


def _mean(values):
    return statistics.fmean(values) if values else None


def span_numbers(spans) -> dict:
    """Each span's count, mean and total, and what the metrics of the
    module docstring read from them."""
    by = {}
    for s, t, name in spans:
        by.setdefault(name, []).append((t - s) * 1e-3)
    out = {"spans": {n: {"count": len(v), "mean_us": _mean(v),
                         "total_ms": sum(v) * 1e-3}
                     for n, v in sorted(by.items())}}
    for key, name in (("draw_us", "mcmc.sgs.draw"),
                      ("wait_us", "mcmc.sgs.wait"),
                      ("launch_us", "mcmc.sgs.replay"),
                      ("chunk_us", "mcmc.sgs.chunk")):
        out[key] = _mean(by.get(name, []))
    beds = [x for x in spans if x[2] == "mcmc.sgs"]
    chunks = [x for x in spans if x[2] == "mcmc.sgs.chunk"]
    if beds:
        fixed = [(b[1] - b[0] - sum(c[1] - c[0] for c in
                                    _inside(chunks, b, "mcmc.sgs.chunk")))
                 * 1e-6 for b in beds]
        harness = [x for x in spans if x[2] == "cardbench.bed"]
        out.update(bed_fixed_ms=_mean(fixed),
                   chunks_a_bed=len(chunks) / len(beds),
                   sgs_ms=sum(b[1] - b[0] for b in beds) * 1e-6,
                   harness_bed_ms=sum(b[1] - b[0] for b in harness) * 1e-6)
    calls = [x for x in spans if x[2] == "mcmc.run_chains"]
    replays = [x for x in spans if x[2] == "mcmc.run_chains.replay"]
    prologue = []
    for c in calls:
        inner = _inside(replays, c, "mcmc.run_chains.replay")
        if inner:
            prologue.append((inner[0][0] - c[0]) * 1e-3)
    out["segment_prologue_us"] = _mean(prologue)
    out["segment_prologues_us"] = prologue
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import importlib

    import torch

    from cardbench import core
    from cardbench import trace as tracing

    if not torch.cuda.is_available():
        core.log("span_report: no CUDA device (no fallback to the CPU)")
        return 2
    c = core.cell(core.load_spec(), args.workload)
    kind = importlib.import_module("cardbench." + c["traffic"]["kind"])
    st = kind.setup(c["cfg"], c["traffic"], args.seed, "cuda")
    setup_s = time.perf_counter() - T0
    w = kind.window(st, args.seconds, True)
    prof = w.pop("prof")
    view = tracing.reduce_profile(prof)
    kind.fill_view(st, w, view)
    result = {"workload": args.workload, "seed": args.seed,
              "device": torch.cuda.get_device_name(0),
              "gpu": core.query_gpu(), "setup_s": setup_s,
              "per_layer": {m["name"]: core.metric_reader(m["name"]).read(view)
                            for m in c["per_layer"]},
              "window_s": view.window_s, "busy_s": view.busy_s,
              "idle_gaps": view.idle_gaps, "device_ops": view.device_ops(),
              "device_annotations": device_annotations(prof),
              **span_numbers(host_spans(prof)),
              "profiled": w["profiled"], "rates": kind.rates(st, w)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
