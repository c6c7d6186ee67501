#!/usr/bin/env python3
"""Run one cell of the card benchmark of ``mcmc_tpu_torch`` once.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with an NVIDIA GPU.  Set-up makes
the cell's inputs from ``--seed``, builds the program and warms up its
shapes; the window then measures for ``--seconds``; the plain reference
judges what the window produced.  With ``--trace 0`` the result carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
from a profiled part of the window.  The last line of standard output is
one JSON object; standard error ends with each number compared beside its
limit.  Exits non-zero, printing no result, without a card, or if JAX or
the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fix_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout: the
    program's nvcc builds live in ``mcmc_tpu_torch/_build`` already; a
    torch extension or a Triton kernel it may build goes here."""
    cache = ROOT / "cardbench" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device,
             t0: float, control: bool = False) -> dict:
    """One run of cell ``c`` (``core.cell``) on ``device``: the result
    line's fields, and what the log shows.  The traffic's ``kind`` names
    the module that drives it (``farm``, ``initbeds``).  With
    ``control``, the same numbers of the reference put in the program's
    place in bfloat16 too, under ``control_checks``."""
    import importlib

    import torch

    from cardbench import core
    from cardbench import trace as tracing

    on_card = torch.device(device).type == "cuda"
    kind = importlib.import_module("cardbench." + c["traffic"]["kind"])
    started = time.perf_counter()
    st = kind.setup(c["cfg"], c["traffic"], seed, device)
    setup_s = time.perf_counter() - t0
    gpu_before = core.query_gpu() if on_card else {}
    w = kind.window(st, seconds, trace)
    gpu_after = core.query_gpu() if on_card else {}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    metrics = {}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        view = tracing.reduce_profile(w.pop("prof"))
        kind.fill_view(st, w, view)
        for m in c["per_layer"]:
            value = core.metric_reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": view.device_ops(),
                     "idle_gaps": view.idle_gaps}
        device_info.update(busy_s=view.busy_s, window_s=view.window_s)
    else:
        known = dict(kind.end_to_end(st, w), setup_s=setup_s)
        for name, m in c["e2e"].items():
            metrics[name] = {"value": known[name], "unit": m["unit"]}
    log = dict(setup_parts=dict(start=started - t0, **st.setup_parts,
                                total_s=setup_s),
               rates=kind.rates(st, w), gpu_before=gpu_before,
               gpu_after=gpu_after)
    t = time.perf_counter()
    verdict = kind.judged(st, w, c["limits"], device, control)
    log["judge_s"] = time.perf_counter() - t
    checks = verdict["checks"]
    result = {"correct": all(v["value"] <= v["limit"]
                             for v in checks.values()),
              "attempted": verdict["attempted"],
              "failed": verdict["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    run = dict(result=result, log=log)
    if control:
        run["control_checks"] = verdict["control_checks"]
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fix_caches()
    sys.path.insert(0, str(ROOT))
    from cardbench import core

    spec = core.load_spec()
    c = core.cell(spec, args.workload)
    import torch

    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        core.log(f"cardbench: {args.workload} needs {chips} CUDA device(s); "
                 f"torch sees {torch.cuda.device_count()} "
                 "(no fallback to the CPU)")
        return 2
    import mcmc_tpu_torch  # noqa: F401  (the program under test)


    run = run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = core.forbidden_modules()
    if found:
        core.log("cardbench: JAX or the JAX package was loaded: "
                 + ", ".join(found))
        return 3
    log = run["log"]
    core.log("cardbench: setup " + json.dumps(log["setup_parts"]))
    core.log("cardbench: rate a unit of the window "
             + " ".join(f"{r:.0f}" for r in log["rates"]))
    core.log(f"cardbench: card before the window {json.dumps(log['gpu_before'])}"
             f"; after {json.dumps(log['gpu_after'])}")
    core.log(f"cardbench: judged in {log['judge_s']:.2f} s")
    result = run["result"]
    for name, v in result["checks"].items():
        core.log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
