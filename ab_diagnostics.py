#!/usr/bin/env python3
"""Time the convergence diagnostics of two checkouts on the same traces.

    python3 ab_diagnostics.py OTHER_CHECKOUT [--full]

OTHER_CHECKOUT's ``mcmc_tpu_torch/parallel/diagnostics.py`` is loaded from
its file alone (before the module moved onto the card it imported only
numpy and scipy, and ran on the host whatever the caller asked).  Both
checkouts' functions get the traces ``chip_smoke.py`` ``[diag]`` (b) makes
from its seed: an AR(1) stream held over MH-like rejections, a 768 x
100,001 loss trace with its step trace and a 256 x 20,000 x 8 probes
trace.  For each of the six functions (on the loss trace;
``acceptance_rate`` on the steps) and for the summary
``MultiChainSampler.diagnostics`` makes (its nine calls, in its order, on
all three traces): OTHER's host seconds, one call each (the host takes
minutes), on the 20,000-iteration cut and, with ``--full``, at full
length; this checkout's card seconds at full length (a warm call, then
the median of 3, from card tensors, as ``[diag]`` times them; the
summary through this checkout's ``MultiChainSampler.diagnostics``); and
the largest relative difference between the two checkouts' results.

Prints the card's name and power limit, the host's CPU count, one line a
function, and one JSON line.  Needs one CUDA device; imports nothing of
JAX.
"""

import argparse
import importlib.util
import json
import os
from pathlib import Path

import numpy as np

import chip_smoke as cs

SUMMARY = "sampler.diagnostics"
PROBE_CALLS = ("split_rhat", "ess", "rank_normalized_rhat", "ess_bulk",
               "ess_tail")
LOSS_CALLS = ("split_rhat", "ess", "rank_normalized_rhat")


def other_module(checkout):
    """OTHER_CHECKOUT's diagnostics module, loaded from its file."""
    path = Path(checkout) / "mcmc_tpu_torch" / "parallel" / "diagnostics.py"
    spec = importlib.util.spec_from_file_location("other_diagnostics", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def summary_of(mod, traces):
    """The values ``MultiChainSampler.diagnostics`` computes, by ``mod``'s
    functions in the method's order (no ``elapsed_seconds``)."""
    out = {"acceptance_rate": mod.acceptance_rate(traces["step"])}
    for name, key in zip(PROBE_CALLS, ("rhat", "ess", "rhat_rank",
                                       "ess_bulk", "ess_tail")):
        out[key] = getattr(mod, name)(traces["samples"])
    for name, key in zip(LOSS_CALLS, ("rhat_loss", "ess_loss",
                                      "rhat_rank_loss")):
        out[key] = float(getattr(mod, name)(traces["loss"]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--full", action="store_true",
                    help="also time OTHER at full length (~20 minutes)")
    args = ap.parse_args()
    card, _ = cs.phase_device()  # prints the card's name and power limit
    import torch

    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.parallel import diagnostics as diag

    other = other_module(args.other)
    print(f"[ab-diag] host: {os.cpu_count()} CPUs, torch threads "
          f"{torch.get_num_threads()}; OTHER's module {other.__file__}",
          flush=True)
    rng = np.random.default_rng(cs.DIAG_SEED)
    loss, accepted = cs.mh_like_trace(rng, *cs.DIAG_LOSS)
    probes, _ = cs.mh_like_trace(rng, *cs.DIAG_PROBES[:2],
                                 cs.DIAG_PROBES[2:])
    traces = {"loss": loss, "step": accepted, "samples": probes}
    on_card = {k: torch.as_tensor(v, device=cs.DEVICE)
               for k, v in traces.items()}
    sampler = MultiChainSampler(cs.make_chain(cs.build_problem()),
                                cs.DIAG_LOSS[0], device=cs.DEVICE)
    rows = {}
    for name in cs.DIAG_FUNCTIONS + (SUMMARY,):
        key = None if name == SUMMARY else (
            "step" if name == "acceptance_rate" else "loss")
        if key is None:
            this = sampler.diagnostics

            def theirs(tr):
                return summary_of(other, tr)
        else:
            this, theirs = getattr(diag, name), getattr(other, name)
        card_in = cs._diag_input(on_card, key)
        card_s, peak, got = cs._card_seconds(lambda: this(card_in))
        cut_s, _ = cs._cpu_seconds(lambda: theirs(cs._diag_input(
            traces, key, cs.DIAG_CPU_ITERS)))
        row = {"card_s": card_s, "card_peak_mib": peak / 2**20,
               "other_host_s_cut": cut_s, "other_host_s_full": None,
               "max_rel_diff": None}
        if args.full:
            full_s, want = cs._cpu_seconds(
                lambda: theirs(cs._diag_input(traces, key)))
            row.update(other_host_s_full=full_s,
                       max_rel_diff=max(cs._diag_errs(got, want).values()))
        rows[name] = row
        print(f"[ab-diag] {name}: OTHER on the host {cut_s:.2f} s at "
              f"{cs.DIAG_CPU_ITERS:,} iterations, "
              + (f"{row['other_host_s_full']:.2f} s at full length"
                 if args.full else "full length not run")
              + f" | this on the card {card_s:.4f} s, peak "
              f"{row['card_peak_mib']:.1f} MiB | max rel diff "
              f"{row['max_rel_diff']} ({card})", flush=True)
    result = {"card": card, "host_cpus": os.cpu_count(),
              "loss": list(cs.DIAG_LOSS), "probes": list(cs.DIAG_PROBES),
              "cut_iters": cs.DIAG_CPU_ITERS, "rows": rows}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
