#!/usr/bin/env python3
"""Time the port's two main paths in two checkouts, in turn, on one card.

    python3 ab_main_path.py OTHER_CHECKOUT [--rounds R]

Runs the CRF main path (768 chains x 512^2, 3 segments x 500 steps) and
the SGS main path (512 chains x 512^2, 3 segments x 400 steps), each as
``chip_smoke.py`` phases 5 and 7 drive them (``MultiChainSampler.run``
with no progress output, after a 20-step warm-up segment), three times
each, in fresh processes: ``--rounds R`` times (default 1) the four
OTHER, this checkout, this checkout, OTHER.  Each
process imports ``mcmc_tpu_torch`` and ``chip_smoke.py`` of its own
checkout and builds that checkout's kernels.  A difference that follows
the checkout across the interleaved order is the code's; one that follows
the order is the machine's.

Prints the card's name and power limit, one JSON line per process, and a
summary JSON line last: per checkout, the chain-it/s of every timed run
of each path, and whether the two checkouts drew the same chains: each
run's traces (loss, steps, blocks, probes) hashed, the same seeds giving
equal digests only where every launch of the path computed the same
bits.  Needs one CUDA device; imports nothing of JAX.
"""

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
WARM_STEPS = 20
REPEATS = 3


def child(checkout: str):
    """Time both paths in ``checkout``; print one JSON line."""
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke as cs
    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.ops.cuda_build import load_libraries

    for mod in (cs, sys.modules["mcmc_tpu_torch"]):
        if not Path(mod.__file__).resolve().is_relative_to(
                Path(checkout).resolve()):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, "
                               f"not from {checkout}")
    load_libraries(cs.KERNEL_SOURCES)
    p = cs.build_problem()
    paths = (("crf", cs.make_chain, cs.N_CHAINS, cs.SEGMENTS, cs.SEGMENT),
             ("sgs", cs.make_sgs_chain, cs.SGS_CHAINS, cs.SGS_SEGMENTS,
              cs.SGS_SEGMENT))
    out = {"checkout": checkout}
    for name, make, n_chains, segments, segment in paths:
        sampler = MultiChainSampler(make(p), n_chains, device="cuda")
        rates, digests = [], []
        for rep in range(REPEATS):
            states = sampler.init(seeds=rep)
            states, _ = sampler.run_segment(states, WARM_STEPS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, traces = sampler.run(states, segments * segment + 1,
                                    segment_size=segment, progress=False)
            torch.cuda.synchronize()
            rates.append(segments * segment * n_chains
                         / (time.perf_counter() - t0))
            digests.append(_digest(traces))
        out[name] = rates
        out[name + "_digest"] = digests
        del sampler
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def _digest(traces):
    """A short sha256 of a run's traces, key by key."""
    h = hashlib.sha256()
    for key in sorted(traces):
        h.update(key.encode())
        h.update(np.ascontiguousarray(traces[key]).tobytes())
    return h.hexdigest()[:16]


def main(argv):
    if len(argv) == 3 and argv[1] == "--child":
        return child(argv[2])
    rounds = 1
    if len(argv) == 4 and argv[2] == "--rounds":
        rounds = int(argv[3])
    elif len(argv) != 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_main_path: torch.cuda.is_available() is false")
    other = str(Path(argv[1]).resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    runs = []
    for checkout in (other, str(HERE), str(HERE), other) * rounds:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--child", checkout], capture_output=True,
                             text=True, env=env, timeout=900)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            raise RuntimeError(f"the run in {checkout} failed "
                               f"({res.returncode})")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        line["card"] = card
        print(json.dumps(line), flush=True)
        runs.append(line)
    summary = {}
    for label, checkout in (("other", other), ("this", str(HERE))):
        mine = [r for r in runs if r["checkout"] == checkout]
        summary[label] = {}
        for k in ("crf", "sgs"):
            rates = [x for r in mine for x in r[k]]
            q1, med, q3 = np.percentile(rates, [25, 50, 75])
            summary[label][k] = {"rates": rates, "median": med, "q1": q1,
                                 "q3": q3}
    summary["same_chains"] = {
        k: len({tuple(r[k + "_digest"]) for r in runs}) == 1
        for k in ("crf", "sgs")}
    summary["card"] = card
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
