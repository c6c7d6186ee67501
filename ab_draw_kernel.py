#!/usr/bin/env python3
"""Time the per-chain draw kernel of two checkouts, in turn, in one
process.

    python3 ab_draw_kernel.py OTHER_CHECKOUT [--rounds R]

Builds ``mcmc_tpu_torch/ops/csrc/chain_draws.cu`` of OTHER_CHECKOUT beside
this checkout's (``chip_smoke.build_draw_source``: the port's flags,
ptxas' lines kept), and this checkout's source with its tile changed
(VARIANTS: threads a CTA x Philox calls a thread), and calls each through
the same C entry point (``ops/chain_draws.launch_draws``) on the draw
plans of ``chip_smoke.py``'s headlines: the CRF plan at 768 chains, the
SGS plan at 512 chains, and each at the one chain of ``[run]``, every
chain keyed from the seed list [1000, 1001, ...] over ``DRAW_STEPS``
step counters, the last above 2^32.  For each plan and build: how many
values differ from the plain version and from OTHER's (bound 0), and
the median over turns of the mean time a launch over the counters from
CUDA events, back to back after a ~25 ms device spin, timed OTHER, this,
the variants, the variants again, this, OTHER (``--rounds R`` times,
default 2); beside
an empty kernel on OTHER's grid and on this kernel's, and the bound
``chip_smoke.draw_bound`` computes (bytes, and the SASS instructions one
normal call issues at the card's issue rate).  Also builds, untimed, this
source with ``__sincosf`` in place of ``sincosf`` and prints both
builds' ptxas lines: whether the stack frame is sincosf's.

Prints the card's name and power limit, then one JSON line.  Needs one
CUDA device; imports nothing of JAX.
"""

import json
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs
from ab_cg_kernels import card_name

TILE = ("constexpr int kThreads = 128;  // threads a tile CTA\n"
        "constexpr int kCalls = 2;      // Philox calls a tile thread\n")
# this checkout's kernel with another tile: (name, threads a tile CTA,
# Philox calls a tile thread)
VARIANTS = (("64x2", 64, 2), ("32x4", 32, 4), ("256x1", 256, 1),
            ("128x4", 128, 4))
SINCOS = ("  sincosf(t, &s, &c);\n", "  __sincosf(t, &s, &c);\n")


def _source(path):
    return (Path(path) / "mcmc_tpu_torch" / "ops" / "csrc"
            / "chain_draws.cu").read_text()


def _variant(src, old, new, name):
    if src.count(old) != 1:
        raise RuntimeError(f"ab_draw_kernel: the source no longer has the "
                           f"{name!r} cut point")
    return src.replace(old, new)


def _plans():
    """{name: (chains, plan)}: both headlines' draw plans, at their farms'
    chains and at one chain."""
    import torch

    from mcmc_tpu_torch.models import chain_crf as crf
    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.ops.chain_draws import cached_plan

    p = cs.build_problem()
    dev = torch.device("cuda")
    crf_static, _ = cs.make_chain(p).build(dev)
    sgs_static, sgs_consts = cs.make_sgs_chain(p).build(dev)
    crf_plan = cached_plan(crf.draw_plan_entries(crf_static))
    sgs_plan = cached_plan(sgs.draw_plan_entries(sgs_static, sgs_consts))
    return {"crf": (cs.N_CHAINS, crf_plan), "sgs": (cs.SGS_CHAINS, sgs_plan),
            "crf-1": (1, crf_plan), "sgs-1": (1, sgs_plan)}


def _diff(got, want, plan):
    """Values of ``plan``'s views that differ between two buffer pairs."""
    a, b = plan.views(*got), plan.views(*want)
    return sum(int((a[k] != v).sum()) for k, v in b.items())


def main(argv):
    import torch

    rounds = 2
    if len(argv) == 4 and argv[2] == "--rounds":
        rounds = int(argv[3])
    elif len(argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab_draw_kernel: torch.cuda.is_available() is "
                         "false")
    from mcmc_tpu_torch.ops import chain_draws as cd
    from mcmc_tpu_torch.ops.cuda_build import CSRC
    from mcmc_tpu_torch.ops.lut_kernel import empty_launch
    from mcmc_tpu_torch.utils.rng import PerChainStreams

    card = card_name()
    print(card, flush=True)
    this_src = (CSRC / "chain_draws.cu").read_text()
    builds = {"other": cs.build_draw_source("other", _source(argv[1])),
              "this": cs.build_draw_source("this", this_src)}
    for name, threads, calls in VARIANTS:
        builds[name] = cs.build_draw_source(name, _variant(
            this_src, TILE, f"constexpr int kThreads = {threads};\n"
            f"constexpr int kCalls = {calls};\n", name))
    fast = cs.build_draw_source("fast-sincos",
                                _variant(this_src, *SINCOS, "sincosf"))
    for name, (_, path, ptxas) in {**builds, "fast-sincos": fast}.items():
        print(f"[ab-draws] build {name}: " + " | ".join(
            line for line in ptxas if "Used" in line) + " | SASS "
            + ", ".join(str(v) for v in cs._sass_counts(path).values()),
            flush=True)
    per_call, one_call = cs.draw_call_instructions()
    clock_hz = cs.max_sm_clock_hz()
    print(f"[ab-draws] a normal call: {per_call:g} SASS instructions on "
          f"its path past the shared prologue (one call with its prologue "
          f"{one_call}) | max SM clock {clock_hz / 1e6:.0f} MHz ({card})",
          flush=True)
    libs = {k: v[0] for k, v in builds.items()}
    order = ["other", "this", *[v[0] for v in VARIANTS],
             *[v[0] for v in reversed(VARIANTS)], "this", "other"]
    dev = torch.device("cuda")
    steps = [torch.tensor([t], dtype=torch.int64, device=dev)
             for t in range(cs.DRAW_STEPS - 1)] + [
        torch.tensor([(1 << 32) + 5], dtype=torch.int64, device=dev)]
    result = {"card": card, "other": str(Path(argv[1]).resolve()),
              "rounds": rounds, "per_call_sass": per_call,
              "max_sm_clock_hz": clock_hz, "plans": {}}
    ok = True
    for tag, (n, plan) in _plans().items():
        keys = PerChainStreams.from_seeds(cs._seed_list(n), dev).keys
        recorded = [(keys, step) for step in steps]
        diffs = {k: 0 for k in libs}
        vs_other = 0
        for step in steps:
            want = cd.chain_draws_reference(keys, step, plan)
            other = cd.launch_draws(libs["other"], keys, step, plan)
            for which, lib in libs.items():
                got = cd.launch_draws(lib, keys, step, plan)
                diffs[which] += _diff(got, want, plan)
                if which == "this":
                    vs_other += _diff(got, other, plan)
        ok = ok and not any(diffs.values()) and vs_other == 0
        t = {k: [] for k in libs}
        for _ in range(rounds):
            for which in order:
                lib = libs[which]
                t[which].append(cs._time_ops(
                    lambda k, s, lib=lib: cd.launch_draws(lib, k, s, plan),
                    recorded))
        floors = {
            "other": cs._time_ops(
                lambda: empty_launch(-(-n * plan.calls // 256)),
                [()] * len(steps)),
            "this": cs._time_ops(
                lambda: cd.empty_draws_launch(n, plan.calls),
                [()] * len(steps))}
        ms = {k: float(np.median(v)) for k, v in t.items()}
        bound_ms, by, bytes_ms, ops_ms = cs.draw_bound(
            n, plan, per_call, clock_hz)
        info = cd.chain_draws_info(n, plan.calls)
        result["plans"][tag] = {
            "chains": n, "calls": plan.calls, "ms": ms, "ms_runs": t,
            "floor_ms": floors, "diff_vs_plain": diffs,
            "this_vs_other": vs_other, "bound_ms": bound_ms,
            "bound_by": by, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "launch": info}
        print(f"[ab-draws] {tag}: {n} chains x {plan.calls} Philox calls, "
              f"{len(steps)} steps | values not bitwise the plain "
              f"version's {diffs}, this vs other {vs_other} (bound 0) | ms "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f" | empty launch on other's grid {floors['other']:.4f}, "
              f"on this grid {floors['this']:.4f} | bound {bound_ms:.4f} "
              f"ms by {by} (bytes {bytes_ms:.4f}, operations "
              f"{ops_ms:.4f}): this at {bound_ms / ms['this']:.3f} of it, "
              f"other at {bound_ms / ms['other']:.3f} | launch {info} "
              f"({card}; CUDA events, {len(steps)} launches x "
              f"{2 * rounds} each)", flush=True)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
