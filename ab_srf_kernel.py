#!/usr/bin/env python3
"""Time the SRF harmonic-sum kernel of two checkouts, in turn, in one
process.

    python3 ab_srf_kernel.py OTHER_CHECKOUT [--rounds R]

Builds ``mcmc_tpu_torch/ops/csrc/srf_kernel.cu`` of OTHER_CHECKOUT beside
this checkout's (``ab_cg_kernels.other_library``) and calls both through
the same C entry point (``ops/srf_kernel.launch_srf``) on the same
operands: ``chip_smoke.py``'s headline (768 chains x 80 x 80, Matern,
1000 modes) and one 512 x 512 field.  For each checkout and case: its
largest error against the float64 field on the unrounded phase
(``testing.srf_separable_float64``) and its largest excess over the
phase-rounding bound (``testing.srf_rounding_bound``) against the plain
version, and the mean time a launch from CUDA events, back to back after
a ~25 ms device spin, timed OTHER, this, this, OTHER (``--rounds R``
times, default 2).  Then where this kernel's time goes: this checkout's
source built twice more, once without the product (the chunks of L and R
built, the tensor cores idle) and once without the build after the first
chunk (the product alone), timed in the same turns.  Then the SRF farm's
main path (``chip_smoke.make_srf_chain``, 768 chains), its harmonic sums
sent to each checkout's kernel in turn (OTHER, this, this, OTHER): ms a
step over 50 steps after 10 warm ones (host clock, ending in a
synchronize), chain-it/s, and a profiled window's device-busy share.

Prints the card's name and power limit, then one JSON line.  Exits 1
unless this checkout's kernel passes both checks in every case.  Needs
one CUDA device; imports nothing of JAX.
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

import chip_smoke as cs
from ab_cg_kernels import card_name, other_library

FARM_WARM, FARM_STEPS = 10, 50
# this checkout's kernel with one part cut out: (name, text, replacement)
PARTS = (
    ("build only", "    consume<T, R>(smem + (c & 1) * C::kBuffer, acc);\n",
     ""),
    ("product only", "    if (c + 1 < chunks)\n      produce<T, R>(",
     "    if (c + 1 < 0)\n      produce<T, R>("),
)


def part_library(name, old, new, bind):
    """This checkout's ``srf_kernel.cu`` with ``old`` replaced by ``new``,
    built into the build directory with the port's flags."""
    from mcmc_tpu_torch.ops.cuda_build import (BUILD_DIR, CSRC, NVCC_FLAGS,
                                               find_nvcc)

    src = (CSRC / "srf_kernel.cu").read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"ab_srf_kernel: the source no longer has the "
                           f"{name!r} cut point")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_")
    cu = BUILD_DIR / f"srf_kernel_{tag}.cu"
    cu.write_text(src.replace(old, new))
    out = BUILD_DIR / f"libsrf_kernel_{tag}.so"
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(cu)],
                   check=True, capture_output=True, text=True)
    return bind(ctypes.CDLL(str(out)))


def _checks(got, op):
    """(max |got - separable float64|, max excess of |got - plain| over
    the phase-rounding bound)."""
    from mcmc_tpu_torch.ops.srf_kernel import srf_harmonics_reference
    from mcmc_tpu_torch.testing import (srf_rounding_bound,
                                        srf_separable_float64)

    sep = float((got.double() - srf_separable_float64(*op)).abs().max())
    err = (got - srf_harmonics_reference(*op)).double().abs()
    return sep, float((err - srf_rounding_bound(*op)).max())


def _farm(libs, card):
    """The SRF farm's ms a step and chain-it/s with its harmonic sums on
    each library in turn (OTHER, this, this, OTHER), and each turn's
    profiled device-busy share."""
    import torch

    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.ops import srf as srf_ops
    from mcmc_tpu_torch.ops import srf_kernel as sk

    sampler = MultiChainSampler(cs.make_srf_chain(cs.build_problem()),
                                cs.N_CHAINS, device="cuda")
    states = sampler.init(seeds=0)
    out = {which: {"ms_per_step": [], "chain_it_per_s": [], "busy_us": []}
           for which in libs}
    for which in ("other", "this", "this", "other"):
        lib = libs[which]

        def harmonics(kv, z1, z2, ny, nx, res, lib=lib):
            return sk.launch_srf(lib, kv.contiguous(), z1.contiguous(),
                                 z2.contiguous(), int(ny), int(nx), res)

        with mock.patch.object(srf_ops, "srf_harmonics", harmonics):
            states, _ = sampler.run_segment(states, FARM_WARM)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states, _ = sampler.run_segment(states, FARM_STEPS)
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / FARM_STEPS
            prof = cs.busy_share(sampler, states, card, step_s * 1e6,
                                 n_steps=20, watch=("srf",),
                                 tag=f"ab-srf-profile {which}")
        out[which]["ms_per_step"].append(step_s * 1e3)
        out[which]["chain_it_per_s"].append(cs.N_CHAINS / step_s)
        out[which]["busy_us"].append(prof and prof["busy_us"])
        print(f"[ab-srf] SRF farm on {which}'s kernel, {cs.N_CHAINS} chains:"
              f" {step_s * 1e3:.3f} ms a step, "
              f"{cs.N_CHAINS / step_s:,.0f} chain-it/s ({card})", flush=True)
    return out


def main(argv):
    import torch

    rounds = 2
    if len(argv) == 4 and argv[2] == "--rounds":
        rounds = int(argv[3])
    elif len(argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab_srf_kernel: torch.cuda.is_available() is false")
    from mcmc_tpu_torch.ops import srf_kernel as sk

    card = card_name()
    print(card, flush=True)
    libs = {"other": other_library(argv[1], "srf_kernel", sk.bind_library),
            "this": sk._cuda_library()}
    parts = {name: part_library(name, old, new, sk.bind_library)
             for name, old, new in PARTS}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    result = {"card": card, "other": str(Path(argv[1]).resolve()),
              "rounds": rounds, "timed": cs.SRF_TIMED}
    ok = True
    for tag, n, side in (("headline", cs.N_CHAINS, 80),
                         ("field", 1, cs.SRF_FIELD)):
        kv, z1, z2 = cs._srf_operands(gen, n, "Matern", True, dev)
        op = (kv, z1, z2, side, side, cs.RES)
        calls = {which: (lambda *a, lib=lib: sk.launch_srf(lib, *a))
                 for which, lib in {**libs, **parts}.items()}
        checks = {which: _checks(calls[which](*op), op) for which in libs}
        ok = ok and max(checks["this"]) <= cs.SRF_ATOL
        t = {which: [] for which in calls}
        for _ in range(rounds):
            for which in ("other", "this", *parts, *reversed(parts), "this",
                          "other"):
                t[which].append(cs._time_ops(calls[which],
                                             [op] * cs.SRF_TIMED))
        ms = {k: float(np.mean(v)) for k, v in t.items()}
        result[tag] = {"chains": n, "side": side, "ms": ms, "ms_runs": t,
                       "checks": checks}
        print(f"[ab-srf] {tag}: {n} x {side} x {side} | "
              + " | ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + " | (i) max |kernel - separable float64|, (ii) excess over "
              "the rounding bound: " + ", ".join(
                  f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in checks.items())
              + f" (bound {cs.SRF_ATOL:g} each; {card}; CUDA events, "
              f"{cs.SRF_TIMED} launches x {2 * rounds} each)", flush=True)
    result["farm"] = _farm(libs, card)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
