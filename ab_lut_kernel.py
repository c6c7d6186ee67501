#!/usr/bin/env python3
"""Time the inverse normal-score LUT kernel of two checkouts, in turn, in
one process.

    python3 ab_lut_kernel.py OTHER_CHECKOUT [--rounds R]

Builds ``mcmc_tpu_torch/ops/csrc/lut_kernel.cu`` of OTHER_CHECKOUT beside
this checkout's (``ab_cg_kernels.other_library``) and calls both through
the same C entry point (``ops/lut_kernel.launch_lut``) on the same
operands: the LUT inputs of 10 SGS steps at ``chip_smoke.py``'s SGS
headline (512 chains x 512^2, SB = 36: 663,552 values a launch, the
4096-row inverse table), recorded as the steps run on this checkout's
kernels.  For each checkout: whether its kernel wrote the plain
version's bits on all 10 inputs (NaN where it is NaN), and the mean time
a launch over them from CUDA events, back to back after a ~25 ms device
spin, timed OTHER, this, this, OTHER (``--rounds R`` times, default 2),
beside the bound ``chip_smoke.py`` computes and the launch floor: an
empty kernel on this kernel's grid and on 2,112 CTAs (the grid of the
one-element-a-thread design), timed the same way.  Then the SGS
headline's
main path (``MultiChainSampler``, 50 profiled steps after 20 warm ones,
the sampler's LUT calls sent to OTHER's kernel or this one's, in turn
OTHER, this, this, OTHER): the LUT kernel's device time a step from
``torch.profiler``.

Prints the card's name and power limit, then one JSON line.  Needs one
CUDA device; imports nothing of JAX.
"""

import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np

import chip_smoke as cs
from ab_cg_kernels import card_name, other_library

DRAWS = 10
OLD_GRID = 132 * 16  # CTAs of the one-element-a-thread launch's cap
PATH_STEPS = 50


def _path_times(libs, card):
    """The LUT kernel's device µs a step on the SGS headline's main path,
    its calls sent to each library in turn (OTHER, this, this, OTHER)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mcmc_tpu_torch import MultiChainSampler
    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.ops import lut_kernel as lk

    sampler = MultiChainSampler(cs.make_sgs_chain(cs.build_problem()),
                                cs.SGS_CHAINS, device="cuda")
    states = sampler.init(seeds=0)
    out = {which: [] for which in libs}
    for which in ("other", "this", "this", "other"):
        lib = libs[which]
        # each segment builds its step, which takes lut_interp then
        with mock.patch.object(
                sgs, "lut_interp",
                lambda x, lo, sc, t, lib=lib: lk.launch_lut(lib, x, lo, sc,
                                                            t)):
            states, _ = sampler.run_segment(states, 20)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                states, _ = sampler.run_segment(states, PATH_STEPS)
                torch.cuda.synchronize()
        us = [getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "lut_kernel" in e.key]
        out[which].append(sum(us) / PATH_STEPS if us else None)
    print(f"[ab-lut] SGS main path, {cs.SGS_CHAINS} chains, {PATH_STEPS} "
          f"profiled steps: LUT kernel device us a step "
          + ", ".join(f"{k} {v}" for k, v in out.items())
          + f" ({card}; torch.profiler)", flush=True)
    return out


def _lut_inputs(chain):
    """Run DRAWS SGS steps on the kernels from the initial state; returns
    (consts, [(x, lo, scale, table)] a step)."""
    import torch

    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.utils.rng import make_generator

    static, consts = chain.build(torch.device("cuda"))
    state = sgs.sgs_init_state(chain._initial_detrended, consts,
                               chain._initial_z, True, cs.SGS_CHAINS)
    recorded = []
    dispatch = sgs.lut_interp

    def lut(x, lo, scale, table):
        recorded.append((x, lo, scale, table))
        return dispatch(x, lo, scale, table)

    with mock.patch.object(sgs, "lut_interp", lut):
        step = sgs.make_sgs_kernel(static, "auto")
    gen = make_generator(11, "cuda")
    for _ in range(DRAWS):
        d = sgs.draw(gen, static, consts, cs.SGS_CHAINS)
        state, _ = step(consts, state, d.cx, d.cy, d.bsx, d.bsy, d.noise,
                        d.drop_u, d.u)
    return consts, recorded


def _same(got, want):
    import torch

    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan], want[~nan]))


def main(argv):
    import torch

    rounds = 2
    if len(argv) == 4 and argv[2] == "--rounds":
        rounds = int(argv[3])
    elif len(argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab_lut_kernel: torch.cuda.is_available() is false")
    from mcmc_tpu_torch.ops import lut_kernel as lk

    card = card_name()
    print(card, flush=True)
    libs = {"other": other_library(argv[1], "lut_kernel", lk.bind_library),
            "this": lk._cuda_library()}
    consts, ops = _lut_inputs(cs.make_sgs_chain(cs.build_problem()))
    x0 = ops[0][0]
    info = lk.lut_kernel_info(x0)
    bits = {which: all(_same(lk.launch_lut(lib, *op),
                             lk.lut_interp_reference(*op)) for op in ops)
            for which, lib in libs.items()}
    t = {which: [] for which in libs}
    grids = {"this_grid": info["ctas"], "old_grid": OLD_GRID}
    floor = {name: [] for name in grids}
    for _ in range(rounds):
        for which in ("other", "this", "this", "other"):
            lib = libs[which]
            t[which].append(cs._time_ops(
                lambda *op, lib=lib: lk.launch_lut(lib, *op), ops))
        for name, blocks in grids.items():
            floor[name].append(cs._time_ops(
                lambda b=blocks: lk.empty_launch(b), [()] * DRAWS))
    table_bytes = 4 * consts.nst.inv_table.numel()
    bound_ms, bound_by = cs._bound(8.0 * x0.numel() + table_bytes)
    ms = {k: float(np.mean(v)) for k, v in t.items()}
    floor_ms = {k: float(np.mean(v)) for k, v in floor.items()}
    result = {"card": card, "other": str(Path(argv[1]).resolve()),
              "draws": DRAWS, "rounds": rounds, "values": x0.numel(),
              "same_bits": bits, "ms": ms, "ms_runs": t, "grids": grids,
              "empty_launch_ms": floor_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "launch": info}
    print(f"[ab-lut] {x0.numel()} values a launch: the plain version's bits "
          f"{bits} | per launch " + ", ".join(
              f"{k} {v:.4f} ms ({bound_ms / v:.3f} of the bound)"
              for k, v in ms.items())
          + f" | bound {bound_ms:.4f} ms by {bound_by} | empty launch on "
          f"{info['ctas']} CTAs {floor_ms['this_grid']:.4f} ms, on "
          f"{OLD_GRID} {floor_ms['old_grid']:.4f} ms"
          f" | {info['registers']} registers, "
          f"{info['resident_ctas_per_sm']} resident CTAs an SM ({card}; "
          f"CUDA events, {DRAWS} launches x {2 * rounds} each)", flush=True)
    result["path_us_per_step"] = _path_times(libs, card)
    print(json.dumps(result), flush=True)
    return 0 if all(bits.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
