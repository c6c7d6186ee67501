#!/usr/bin/env python3
"""Time the SGS window extract and writeback kernels of two checkouts, in
turn, in one process.

    python3 ab_window_kernels.py OTHER_CHECKOUT [--rounds R]

Builds ``mcmc_tpu_torch/ops/csrc/sgs_window_kernel.cu`` of OTHER_CHECKOUT
beside this checkout's (``ab_cg_kernels.other_library``) and calls both
through the same C entry points on the same operands: the window starts,
new windows and write masks of 10 SGS steps at ``chip_smoke.py``'s SGS
headline (512 chains x 512^2, SB = 36), recorded as the steps run on this
checkout's kernels; the extracts read the state the steps reach.  For
each kernel: whether the two checkouts' kernels (and this checkout's
writeback held to the window's own cells, ``in_window``) wrote the same
bits as the plain version on all 10 operand sets; and the mean time a
launch over them from CUDA events, back to back after a ~25 ms device
spin, timed OTHER, this, this, OTHER (OTHER, this, in_window, in_window,
this, OTHER for the writeback; ``--rounds R`` times, default 2), beside
the bound ``chip_smoke.py`` computes.  Then this checkout's two writeback
paths with every chain writing at window sizes and start columns that
decide how many of each row's 32-byte sectors are written in part.

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
# (SB, sy alignment in elements) for the writeback's row sweep: the
# headline's random starts (both end sectors of a row in part); sector-
# aligned starts (one, 36 = 4.5 sectors); whole-sector rows of 32 and 40
ROW_CASES = ((36, 1), (36, 8), (32, 8), (40, 8))


def _steps(chain):
    """Run DRAWS SGS steps on the kernels from the initial state; returns
    (static, consts, final state, [(sx, sy, new_w, write)] a step)."""
    import torch

    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.utils.rng import make_generator

    static, consts = chain.build(torch.device("cuda"))
    state = sgs.sgs_init_state(chain._initial_detrended, consts,
                               chain._initial_z, True, cs.SGS_CHAINS)
    recorded = []
    dispatch = sgs.window_writeback

    def writeback(fields, new_w, sx, sy, write):
        recorded.append((sx, sy, new_w, write))
        return dispatch(fields, new_w, sx, sy, write)

    with mock.patch.object(sgs, "window_writeback", writeback):
        step = sgs.make_sgs_kernel(static, "auto")
    gen = make_generator(11, "cuda")
    for _ in range(DRAWS):
        d = sgs.draw(gen, static, consts, cs.SGS_CHAINS)
        state, _ = step(consts, state, d.cx, d.cy, d.bsx, d.bsy, d.noise,
                        d.drop_u, d.u)
    return static, consts, state, recorded


def _row_sweep(fields, this, card):
    """This checkout's two writeback paths with every chain writing, at
    window sizes and start columns that decide how many 32-byte sectors
    of each row are written only in part (``ROW_CASES``): new windows of
    normals at random starts, 10 launches x 2 each.  Returns
    {case: {path: ms, "bound_ms": ms}}."""
    import torch

    from mcmc_tpu_torch.ops import sgs_window_kernel as swk

    N, NS, H, W = fields.shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for SB, align in ROW_CASES:
        ops = []
        for _ in range(DRAWS):
            sx = torch.randint(0, H - SB + 1, (N,), generator=gen,
                               device="cuda", dtype=torch.int32)
            sy = torch.randint(0, (W - SB) // align + 1, (N,), generator=gen,
                               device="cuda", dtype=torch.int32) * align
            new_w = torch.randn((N, NS, SB, SB), generator=gen,
                                device="cuda")
            write = torch.ones(N, dtype=torch.bool, device="cuda")
            ops.append((fields, new_w, sx, sy, write))
        bound_ms, _ = cs._bound(cs.writeback_bytes(ops[0][-1], SB))
        row = {"bound_ms": bound_ms}
        for path in ("mcmc_window_writeback",
                     "mcmc_window_writeback_in_window",
                     "mcmc_window_writeback_in_window",
                     "mcmc_window_writeback"):
            fn = getattr(this, path)
            row.setdefault(path, []).append(cs._time_ops(
                lambda *op, fn=fn: swk.launch_writeback(fn, *op), ops))
        row = {k: float(np.mean(v)) for k, v in row.items()}
        out[f"SB {SB}, sy a multiple of {align}"] = row
        print(f"[ab-window] writeback, all {N} chains writing, SB {SB}, sy "
              f"a multiple of {align}: whole sectors "
              f"{row['mcmc_window_writeback']:.4f} ms, within the window "
              f"{row['mcmc_window_writeback_in_window']:.4f} ms | bound "
              f"{bound_ms:.4f} ms ({card})", flush=True)
    return out


def main(argv):
    import torch

    rounds = 2
    if len(argv) == 4 and argv[2] == "--rounds":
        rounds = int(argv[3])
    elif len(argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab_window_kernels: torch.cuda.is_available() is "
                         "false")
    from mcmc_tpu_torch.ops import sgs_window_kernel as swk

    card = card_name()
    print(card, flush=True)
    this = swk._cuda_library()
    other = other_library(argv[1], "sgs_window_kernel", swk.bind_library)
    entries = {
        "extract": {"other": other.mcmc_window_extract,
                    "this": this.mcmc_window_extract},
        "writeback": {"other": other.mcmc_window_writeback,
                      "this": this.mcmc_window_writeback,
                      "in_window": this.mcmc_window_writeback_in_window}}
    static, consts, state, recorded = _steps(
        cs.make_sgs_chain(cs.build_problem()))
    SB, H, W = static.SB, static.H, static.W
    fields = state.fields
    extract_ops = [(consts.stacked, fields, sx, sy, SB)
                   for sx, sy, _, _ in recorded]

    result = {"card": card, "other": str(Path(argv[1]).resolve()),
              "draws": DRAWS, "rounds": rounds, "SB": SB}
    # bits: each entry's windows against the plain version's; each
    # entry's ten writebacks in turn into its own copy of the state
    same = {}
    for which, fn in entries["extract"].items():
        same[which] = all(torch.equal(
            swk.launch_extract(fn, *op),
            swk.window_extract_reference(*op)) for op in extract_ops)
    want = fields.clone()
    for sx, sy, new_w, write in recorded:
        swk.window_writeback_reference(want, new_w, sx, sy, write)
    same_wb = {}
    for which, fn in entries["writeback"].items():
        got = fields.clone()
        for sx, sy, new_w, write in recorded:
            swk.launch_writeback(fn, got, new_w, sx, sy, write)
        same_wb[which] = torch.equal(got, want)
        del got
    del want
    scratch = fields.clone()
    work = {
        "extract": (extract_ops, swk.launch_extract, same, float(np.mean(
            [cs.extract_bytes(sx, sy, SB, H, W)
             for sx, sy, _, _ in recorded]))),
        "writeback": (
            [(scratch, new_w, sx, sy, write)
             for sx, sy, new_w, write in recorded],
            swk.launch_writeback, same_wb, float(np.mean(
                [cs.writeback_bytes(write, SB) for *_, write in recorded])))}
    for name, (ops, launch, bits, moved) in work.items():
        names = list(entries[name])
        t = {which: [] for which in names}
        for _ in range(rounds):
            for which in names + names[::-1]:
                fn = entries[name][which]
                t[which].append(cs._time_ops(
                    lambda *op, fn=fn: launch(fn, *op), ops))
        bound_ms, _ = cs._bound(moved)
        ms = {k: float(np.mean(v)) for k, v in t.items()}
        result[name] = {"same_bits": bits, "ms": ms, "ms_runs": t,
                        "bound_ms": bound_ms, "bytes": moved}
        print(f"[ab-window] {name} at {cs.SGS_CHAINS} chains x {H}x{W}, "
              f"SB={SB}: same bits as the plain version {bits} | per launch "
              + ", ".join(f"{k} {v:.4f} ms ({bound_ms / v:.3f} of the "
                          f"bound)" for k, v in ms.items())
              + f" | bound {bound_ms:.4f} ms ({moved / 1e6:.1f} MB) "
              f"({card}; CUDA events, {DRAWS} launches x {2 * rounds} "
              f"each)", flush=True)
    result["writeback_rows"] = _row_sweep(scratch, this, card)
    print(json.dumps(result), flush=True)
    return 0 if all(all(result[k]["same_bits"].values())
                    for k in ("extract", "writeback")) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
