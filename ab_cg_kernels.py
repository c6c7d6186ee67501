#!/usr/bin/env python3
"""Time the two CG kernels of two checkouts, in turn, in one process.

    python3 ab_cg_kernels.py OTHER_CHECKOUT [--rounds R]

Builds ``mcmc_tpu_torch/ops/csrc/cg_kernel.cu`` of OTHER_CHECKOUT with
nvcc (the flags of ``ops/cuda_build.py``) beside this checkout's, and
calls both through the same plain C interface on the same operands: the
packed systems of 10 draws at ``chip_smoke.py``'s SGS headline (512
chains x 512^2, K = 48, the mixture CG, 64 iterations) and at its
spherical headline (the CG on a given Sigma, 48 iterations).  For each
kernel and each iteration count (0: the system's build or load and w
alone; 1; the headline's), the mean time a launch over the 10 operand
sets from CUDA events, back to back after a ~25 ms device spin, timed
OTHER, this, this, OTHER (``--rounds R`` times, default 2); and whether
the two checkouts' kernels wrote the same bits.

Prints the card's name and power limit, then one JSON line.  Needs one
CUDA device; imports nothing of JAX.
"""

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

DRAWS = 10


def other_library(checkout, name, bind):
    """Another checkout's ``mcmc_tpu_torch/ops/csrc/<name>.cu``, built into
    this checkout's build directory with this checkout's flags, its entry
    points typed by ``bind`` (the module's ``bind_library``)."""
    from mcmc_tpu_torch.ops.cuda_build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    src = Path(checkout) / "mcmc_tpu_torch" / "ops" / "csrc" / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_other_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True)
    return bind(ctypes.CDLL(str(out)))


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()


def _operands(chain, gen_seed, spherical):
    """DRAWS sets of the packed solve's operands from the initial state."""
    import torch

    from mcmc_tpu_torch.models import chain_sgs as sgs
    from mcmc_tpu_torch.utils.rng import make_generator

    static, consts = chain.build(torch.device("cuda"))
    N = cs.SGS_CHAINS
    state = sgs.sgs_init_state(chain._initial_detrended, consts,
                               chain._initial_z, True, N)
    gen = make_generator(gen_seed, "cuda")
    ops = []
    for _ in range(DRAWS):
        d = sgs.draw(gen, static, consts, N)
        geo = sgs.window_start(static, d.cx, d.cy, d.bsx, d.bsy)
        win = sgs.window_extract(consts.stacked, state.fields, geo.sx32,
                                 geo.sy32, static.SB)
        prep = sgs.prepare(static, consts, win, geo, d.noise, d.drop_u)
        eps = torch.full((N,), prep.eps, dtype=torch.float32, device="cuda")
        if spherical:
            ops.append((sgs.stamp_sigma(static, consts, prep), prep.m_sel,
                        prep.rhs_p, eps))
        else:
            ops.append((prep.iaf, prep.jaf, prep.m_sel, prep.rhs_p, eps))
    return static, ops


def main(argv):
    import torch

    rounds = 2
    if len(argv) == 4 and argv[2] == "--rounds":
        rounds = int(argv[3])
    elif len(argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab_cg_kernels: torch.cuda.is_available() is false")
    from mcmc_tpu_torch.ops import cg_kernel as cgk

    card = card_name()
    print(card, flush=True)
    libs = {"other": other_library(argv[1], "cg_kernel", cgk.bind_library),
            "this": cgk._cuda_library()}
    p = cs.build_problem()
    mix_static, mix_ops = _operands(cs.make_sgs_chain(p), 11, False)
    sph_static, sph_ops = _operands(cs.make_spherical_chain(p), 13, True)
    params = cgk.mix_params(mix_static.mix)

    def mix_call(lib, n_iters):
        def run(iaf, jaf, m, rhs, eps):
            N, K = m.shape
            return cgk._launch(lib.mcmc_mix_masked_cg, m, [
                t.data_ptr() for t in (iaf, jaf, m, rhs, eps)],
                (ctypes.byref(params), N, K, n_iters))
        return run

    def sph_call(lib, n_iters):
        def run(sigma, m, rhs, eps):
            N, K = m.shape
            return cgk._launch(lib.mcmc_masked_cg, m, [
                t.data_ptr() for t in (sigma, m, rhs, eps)],
                (N, K, n_iters))
        return run

    result = {"card": card, "other": str(Path(argv[1]).resolve()),
              "draws": DRAWS, "rounds": rounds}
    for name, call, ops, iters in (
            ("mix_masked_cg", mix_call, mix_ops, mix_static.cg_iters),
            ("masked_cg", sph_call, sph_ops, sph_static.cg_iters)):
        same = all(torch.equal(call(libs["other"], iters)(*op),
                               call(libs["this"], iters)(*op)) for op in ops)
        row = {"K": int(ops[0][-2].shape[1]), "n_iters": iters,
               "same_bits": same}
        for n_iters in (0, 1, iters):
            t = {"other": [], "this": []}
            for _ in range(rounds):
                for which in ("other", "this", "this", "other"):
                    t[which].append(cs._time_ops(call(libs[which], n_iters),
                                                 ops))
            row[f"ms_at_{n_iters}"] = {k: float(np.mean(v))
                                       for k, v in t.items()}
            row[f"ms_at_{n_iters}_runs"] = t
        result[name] = row
        print(f"[ab-cg] {name} K={row['K']}: same bits {same} | "
              + " | ".join(f"{n} iterations: other "
                           f"{row[f'ms_at_{n}']['other']:.4f} ms, this "
                           f"{row[f'ms_at_{n}']['this']:.4f} ms"
                           for n in (0, 1, iters))
              + f" ({card})", flush=True)
    print(json.dumps(result), flush=True)
    return 0 if all(result[k]["same_bits"]
                    for k in ("mix_masked_cg", "masked_cg")) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
