"""The least time the card could take for a kernel's work, from the work
the algorithm needs: each input byte read once, each output byte written
once, the operations counted from the shapes, against the published peaks
of ``peaks.json``.  The counts follow the repository's chip smoke test
(``_window_bytes``, ``_bound``, ``_cg_work``), which its kernel table in
``PERF.md`` was measured with.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def bound_s(bytes_moved: float = 0.0, flops: float = 0.0,
            peak_flops: float = PEAKS["fp32_flops_per_s"]) -> tuple:
    """(seconds, "bytes" or "operations"): the larger of the bytes over
    the memory bandwidth and the operations over ``peak_flops`` (float32
    outside the tensor cores unless given)."""
    t_bytes = bytes_moved / PEAKS["hbm_bytes_per_s"]
    t_ops = flops / peak_flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def covered_cells(r0, r1, c0, c1, H: int, W: int) -> int:
    """Distinct cells of an (H, W) grid that the rectangles [r0, r1) x
    [c0, c1) cover: the cells of a shared plane a launch reads once."""
    r0, r1, c0, c1 = (np.asarray(a, np.int64) for a in (r0, r1, c0, c1))
    keep = (r1 > r0) & (c1 > c0)
    r0, r1, c0, c1 = r0[keep], r1[keep], c0[keep], c1[keep]
    d = np.zeros((H + 1, W + 1), np.int64)
    np.add.at(d, (r0, c0), 1)
    np.add.at(d, (r0, c1), -1)
    np.add.at(d, (r1, c0), -1)
    np.add.at(d, (r1, c1), 1)
    return int((d.cumsum(0).cumsum(1)[:H, :W] > 0).sum())


def window_bytes(block, accepted, H: int, W: int, n_const: int = 6) -> float:
    """Bytes one launch of the CRF window update must move, from the step's
    trace: ``block`` (N, 4) = centre row, centre column, h, w and
    ``accepted`` (N,).  The const planes over the distinct cells the launch
    covers (surf, velx and vely over the windows, the block and its
    one-cell ring clipped to the grid; the rest over the blocks); per chain
    its bed over the window, its old residual over the block and its raw
    (h, w) proposal, and on accept the resample count read and the three
    state planes written over the block; each size's edge mask once;
    the launch's per-chain geometry, scalars and outputs."""
    b = np.asarray(block, np.int64)
    cx, cy, h, w = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    bx0 = np.maximum(np.floor_divide(2 * cx - h, 2), 0)
    bx1 = np.minimum(np.floor_divide(2 * cx + h, 2), H)
    by0 = np.maximum(np.floor_divide(2 * cy - w, 2), 0)
    by1 = np.minimum(np.floor_divide(2 * cy + w, 2), W)
    r0, r1 = np.maximum(bx0 - 1, 0), np.minimum(bx1 + 1, H)
    c0, c1 = np.maximum(by0 - 1, 0), np.minimum(by1 + 1, W)
    blk = np.maximum(bx1 - bx0, 0) * np.maximum(by1 - by0, 0)
    window = np.where(blk > 0, (r1 - r0) * (c1 - c0), 0)
    hw = h * w
    const = (3 * covered_cells(r0, r1, c0, c1, H, W)
             + (n_const - 3) * covered_cells(bx0, bx1, by0, by1, H, W))
    masks = dict(zip(zip(h.tolist(), w.tolist()), hw.tolist()))
    acc = np.asarray(accepted) > 0
    per_chain = window + blk + hw + 4 * blk * acc
    return 4.0 * float(const + per_chain.sum() + sum(masks.values())
                       + b.shape[0] * (9 + 6 + 3))


def cg_work(n: int, k: int, n_iters: int, build_per_entry: int,
            bytes_in: int) -> tuple:
    """(bytes, flops) of one CG launch over ``n`` systems of ``k``
    unknowns: per iteration a k x k matvec (2k^2), two dot products and
    three axpys (~10k); the system's build costs ``build_per_entry``
    operations a matrix entry; ``bytes_in`` read a system, its k weights
    written."""
    flops = n * (n_iters * (2 * k * k + 10 * k) + build_per_entry * k * k)
    return n * (bytes_in + 4 * k), flops


def mixture_cg_work(n: int, k: int, n_iters: int, terms: int) -> tuple:
    """(bytes, flops) of one mixture-system CG launch: the system built
    from ``terms`` covariance terms (11 + 3 a term operations an entry),
    each system's packed rows, columns, mask and right-hand side and its
    jitter read."""
    return cg_work(n, k, n_iters, 11 + 3 * terms, 4 * (4 * k + 1))
