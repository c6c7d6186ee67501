"""Operands that exercise the port's kernels where they are hardest to get
right, shared by ``chip_smoke.py`` and the ``cuda``-marked tests."""

import numpy as np
import torch

from .ops.window_kernel import window_geometry


def edge_window_operands(consts, fields, sizes, n=None, seed=0):
    """Window operands with every block on a domain edge or corner: blocks
    of h, w in ``sizes`` centred on rows and columns 0, 1, the middle,
    H - 2 and H - 1 (``len(sizes)**2 * 25`` cases), cycled over ``n``
    chains (one a case by default), each starting from ``fields``' first
    chain.  The const planes are changed so that every cell is updated
    and in the mc mask, radar data cover 5 % of the cells, and surf and
    the data are NaN at a few edge cells.  Returns (stacked, fields,
    geom, number of cases)."""
    dev = consts.stacked.device
    H, W = consts.stacked.shape[-2:]
    pairs = consts.rf.pairs.cpu().numpy()
    index = {(int(w), int(h)): i for i, (w, h) in enumerate(pairs.T)}
    cases = [(r, c, index[(w, h)])
             for r in (0, 1, H // 2, H - 2, H - 1)
             for c in (0, 1, W // 2, W - 2, W - 1)
             for h in sizes for w in sizes]
    n = len(cases) if n is None else n
    cx, cy, size_idx = torch.tensor(
        [cases[k % len(cases)] for k in range(n)], device=dev).unbind(1)
    geom = window_geometry(cx, cy, consts.rf.pairs[1, size_idx],
                           consts.rf.pairs[0, size_idx], size_idx, H, W)
    rng = np.random.default_rng(seed)
    stacked = consts.stacked.cpu().numpy().copy()
    stacked[4] = 3.0
    stacked[7] = rng.random((H, W)) < 0.05
    stacked[6] = fields[0, 0].cpu().numpy() + rng.normal(0.0, 30.0, (H, W))
    stacked[0, [0, H - 1, 4, H - 7, 1], [3, W - 5, 0, W - 1, 1]] = np.nan
    stacked[6, [0, H - 2, 2], [W - 2, 0, W // 2]] = np.nan
    stacked[7, [0, H - 2, 2], [W - 2, 0, W // 2]] = 1.0
    fields = fields[:1].expand(n, -1, -1, -1).contiguous()
    return torch.as_tensor(stacked, device=dev), fields, geom, len(cases)


def sgs_window_operands(H, W, SB, n, device, seed=1, NP=10, NS=4):
    """Operands of the SGS window extract and writeback on an (H, W) grid:
    NP const planes and n chains' NS state planes of normals, window
    starts anywhere in [0, H - SB] x [0, W - SB] with the first four
    chains on the four clamped corners, new windows, and a write mask
    mixing True (chain 0) and False (chain 1).  Returns (cons, fields, sx,
    sy, new_w, write)."""
    from .utils.rng import make_generator

    gen = make_generator(seed, device)
    cons = torch.randn((NP, H, W), generator=gen, device=device)
    fields = torch.randn((n, NS, H, W), generator=gen, device=device)
    sx = torch.randint(0, H - SB + 1, (n,), generator=gen, device=device,
                       dtype=torch.int32)
    sy = torch.randint(0, W - SB + 1, (n,), generator=gen, device=device,
                       dtype=torch.int32)
    sx[:4] = torch.tensor([0, H - SB, 0, H - SB], dtype=torch.int32)
    sy[:4] = torch.tensor([0, W - SB, W - SB, 0], dtype=torch.int32)
    new_w = torch.randn((n, NS, SB, SB), generator=gen, device=device)
    write = torch.rand((n,), generator=gen, device=device) < 0.5
    write[:2] = torch.tensor([True, False])
    return cons, fields, sx, sy, new_w, write
