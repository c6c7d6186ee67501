"""Operands that exercise the port's kernels where they are hardest to get
right, and the float64 references that hold the SRF kernel, shared by
``chip_smoke.py`` and the tests."""

import numpy as np
import torch

from .ops.srf_kernel import srf_norm
from .ops.window_kernel import window_geometry

SRF_CHECK_BUDGET = 32 << 20  # float64 elements of a temporary, at most


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


def k_nearest_operands(n, SB, device, seed=0, keep=1.0, edges=False,
                       radius_cells=None, resolution=500.0, block=True,
                       block_max=None):
    """Operands of ``ops/k_nearest_kernel.k_nearest`` for ``n`` chains'
    (SB, SB) windows, made as ``chain_sgs.prepare`` makes them, from
    numpy's generator ``seed``: each chain's block of 1 .. ``block_max``
    (default SB // 2) rows and columns anywhere in its window or
    (``edges``) against the window's border, on a domain edge or corner
    (the nine placements in turn); the block's cells do not condition, but
    for its 5 % of data cells (none without a ``block``); each other cell
    is kept with probability ``keep`` (dropout).  Squared distances are
    integers, so a dense window ties many cells at the K-th one, around
    the block.  The radius is ``radius_cells`` cells (None: the window's
    diagonal, every kept cell a candidate); z planes of standard normals.
    Returns (cond_mask, rd, cd, radius, resolution, z_w, z_u)."""
    rng = np.random.default_rng(seed)
    rows = np.arange(SB)
    cond = np.empty((n, SB, SB), bool)
    rd = np.empty((n, SB), np.int64)
    cd = np.empty((n, SB), np.int64)
    for i in range(n):
        h, w = rng.integers(1, (block_max or max(SB // 2, 1)) + 1, 2)
        if edges:
            a0 = (0, (SB - h) // 2, SB - h)[i % 3]
            b0 = (0, (SB - w) // 2, SB - w)[i // 3 % 3]
        else:
            a0, b0 = rng.integers(0, SB - h + 1), rng.integers(0, SB - w + 1)
        rd[i] = np.maximum(np.maximum(a0 - rows, rows - (a0 + h - 1)), 0)
        cd[i] = np.maximum(np.maximum(b0 - rows, rows - (b0 + w - 1)), 0)
        in_block = (rd[i][:, None] == 0) & (cd[i][None, :] == 0)
        sim = in_block & (rng.random((SB, SB)) >= 0.05) & block
        cond[i] = ~sim & (rng.random((SB, SB)) < keep)
    radius = (np.hypot(SB, SB) if radius_cells is None
              else radius_cells) * resolution

    def dev(a):
        return torch.as_tensor(a, device=device)

    z = rng.standard_normal((2, n, SB, SB)).astype(np.float32)
    return (dev(cond), dev(rd), dev(cd), float(np.float32(radius)),
            float(np.float32(resolution)), dev(z[0]), dev(z[1]))


def _srf_products(kv, ny, nx, res):
    """The SRF phase's two float32 products, each rounded as the JAX
    package rounds them: a = fl(x_k kx_m) (n, nx, M) and b = fl(y_i
    ky_m) (n, ny, M), with x = arange(nx) * res, y = arange(ny) * res."""
    x = torch.arange(nx, dtype=torch.float32, device=kv.device) * float(res)
    y = torch.arange(ny, dtype=torch.float32, device=kv.device) * float(res)
    return (x[None, :, None] * kv[:, 0, None, :],
            y[None, :, None] * kv[:, 1, None, :])


def srf_separable_float64(kv, z1, z2, ny: int, nx: int, res: float):
    """The (n, ny, nx) float64 SRF fields from the float32-rounded
    products a and b of the phase (``_srf_products``), the sum a + b left
    unrounded: the value the SRF kernel's separable product approximates,

        norm * sum_m cos a (z1 cos b + z2 sin b) + sin a (z2 cos b - z1 sin b)

    with everything after the two products in float64 and norm the
    kernel's float32 sqrt(1 / M).  Chains go in groups that keep each
    temporary under ``SRF_CHECK_BUDGET`` elements."""
    n, _, M = kv.shape
    group = max(1, SRF_CHECK_BUDGET // ((ny + nx) * M))
    out = torch.empty((n, ny, nx), dtype=torch.float64, device=kv.device)
    for c0 in range(0, n, group):
        cs = slice(c0, c0 + group)
        a, b = (t.double() for t in _srf_products(kv[cs], ny, nx, res))
        w1, w2 = z1[cs, None, :].double(), z2[cs, None, :].double()
        cb, sb = torch.cos(b), torch.sin(b)
        left = torch.cat([w1 * cb + w2 * sb, w2 * cb - w1 * sb], dim=-1)
        right = torch.cat([torch.cos(a), torch.sin(a)], dim=-1)
        out[cs] = torch.bmm(left, right.transpose(1, 2)) * srf_norm(M)
    return out


def srf_rounding_bound(kv, z1, z2, ny: int, nx: int, res: float):
    """Per cell, the (n, ny, nx) float64 bound

        norm * sum_m (|z1_m| + |z2_m|) * |fl32(a + b) - (a + b)|

    on |direct - separable|: the field on the float32-rounded phases
    fl32(a + b) (the JAX order, the plain version's) against the field on
    the unrounded a + b (``srf_separable_float64``), both with exact sin
    and cos, since |cos u - cos v| and |sin u - sin v| are at most
    |u - v|.  The modes are summed in chunks, chains in groups, as the
    plain version sums them, each temporary under ``SRF_CHECK_BUDGET``
    elements."""
    n, _, M = kv.shape
    cells = ny * nx
    chunk = max(1, min(M, SRF_CHECK_BUDGET // cells))
    group = max(1, SRF_CHECK_BUDGET // (cells * chunk))
    out = torch.zeros((n, ny, nx), dtype=torch.float64, device=kv.device)
    for c0 in range(0, n, group):
        cs = slice(c0, c0 + group)
        a, b = _srf_products(kv[cs], ny, nx, res)
        weight = (z1[cs].double().abs() + z2[cs].double().abs())
        for m0 in range(0, M, chunk):
            ms = slice(m0, m0 + chunk)
            a_m, b_m = a[:, None, :, ms], b[:, :, None, ms]
            slip = ((b_m + a_m).double() - (b_m.double() + a_m.double()))
            out[cs] += (slip.abs() * weight[:, None, None, ms]).sum(-1)
    return out * srf_norm(M)


def sgs_step_stages(static, consts, state, d, impl: str = "auto") -> dict:
    """The intermediates of one SGS step's MH update on the draws ``d``
    (``chain_sgs.SGSDraws``), by name, in the step's order, without
    writing the state: the window extract; in ``prepare``, the
    unconditional draw's C2R FFT and each op of the K-nearest selection's
    plain version (``kthvalue``, the tie and rank ``cumsum`` scans,
    ``searchsorted``), run on the selection's operands beside the step's
    own ``k_nearest`` (the kernel for CUDA tensors), whose six outputs
    must equal them bit for bit, and the CG's operands; the CG; in
    ``draw_z``, the adjustment's R2C and C2R FFTs; the LUT; in
    ``commit_core``, the residual, both masked square sums and the
    decision.  ``chip_smoke.py``'s [independence] compares chain 0's in a
    batch of N and a batch of 1 to find the first op whose result depends
    on the batch."""
    from .models import chain_sgs as sgs
    from .ops.k_nearest_kernel import KNearest, k_nearest_stages
    from .ops.physics import masked_sq_sum

    kernel = impl != "eager"
    out = {}
    geo = sgs.window_start(static, d.cx, d.cy, d.bsx, d.bsy)
    extract = (sgs.window_extract if kernel
               else sgs.window_extract_reference)
    windows = extract(consts.stacked, state.fields, geo.sx32, geo.sy32,
                      static.SB)
    out["window extract"] = windows
    prep = sgs.prepare(static, consts, windows, geo, d.noise, d.drop_u, impl)
    out["C2R FFT of the unconditional draw"] = prep.z_u
    plain = k_nearest_stages(prep.cond_mask, prep.rd, prep.cd,
                             consts.search_radius, consts.resolution,
                             prep.z_w, prep.z_u, static.K)
    for name in ("kthvalue", "tie cumsum", "rank cumsum", "searchsorted"):
        out[name] = plain[name]
    for name in KNearest._fields:
        if not same_bits(getattr(prep, name), plain[name]):
            raise RuntimeError(f"the step's K-nearest {name} is not its "
                               f"plain version's, bit for bit")
    out["packed idx, sel"] = torch.cat([prep.idx, prep.sel.long()], dim=1)
    out["CG operands"] = torch.stack([prep.rhs_p, prep.iaf, prep.jaf,
                                      prep.m_sel], dim=1)
    w_p = sgs.solve(static, consts, prep, impl)
    out["CG"] = w_p
    adj = sgs.adjustment_ops(static, consts, prep, w_p)
    out["scatter_add"] = adj["scatter_add"]
    out["R2C FFT of the adjustment"] = torch.view_as_real(adj["R2C FFT"])
    out["C2R FFT of the adjustment"] = adj["C2R FFT"]
    z_new_w, z_cache_w = sgs.draw_z(static, consts, prep, w_p, d.noise)
    out["z_new_w"] = z_new_w
    inv_draw = None
    if static.use_transform:
        nst = consts.nst
        lut = sgs.lut_interp if kernel else sgs.lut_interp_reference
        inv_draw = lut(z_new_w, nst.inv_lo, nst.inv_scale, nst.inv_table)
        out["LUT"] = inv_draw
    new_w, sc = sgs.commit_core(consts, state, prep, z_new_w, z_cache_w,
                                inv_draw, d.u)
    out["new window (residual patch)"] = new_w
    patch = (prep.ring_dist <= 1) & (windows[:, 7] > 0)
    out["masked square sum, new"] = masked_sq_sum(new_w[:, 1], patch)
    out["masked square sum, old"] = masked_sq_sum(windows[:, sgs.N_CONST + 1],
                                                  patch)
    out["loss, decision"] = torch.stack([sc.t, sc.comp,
                                         sc.accept.to(torch.float32),
                                         sc.write.to(torch.float32)], dim=1)
    return out


def same_bits(a, b) -> bool:
    """Two tensors equal in shape, type and every byte (NaN payloads
    included)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def first_batch_dependence(many: dict, one: dict):
    """The first stage (``sgs_step_stages``' order) whose chain-0 result
    in the batch ``many`` differs bitwise from the batch of one ``one``
    (NaN equal to NaN), or None."""
    for name, a in many.items():
        b = one[name]
        x, y = a[:1], b[:1]
        if x.shape != y.shape or not torch.equal(
                torch.nan_to_num(x, nan=0.0) if x.is_floating_point() else x,
                torch.nan_to_num(y, nan=0.0) if y.is_floating_point() else y):
            return name
        if x.is_floating_point() and not torch.equal(torch.isnan(x),
                                                     torch.isnan(y)):
            return name
    return None
