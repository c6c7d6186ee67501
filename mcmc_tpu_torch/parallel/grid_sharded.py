"""Grid-domain sharding with a halo exchange over ranks.

PyTorch counterpart of ``mcmc_tpu/parallel/grid_sharded.py``.  For grids
too large for one card, each chain's (H, W) domain is split row-wise over
the ``grid`` axis of a mesh of ranks (``parallel/mesh.py``), and the pad-1
gradient stencil of the mass-conservation residual (reference
Topography.py:592-600) is met by exchanging one boundary row with each
neighbouring shard.  numpy-gradient edge semantics hold: interior shard
edges take central differences across the boundary (through the halo
rows); the first and last global rows keep their one-sided differences.

Two samplers, as in the JAX package: ``make_sharded_crf_chain`` (one chain,
its domain row-sharded) and ``make_sharded_crf_chains`` (a batch of chains
sharded over ``chains``, each chain's domain over ``grid``).  Both take the
incremental windowed step of the JAX package's ``_make_local_crf_step``:
a (RW, CW) window around the block's part in the shard, one flux row
exchanged each way, the stale one-cell ring outside the block, the loss
delta and the thickness-violation flag summed over the grid axis, and
Kahan accumulation of accepted deltas.  Here the step is batched over a
rank's chains, as the rest of the port batches them.

Communication.  A step makes two collectives, whatever the number of
ranks: one ``all_gather`` over the ``grid`` group of every chain's (2, CW)
boundary flux rows, from which each rank picks its neighbours' (gloo has
no ``send``/``recv`` for CUDA tensors, and the gather serves NCCL and
gloo alike), and one ``all_reduce`` of every chain's loss-delta row sums
and violation flag.  The sums are kept a row apiece, each row at its
place, so the reduction adds only zeros and the loss and the MH
decisions come out the same bits at any number of shards (on the card,
where the rest of the step is too); the JAX package's ``psum`` of
per-shard partial sums rounds apart by layout.  With one shard there is
nothing to exchange: the rank is its own neighbour, as ``ppermute`` over
one device is, and the global edges' one-sided differences overwrite
what that gives.  A block may span three shards (rows_local < B + 4,
where RW = rows_local).

Draws.  Every grid rank of a chain row must draw the same proposal, and
chain i's draws must not depend on the mesh: the random source
(keyword-only ``rng``) is the whole batch's, a ``torch.Generator`` seeded
alike on every rank (each rank draws all chains and keeps its chain row's,
``utils/rng.RowSlice``) or per-chain streams of every chain (a rank keeps
its chains' keys).  ``ShardedCRF.step`` takes the draws as arguments, the
seam that tests fill with the JAX package's draws.

The JAX package has no Pallas kernel here (jnp under ``shard_map``), and
this module is plain PyTorch, run on the rank's device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models.chain_crf import draw, propose
from ..models.randfield import RandFieldArrays, finish_block
from ..ops.physics import masked_sq_rows, row_sum
from ..utils.rng import PerChainStreams, RowSlice
from .mesh import Mesh, _tree_map

PLANES = ("surf", "velx", "vely", "dhdt", "smb", "update_mask", "mc_mask",
          "crf_weight")
GRID_FORM = "run(beds, consts, n_iter, *, rng)"


def _axis(mesh: Mesh, axis):
    """(shards on ``axis``, this rank's index, its group): (1, 0, None)
    when the mesh has no such axis."""
    if axis is None or axis not in mesh.axis_names:
        return 1, 0, None
    return mesh.shape[axis], mesh.index(axis), mesh.group(axis)


class _Grid:
    """A rank's place on the grid axis and its two collectives, counted
    in ``collectives``."""

    def __init__(self, mesh: Mesh, grid_axis: str, H: int):
        self.n, self.index, self.group = _axis(mesh, grid_axis)
        if H % self.n:
            raise ValueError(f"grid rows {H} not divisible by {self.n} "
                             "shards")
        self.rows = H // self.n
        self.row0 = self.index * self.rows
        self.collectives = 0

    def halo(self, first, last):
        """(top, bottom) halo rows: the previous shard's ``last`` and the
        next shard's ``first``, wrapping round at the ends (one
        ``all_gather``)."""
        if self.group is None:
            return last, first
        both = torch.stack([first, last]).contiguous()
        parts = [torch.empty_like(both) for _ in range(self.n)]
        dist.all_gather(parts, both, group=self.group)
        self.collectives += 1
        return (parts[(self.index - 1) % self.n][1],
                parts[(self.index + 1) % self.n][0])

    def sum(self, x):
        """``x`` summed over the grid axis (one ``all_reduce``)."""
        if self.group is None:
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        self.collectives += 1
        return x

    def gradient_rows(self, f, resolution):
        """d/dy over the shard's rows (axis -2) with numpy-gradient
        semantics across shards."""
        top, bot = self.halo(f[..., 0, :], f[..., -1, :])
        fp = torch.cat([top[..., None, :], f, bot[..., None, :]], dim=-2)
        out = (fp[..., 2:, :] - fp[..., :-2, :]) / (2.0 * resolution)
        if self.index == 0:
            out[..., 0, :] = (f[..., 1, :] - f[..., 0, :]) / resolution
        if self.index == self.n - 1:
            out[..., -1, :] = (f[..., -1, :] - f[..., -2, :]) / resolution
        return out

    def sq_sum(self, res, mask):
        """The whole domain's masked square sum (``physics.masked_sq_sum``)
        from this shard's rows: each row's sum at its global row, the
        rows gathered by one ``all_reduce`` that adds only zeros to each,
        then summed over H in the one-domain order, so the bits do not
        depend on the number of shards."""
        part = masked_sq_rows(res, mask)
        rows = part.new_zeros(part.shape[:-1] + (self.n * self.rows,))
        rows[..., self.row0:self.row0 + self.rows] = part
        return row_sum(self.sum(rows))

    def residual(self, bed, surf, velx, vely, dhdt, smb, resolution):
        """The shard's rows of the mass-conservation residual."""
        thick = surf - bed
        dx = _gradient_cols(velx * thick, resolution)
        dy = self.gradient_rows(vely * thick, resolution)
        return dx + dy + dhdt - smb


def _gradient_cols(f, resolution):
    """d/dx within a shard (columns are not sharded)."""
    central = (f[..., 2:] - f[..., :-2]) / (2.0 * resolution)
    first = (f[..., 1:2] - f[..., 0:1]) / resolution
    last = (f[..., -1:] - f[..., -2:-1]) / resolution
    return torch.cat([first, central, last], dim=-1)


def make_sharded_residual(mesh: Mesh, grid_axis: str = "grid"):
    """The row-sharded mass-conservation residual:
    ``fn(bed, surf, velx, vely, dhdt, smb, resolution)`` on this rank's
    (rows_local, W) rows (``shard_grid_arrays``) returns its rows of the
    residual.  Every rank of a grid row calls it together."""

    def fn(bed, surf, velx, vely, dhdt, smb, resolution):
        grid = _Grid(mesh, grid_axis, bed.shape[-2] * _axis(mesh,
                                                            grid_axis)[0])
        return grid.residual(bed, surf, velx, vely, dhdt, smb,
                             float(resolution))

    return fn


def make_sharded_loss(mesh: Mesh, grid_axis: str = "grid"):
    """The row-sharded masked Gaussian loss: ``fn(res, mask, sigma)`` on
    this rank's rows returns the whole domain's nansum(res[mask]²) /
    (2 sigma²), the same on every rank of the grid row."""

    def fn(res, mask, sigma):
        grid = _Grid(mesh, grid_axis, res.shape[-2] * _axis(mesh,
                                                            grid_axis)[0])
        total = grid.sq_sum(res, torch.as_tensor(mask, device=res.device)
                            .to(torch.bool))
        return total / (2.0 * float(sigma) ** 2)

    return fn


def shard_grid_arrays(mesh: Mesh, tree, grid_axis: str = "grid"):
    """This rank's rows of every (..., H, W) array of ``tree``, on its
    device: the rows split over the ``grid`` axis (axis -2)."""
    n, g, _ = _axis(mesh, grid_axis)

    def put(x):
        x = torch.as_tensor(x).to(mesh.device)
        H = x.shape[-2]
        if H % n:
            raise ValueError(f"grid rows {H} not divisible by {n} shards")
        k = H // n
        return x[..., g * k:(g + 1) * k, :]

    return _tree_map(put, tree)


def shard_crf_consts(mesh: Mesh, consts, grid_axis: str = "grid") -> dict:
    """The grid samplers' ``consts`` for this rank from a built chain's
    ``CRFConsts``: its rows of the (H, W) planes in the JAX package's
    form (surf, velx, vely, dhdt = the forcing dhdt - smb, smb = 0,
    update_mask, mc_mask, crf_weight) and the shared rf, region_cells,
    sigma_mc and resolution."""
    planes = {"surf": consts.surf, "velx": consts.velx, "vely": consts.vely,
              "dhdt": consts.forcing, "smb": torch.zeros_like(consts.forcing),
              "update_mask": consts.update_mask,
              "mc_mask": consts.mc_mask.to(torch.float32),
              "crf_weight": consts.crf_weight}
    out = shard_grid_arrays(mesh, planes, grid_axis)
    out.update(rf=_tree_map(lambda x: torch.as_tensor(x).to(mesh.device),
                            consts.rf),
               region_cells=consts.region_cells.to(mesh.device),
               sigma_mc=consts.sigma_mc, resolution=consts.resolution)
    return out


@dataclasses.dataclass(frozen=True)
class _ProposalConsts:
    """What ``chain_crf.draw`` and ``propose`` read of a chain's consts."""

    rf: RandFieldArrays


class ShardedCRF:
    """The incremental CRF step over a rank's chains and rows (module
    docstring).  ``consts``: this rank's planes and the shared values
    (``shard_crf_consts``).  ``n_total`` chains over the ``chain_axis``
    (one chain, replicated over chain rows, when it is None); this rank
    steps chains [lo, hi)."""

    def __init__(self, mesh: Mesh, static, consts: dict, n_total: int,
                 chain_axis="chains", grid_axis: str = "grid"):
        self.static = static
        H, W, B = static.H, static.W, static.rf.B
        self.grid = _Grid(mesh, grid_axis, H)
        rl = self.grid.rows
        self.RW, self.CW = min(rl, B + 4), min(W, B + 4)
        n_chain_shards, c, _ = _axis(mesh, chain_axis)
        if n_total % n_chain_shards:
            raise ValueError(f"{n_total} chains not divisible by "
                             f"{n_chain_shards} chain shards")
        per = n_total // n_chain_shards
        self.n_total, self.lo, self.hi = n_total, c * per, (c + 1) * per
        self.device = mesh.device
        planes = [torch.as_tensor(consts[k]).to(self.device, torch.float32)
                  for k in PLANES]
        if any(p.shape != (rl, W) for p in planes):
            raise ValueError(f"consts planes must be this rank's ({rl}, {W}) "
                             "rows (shard_grid_arrays)")
        self.cons = torch.stack(planes)
        self.region_cells = torch.as_tensor(consts["region_cells"]).to(
            self.device, torch.int64)
        self.rf = consts["rf"]
        self.sigma = float(consts["sigma_mc"])
        self.resolution = float(consts["resolution"])
        self.ar_r = torch.arange(self.RW, device=self.device)
        self.ar_c = torch.arange(self.CW, device=self.device)

    def init(self, beds):
        """(state (C, 2, rows_local, W) [bed, residual], loss (C,), comp
        (C,)) of this rank's beds (C, rows_local, W): the residual with the
        halo exchange, the loss summed over the grid axis."""
        beds = torch.as_tensor(beds).to(self.device, torch.float32)
        surf, velx, vely, dhdt, smb = self.cons[:5]
        res = self.grid.residual(beds, surf, velx, vely, dhdt, smb,
                                 self.resolution)
        loss = self.grid.sq_sum(res, self.cons[6] > 0) / (
            2.0 * self.sigma ** 2)
        return (torch.stack([beds, res], dim=1).contiguous(), loss,
                torch.zeros_like(loss))

    def draws(self, rng):
        """One step's proposals for this rank's chains from the whole
        batch's ``rng``: (f (C, B, B) finished, w, h, cidx, u)."""
        if isinstance(rng, PerChainStreams):
            if rng.n_chains != self.n_total:
                raise ValueError(f"{rng.n_chains} per-chain streams for "
                                 f"{self.n_total} chains")
            src, n = rng.rows(self.lo, self.hi), self.hi - self.lo
        elif isinstance(rng, torch.Generator):
            src, n = RowSlice(rng, self.n_total, self.lo, self.hi), None
        else:
            raise TypeError(f"{GRID_FORM}: rng must be a torch.Generator or "
                            "per-chain streams of every chain, got "
                            f"{type(rng).__name__}")
        pc = _ProposalConsts(rf=self.rf)
        d = draw(src, self.static, pc, n)
        f = propose(self.static, pc, d)
        if self.static.rf.spectral and not self.static.rf.has_nugget:
            f = finish_block(f, d.size_idx, d.scale, self.rf)
        return (f, self.rf.pairs[0, d.size_idx], self.rf.pairs[1, d.size_idx],
                d.cidx, d.u)

    def step(self, state, loss, comp, f, w, h, cidx, u):
        """One MH step of every chain on given draws (the parity seam):
        ``state`` is updated in place; returns (loss, comp, accept)."""
        st, g = self.static, self.grid
        H, W, rl, RW, CW = st.H, st.W, g.rows, self.RW, self.CW
        res2 = 2.0 * self.resolution
        C = state.shape[0]
        ci = torch.arange(C, device=self.device)
        cx = self.region_cells[cidx, 0]
        cy = self.region_cells[cidx, 1]
        off_x = torch.div(2 * cx - h, 2, rounding_mode="floor")
        off_y = torch.div(2 * cy - w, 2, rounding_mode="floor")
        bxmin = off_x.clamp(min=0)
        bxmax = torch.div(2 * cx + h, 2, rounding_mode="floor").clamp(max=H)
        bymin = off_y.clamp(min=0)
        bymax = torch.div(2 * cy + w, 2, rounding_mode="floor").clamp(max=W)
        # the window covers (block ∩ shard) with a >= 2-cell margin
        # wherever the block is interior to the shard and the domain
        ls = (bxmin - 2 - g.row0).clamp(0, rl - RW)
        cs = (bymin - 2).clamp(0, W - CW)
        rows = ls[:, None] + self.ar_r                     # (C, RW)
        cols = cs[:, None] + self.ar_c                     # (C, CW)
        r3, c3 = rows[:, :, None], cols[:, None, :]
        surf_w, velx_w, vely_w, dhdt_w, smb_w, upd_w, mcf_w, crfw_w = (
            self.cons[:, r3, c3])
        bed, res = state[:, 0], state[:, 1]
        bed_w, res_w = bed[ci[:, None, None], r3, c3], res[ci[:, None, None],
                                                           r3, c3]
        gr = g.row0 + rows
        in_rows = (gr >= bxmin[:, None]) & (gr < bxmax[:, None])
        in_cols = (cols >= bymin[:, None]) & (cols < bymax[:, None])
        in_block = in_rows[:, :, None] & in_cols[:, None, :]
        # the proposal's cells under the window; cells off the block are
        # masked, so the clamped lookups there are never used
        B = self.static.rf.B
        fr = (gr - off_x[:, None]).clamp(0, B - 1)
        fc = (cols - off_y[:, None]).clamp(0, B - 1)
        pert = f[ci[:, None, None], fr[:, :, None], fc[:, None, :]] * crfw_w
        pert = torch.where(in_block & (upd_w > 0), pert, 0.0)
        bed_new_w = bed_w + pert

        fx_w = velx_w * (surf_w - bed_new_w)
        fy_w = vely_w * (surf_w - bed_new_w)

        def old_flux_row(r):
            """vely * (surf - bed) of the unchanged state, row r (C,)."""
            r2 = r[:, None]
            return self.cons[2][r2, cols] * (self.cons[0][r2, cols]
                                             - bed[ci[:, None], r2, cols])

        zero = torch.zeros_like(ls)
        last = torch.full_like(ls, rl - 1)
        fy_first = torch.where((ls == 0)[:, None], fy_w[:, 0],
                               old_flux_row(zero))
        fy_last = torch.where((ls + RW == rl)[:, None], fy_w[:, -1],
                              old_flux_row(last))
        halo_top, halo_bot = g.halo(fy_first, fy_last)
        top_row = torch.where((ls > 0)[:, None],
                              old_flux_row((ls - 1).clamp(min=0)), halo_top)
        bot_row = torch.where((ls + RW < rl)[:, None],
                              old_flux_row((ls + RW).clamp(max=rl - 1)),
                              halo_bot)
        fp = torch.cat([top_row[:, None], fy_w, bot_row[:, None]], dim=1)
        dy = (fp[:, 2:] - fp[:, :-2]) / res2
        g0 = (g.row0 + ls)[:, None]
        dy[:, 0] = torch.where(g0 == 0, (fy_w[:, 1] - fy_w[:, 0])
                               / self.resolution, dy[:, 0])
        dy[:, RW - 1] = torch.where(g0 + RW == H, (fy_w[:, -1] - fy_w[:, -2])
                                    / self.resolution, dy[:, -1])
        # columns are not sharded: block columns are >= 2 cells inside the
        # window except at a true domain edge, where one-sided applies
        dx = torch.zeros_like(fx_w)
        dx[:, :, 1:-1] = (fx_w[:, :, 2:] - fx_w[:, :, :-2]) / res2
        dx[:, :, 0] = torch.where((cs == 0)[:, None], (fx_w[:, :, 1]
                                  - fx_w[:, :, 0]) / self.resolution,
                                  dx[:, :, 0])
        dx[:, :, -1] = torch.where((cs + CW == W)[:, None], (fx_w[:, :, -1]
                                   - fx_w[:, :, -2]) / self.resolution,
                                   dx[:, :, -1])
        res_new_w = dx + dy + dhdt_w - smb_w

        # block cells alone are patched (the stale ring, chain_crf's
        # scheme).  The loss delta's sums: each block row's sum over the
        # window's columns, placed at its row of the block; a row lies in
        # one shard whole, so the grid's sum adds only zeros to each, and
        # the rows are then summed in one order whatever the layout.
        patch = in_block & (mcf_w > 0)
        sums = res_w.new_zeros((C, 2, B + 1))
        j = (gr - off_x[:, None]).clamp(0, B - 1)
        sums[:, 0, :B].scatter_add_(1, j, masked_sq_rows(res_new_w, patch))
        sums[:, 1, :B].scatter_add_(1, j, masked_sq_rows(res_w, patch))
        sums[:, 0, B] = (((surf_w - bed_new_w) <= 0.0) & in_block
                         & (upd_w > 0)).flatten(1).any(dim=1).to(sums.dtype)
        sums = g.sum(sums)
        delta = (row_sum(sums[:, 0, :B]) - row_sum(sums[:, 1, :B])) / (
            2.0 * self.sigma ** 2)
        viol = sums[:, 0, B] > 0
        loss_next = torch.where(viol, torch.full_like(delta, float("inf")),
                                loss + delta)
        accept = u <= torch.clamp(torch.exp(loss - loss_next), max=1.0)
        write = (accept & ~viol)[:, None, None]
        res_patched_w = torch.where(in_block, res_new_w, res_w)
        idx = (ci[:, None, None], r3, c3)
        bed[idx] = torch.where(write, bed_new_w, bed_w)
        res[idx] = torch.where(write, res_patched_w, res_w)
        # Kahan-compensated accumulation of accepted deltas (chain_crf's)
        y = torch.where(write[:, 0, 0], delta, 0.0) - comp
        t = loss + y
        return t, (t - loss) - y, accept

    def run(self, beds, n_iter: int, rng):
        """``n_iter`` steps from this rank's beds on the whole batch's
        ``rng``: (beds', losses (C, n_iter), steps (C, n_iter)).  An eager
        loop, not ``run_chains``' captured graph: every step's halo
        ``all_gather`` and row-sum ``all_reduce`` go through the host."""
        state, loss, comp = self.init(beds)
        n_iter = int(n_iter)
        C = state.shape[0]
        losses = torch.empty((C, n_iter), dtype=torch.float32,
                             device=self.device)
        steps = torch.empty((C, n_iter), dtype=torch.bool, device=self.device)
        for t in range(n_iter):
            f, w, h, cidx, u = self.draws(rng)
            if isinstance(rng, PerChainStreams):
                rng.advance()
            loss, comp, accept = self.step(state, loss, comp, f, w, h, cidx,
                                           u)
            losses[:, t] = loss
            steps[:, t] = accept
        return state[:, 0], losses, steps


def make_sharded_crf_chain(mesh: Mesh, static, grid_axis: str = "grid"):
    """Single-chain CRF sampler with the domain row-sharded over the
    ``grid`` axis: every rank draws the same proposal from ``rng`` (a
    generator seeded alike on every rank, or one chain's per-chain
    stream), patches its window and accepts on the loss delta summed
    over the grid.

    Returns ``run(bed, consts, n_iter, *, rng) -> (bed', losses (n_iter,),
    steps (n_iter,))`` on this rank's (rows_local, W) rows
    (``shard_grid_arrays``, ``shard_crf_consts``)."""
    _Grid(mesh, grid_axis, static.H)  # the rows must divide

    def run(bed, consts, n_iter: int, *, rng=None):
        crf = ShardedCRF(mesh, static, consts, 1, None, grid_axis)
        bed = torch.as_tensor(bed)
        beds, losses, steps = crf.run(bed[None], n_iter, rng)
        return beds[0], losses[0], steps[0]

    return run


def make_sharded_crf_chains(mesh: Mesh, static, chain_axis: str = "chains",
                            grid_axis: str = "grid"):
    """Chains x grid CRF sampler on one mesh: the chains sharded over
    ``chain_axis`` (no communication), each chain's domain row-sharded
    over ``grid_axis`` (the halo exchange and the loss sums).

    Returns ``run(beds, consts, n_iter, *, rng) -> (beds', losses (C,
    n_iter), steps (C, n_iter))``: ``beds`` this rank's (C, rows_local, W)
    block of the (n_chains, H, W) batch, ``rng`` the whole batch's (a
    generator seeded alike on every rank, or per-chain streams of every
    chain), everything returned this rank's."""
    _Grid(mesh, grid_axis, static.H)  # the rows must divide

    def run(beds, consts, n_iter: int, *, rng=None):
        beds = torch.as_tensor(beds)
        n_total = beds.shape[0] * _axis(mesh, chain_axis)[0]
        crf = ShardedCRF(mesh, static, consts, n_total, chain_axis,
                         grid_axis)
        return crf.run(beds, n_iter, rng)

    return run


__all__ = ["make_sharded_crf_chain", "make_sharded_crf_chains",
           "make_sharded_residual", "make_sharded_loss", "shard_grid_arrays",
           "shard_crf_consts", "ShardedCRF"]
