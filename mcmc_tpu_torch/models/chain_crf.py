"""Large-scale MCMC chain with random-field block proposals, batched.

PyTorch counterpart of ``mcmc_tpu/models/chain_crf.py`` (the reference's
``chain_crf``, MCMC.py:1083-1443).  The algorithm is the same:

- Block proposals come from one (B, B) spectral FFT per chain; the discrete
  size menu is handled by masks.
- The block centre is drawn uniformly over the precomputed region cells.
- Residual and loss updates are block-local: the fused window op
  (``ops/window_kernel.py``) recomputes the numpy-gradient residual on the
  block, sums the loss delta there, MH-accepts, and patches only block
  cells into the state, leaving the one-cell ring outside the block stale
  exactly as the reference's incremental scheme does (MCMC.py:1292-1315).
- Window invariant: with S = B + 4 and the window start clip(bxmin - 1, 0,
  H - S), every patched cell is interior to the window or lies on a true
  domain edge that coincides with the window edge, so the windowed
  gradient equals the global one.  ``ChainCRF.build`` asserts S >= B + 4.
- The loss is accumulated by Kahan-compensated summation of the accepted
  deltas; the MH decision uses the freshly computed delta.

PyTorch idiom: every function works on a leading chain dimension (the JAX
package ``vmap``s a single-chain step), the draws come from one explicit
``torch.Generator``, and the state's ``fields`` tensor is updated IN PLACE
by each step (the Pallas kernel aliases it the same way).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.distance import min_dist_from_mask
from ..ops.logistic import crf_weight_from_dist
from ..ops.physics import masked_gaussian_loss, mass_conservation_residual
from ..ops.spectral import half_spectrum_noise, spectral_field_from_noise
from ..ops.window_kernel import (fused_window_update,
                                 fused_window_update_reference,
                                 window_geometry)
from ..utils.config import (BlockMenuConfig, LossConfig, RandFieldConfig,
                            WeightConfig)
from ..utils.rng import resolve_seed
from .randfield import (RandFieldArrays, RandFieldStatic, build_randfield,
                        draw_block_params, finish_block)

IMPLS = ("auto", "eager", "fused")


@dataclasses.dataclass(frozen=True)
class CRFStatic:
    """Plain-value configuration of a built chain."""

    H: int
    W: int
    S: int          # local window size, min(H, W, B + 4)
    n_region: int   # number of candidate block-centre cells
    P: int          # number of probe points
    rf: RandFieldStatic
    use_data_loss: bool = False


@dataclasses.dataclass
class CRFConsts:
    """Per-problem constants on the chain's device, shared by all chains.

    ``stacked`` is (8, H, W) float32 in the JAX package's plane order:
    surf, velx, vely, forcing (= dhdt - smb), maskpack (= update_mask +
    2 * mc_mask), crf_weight, cond_bed (NaN -> 0), data_loss_mask.  The
    data-loss planes sit last so the window op reads only 6 planes when
    the data loss is off.
    """

    stacked: torch.Tensor      # (8, H, W) float32
    region_cells: torch.Tensor  # (n_region, 2) int64 candidate centres
    sample_ij: torch.Tensor    # (P, 2) int64 probe cells
    sigma_mc: float
    sigma_data: float
    resolution: float
    rf: RandFieldArrays

    @property
    def surf(self):
        return self.stacked[0]

    @property
    def velx(self):
        return self.stacked[1]

    @property
    def vely(self):
        return self.stacked[2]

    @property
    def forcing(self):
        """dhdt - smb (the residual uses only the difference)."""
        return self.stacked[3]

    @property
    def update_mask(self):
        return torch.remainder(self.stacked[4], 2.0)

    @property
    def mc_mask(self):
        return self.stacked[4] >= 2.0

    @property
    def crf_weight(self):
        return self.stacked[5]

    @property
    def cond_bed_filled(self):
        return self.stacked[6]

    @property
    def data_loss_mask(self):
        return self.stacked[7] > 0


@dataclasses.dataclass
class ChainState:
    """State of a batch of chains; every tensor has a leading chain axis.

    The three mutable planes (bed, patched residual, resample counter) are
    stacked in one (N, 3, H, W) tensor that the window op updates in place.
    """

    fields: torch.Tensor          # (N, 3, H, W): bed, mc_res, resampled
    loss_mc: torch.Tensor         # (N,)
    loss_comp: torch.Tensor       # Kahan compensation
    loss_data: torch.Tensor       # (N,), 0 unless use_data_loss
    loss_data_comp: torch.Tensor
    accepted: torch.Tensor        # (N,) int32

    @property
    def bed(self):
        return self.fields[:, 0]

    @property
    def mc_res(self):
        return self.fields[:, 1]

    @property
    def resampled(self):
        return self.fields[:, 2]


@dataclasses.dataclass
class Draws:
    """One step's random draws for every chain (the injection seam that
    parity tests fill with numpy draws)."""

    noise: torch.Tensor      # (N, B, B//2+1) complex64 half-spectrum noise
    size_idx: torch.Tensor   # (N,) int64 block-menu index
    scale: torch.Tensor      # (N,) float32, already divided by 3
    range_x: torch.Tensor    # (N,) float32
    range_y: torch.Tensor    # (N,) float32
    cidx: torch.Tensor       # (N,) int64 index into region_cells
    u: torch.Tensor          # (N,) float32 MH uniform
    nug: Optional[torch.Tensor] = None           # (N,), nugget configs only
    nugget_noise: Optional[torch.Tensor] = None  # (N, B, B)


def init_state(beds, consts: CRFConsts, n_chains: Optional[int] = None
               ) -> ChainState:
    """Fresh chain states: full-grid residual and loss (reference
    MCMC.py:1184-1195).  ``beds`` is (N, H, W), or one (H, W) bed shared by
    ``n_chains`` chains (computed once, then copied per chain)."""
    device = consts.stacked.device
    beds = torch.as_tensor(beds, dtype=torch.float32, device=device)
    shared = beds.dim() == 2
    bed = beds[None] if shared else beds
    mc_res = mass_conservation_residual(
        bed, consts.surf, consts.velx, consts.vely, consts.forcing, 0.0,
        consts.resolution)
    loss_mc = masked_gaussian_loss(mc_res, consts.mc_mask, consts.sigma_mc)
    loss_data = masked_gaussian_loss(bed - consts.cond_bed_filled,
                                     consts.data_loss_mask,
                                     max(consts.sigma_data, 1e-9))
    fields = torch.stack([bed, mc_res, torch.zeros_like(bed)], dim=1)
    if shared:
        n = 1 if n_chains is None else int(n_chains)
        fields = fields.expand(n, -1, -1, -1).contiguous()
        loss_mc = loss_mc.expand(n).contiguous()
        loss_data = loss_data.expand(n).contiguous()
    n = fields.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    return ChainState(fields=fields, loss_mc=loss_mc.to(torch.float32),
                      loss_comp=zeros, loss_data=loss_data.to(torch.float32),
                      loss_data_comp=zeros.clone(),
                      accepted=torch.zeros(n, dtype=torch.int32,
                                           device=device))


def draw(gen: torch.Generator, static: CRFStatic, consts: CRFConsts,
         n: int) -> Draws:
    """One step's draws for ``n`` chains from ``gen``."""
    B = static.rf.B
    device = consts.stacked.device
    size_idx, scale, nug, range_x, range_y = draw_block_params(
        gen, n, static.rf, consts.rf)
    noise = half_spectrum_noise(gen, n, (B, B), device)
    nugget_noise = None
    if static.rf.has_nugget:
        nugget_noise = torch.randn((n, B, B), generator=gen, device=device)
    cidx = torch.randint(0, static.n_region, (n,), generator=gen,
                         device=device)
    u = torch.rand((n,), generator=gen, device=device)
    return Draws(noise=noise, size_idx=size_idx, scale=scale,
                 range_x=range_x, range_y=range_y, cidx=cidx, u=u,
                 nug=nug if static.rf.has_nugget else None,
                 nugget_noise=nugget_noise)


def propose(static: CRFStatic, consts: CRFConsts, d: Draws):
    """The proposal fields for the window op: raw spectral fields, which
    the op finishes itself, or, with a nugget, fields finished here."""
    rf = static.rf
    raw = spectral_field_from_noise(d.noise, (rf.B, rf.B), rf.resolution,
                                    rf.model_name, d.range_x, d.range_y,
                                    rf.smoothness)
    if not rf.has_nugget:
        return raw
    return finish_block(raw, d.size_idx, d.scale, consts.rf,
                        d.nugget_noise, d.nug)


def window_operands(static: CRFStatic, consts: CRFConsts, state: ChainState,
                    size_idx, scale, cx, cy, u):
    """The window op's per-chain rows: ``geom`` (N, 9) int32 and ``fvals``
    (N, 6) float32 [u, loss_prev, sigma_mc, resolution, sigma_data,
    scale]."""
    w = consts.rf.pairs[0, size_idx]
    h = consts.rf.pairs[1, size_idx]
    geom = window_geometry(cx, cy, h, w, size_idx, static.H, static.W)
    loss_prev = state.loss_mc + state.loss_data
    fvals = torch.stack([
        u.to(torch.float32), loss_prev,
        torch.full_like(loss_prev, consts.sigma_mc),
        torch.full_like(loss_prev, consts.resolution),
        torch.full_like(loss_prev, consts.sigma_data),
        scale.to(torch.float32)], dim=1)
    return geom, fvals


def make_kernel(static: CRFStatic, impl: str = "auto"):
    """Build the batched MH update core, the parity seam:
    ``(consts, state, f, size_idx, scale, cx, cy, u) -> (state, trace)``.

    ``f`` holds raw spectral fields (finished by the window op) or, when
    the configuration has a nugget, finished fields.  ``impl`` "auto" or
    "fused" runs the dispatcher (the CUDA kernel for CUDA tensors, the
    plain version for CPU ones); "eager" always runs the plain version.
    ``state.fields`` is updated in place."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    window_op = (fused_window_update_reference if impl == "eager"
                 else fused_window_update)
    prefinished = static.rf.has_nugget

    def mh_update(consts: CRFConsts, state: ChainState, f, size_idx, scale,
                  cx, cy, u):
        n = state.fields.shape[0]
        geom, fvals = window_operands(static, consts, state, size_idx, scale,
                                      cx, cy, u)
        h, w = geom[:, 6], geom[:, 7]
        acc, delta, delta_data = window_op(
            consts.stacked, state.fields, f.contiguous(),
            consts.rf.edge_masks, geom, fvals,
            use_data_loss=static.use_data_loss, prefinished=prefinished)
        accept = acc > 0

        # Kahan-compensated loss accumulation (deltas are zero unless the
        # chain accepted)
        y = delta - state.loss_comp
        t = state.loss_mc + y
        comp = (t - state.loss_mc) - y
        yd = delta_data - state.loss_data_comp
        td = state.loss_data + yd
        comp_d = (td - state.loss_data) - yd

        new_state = ChainState(fields=state.fields, loss_mc=t, loss_comp=comp,
                               loss_data=td, loss_data_comp=comp_d,
                               accepted=state.accepted + accept.to(torch.int32))
        trace = {
            "loss_mc": t,
            "loss_data": td,
            "loss": t + td,
            "step": accept,
            "block": torch.stack([cx.to(torch.float32), cy.to(torch.float32),
                                  h.to(torch.float32), w.to(torch.float32)],
                                 dim=1),
            "samples": sample_probes(state.fields[:, 0], consts.sample_ij,
                                     n),
        }
        return new_state, trace

    return mh_update


def sample_probes(beds, sample_ij, n):
    """(n, P) bed values at the probe cells."""
    if sample_ij.shape[0] == 0:
        return beds.new_zeros((n, 0))
    return beds[:, sample_ij[:, 0], sample_ij[:, 1]]


def make_step(static: CRFStatic, impl: str = "auto"):
    """Build the full batched MH step: ``(consts, state, gen) -> (state,
    trace)`` (draws, spectral proposal, window op, ledger, trace)."""
    mh_update = make_kernel(static, impl)

    def step(consts: CRFConsts, state: ChainState, gen: torch.Generator):
        d = draw(gen, static, consts, state.fields.shape[0])
        cx = consts.region_cells[d.cidx, 0]
        cy = consts.region_cells[d.cidx, 1]
        return mh_update(consts, state, propose(static, consts, d),
                         d.size_idx, d.scale, cx, cy, d.u)

    return step


def chain_loss_mc(massConvResidual, mc_region_mask, sigma_mc) -> float:
    """The reference chain-base mass-conservation loss (MCMC.py:1021-1044):
    nansum of squared residuals over the mc region / (2 sigma^2)."""
    res = np.asarray(massConvResidual, np.float64)
    return float(np.nansum(np.square(res[np.asarray(mc_region_mask) == 1]))
                 / (2.0 * float(sigma_mc) ** 2))


class ChainCRF:
    """Host-side builder with the reference's imperative API surface.

    Mirrors ``chain_crf``'s setters (set_update_region / set_loss_type /
    set_update_type / set_crf_data_weight / set_random_generator /
    set_sample_points_locations), then ``build(device)`` produces the
    (CRFStatic, CRFConsts) pair that ``parallel.sampler`` runs.  The
    single-chain ``run`` convenience is not ported yet.
    """

    def __init__(self, xx, yy, initial_bed, surf, velx, vely, dhdt, smb,
                 cond_bed, data_mask, grounded_ice_mask, resolution):
        shapes = {np.shape(a) for a in
                  (initial_bed, surf, velx, vely, dhdt, smb, cond_bed,
                   data_mask)}
        if len(shapes) != 1:
            raise ValueError(
                "the shape of bed, surf, velx, vely, dhdt, smb, radar_bed, "
                "data_mask need to be same")
        self.xx = np.asarray(xx)
        self.yy = np.asarray(yy)
        self.initial_bed = np.asarray(initial_bed, np.float32)
        self.surf = np.asarray(surf, np.float32)
        self.velx = np.asarray(velx, np.float32)
        self.vely = np.asarray(vely, np.float32)
        self.dhdt = np.asarray(dhdt, np.float32)
        self.smb = np.asarray(smb, np.float32)
        self.cond_bed = np.asarray(cond_bed, np.float32)
        self.data_mask = np.asarray(data_mask)
        self.grounded_ice_mask = np.asarray(grounded_ice_mask)
        self.resolution = float(resolution)
        self.update_in_region = False
        self.region_mask = np.ones(self.xx.shape, np.float32)
        self.mc_region_mask = np.ones(self.xx.shape, np.float32)
        self.block_type = "RF"
        self.crf_data_weight = None
        self.sample_loc = None
        self.sigma_mc = None
        self.sigma_data = 1.0
        self.use_data_loss = False
        self.data_region_mask = np.ones(self.xx.shape, np.float32)
        self.seed = None
        self._rf_cfg = None
        self._block_cfg = None
        self._weight_cfg = None

    # --- reference-parity setters ------------------------------------------

    def set_update_region(self, update_in_region, region_mask=None):
        """Restrict proposals and updates to ``region_mask`` cells
        (reference chain.set_update_region, MCMC.py:849-872)."""
        self.update_in_region = bool(update_in_region)
        if not update_in_region:
            self.region_mask = np.ones(self.xx.shape, np.float32)
        else:
            region_mask = np.asarray(region_mask)
            if region_mask.shape != self.xx.shape:
                raise ValueError(
                    "the region_mask input is invalid. It has to be a 2D "
                    "numpy array with the shape of the map")
            self.region_mask = region_mask.astype(np.float32)

    def set_loss_type(self, sigma_mc=-1, massConvInRegion=True,
                      diff_func=None, sigma_data=-1,
                      dataDiffInRegion=False):
        """Configure the loss: the Gaussian mass-conservation term, plus
        with ``diff_func='sumsquare'`` the Gaussian radar-misfit term
        sum((bed - cond_bed)^2) / (2 sigma_data^2) over data cells."""
        cfg = LossConfig(sigma_mc=sigma_mc,
                         mass_conv_in_region=massConvInRegion,
                         sigma_data=sigma_data)
        self.sigma_mc = cfg.sigma_mc
        self.mc_region_mask = (self.region_mask if massConvInRegion
                               else np.ones(self.xx.shape, np.float32))
        if diff_func is None:
            self.use_data_loss = False
            self.sigma_data = 1.0
        elif diff_func == "sumsquare":
            if sigma_data <= 0:
                raise ValueError(
                    "please make sure sigma is correctly set for sigma_data")
            self.use_data_loss = True
            self.sigma_data = float(sigma_data)
            self.data_region_mask = (self.region_mask if dataDiffInRegion
                                     else np.ones(self.xx.shape, np.float32))
        else:
            raise ValueError(
                "diff_func must be None or 'sumsquare' (the reference's "
                "other aggregators are dead code, MCMC.py:986-1012)")

    def set_update_type(self, block_type):
        """Proposal family: 'RF' (plain blocks) or 'CRF_weight'
        (logistic-data-weighted blocks); 'CRF_rbf' raises like the
        reference (MCMC.py:1098-1122)."""
        if block_type not in ("CRF_weight", "RF", "CRF_rbf"):
            raise ValueError(
                "The block_type argument should be one of the following: "
                "CRF_weight, CRF_rbf, RF")
        if block_type == "CRF_rbf":
            raise NotImplementedError(
                "CRF_rbf is unimplemented in the reference as well "
                "(MCMC.py:1111)")
        self.block_type = block_type

    def set_crf_data_weight(self, weight=None,
                            weight_cfg: Optional[WeightConfig] = None):
        """Compute (or set) the logistic conditioning weight from the exact
        Euclidean distance to the data cells (host numpy)."""
        if weight is not None:
            self.crf_data_weight = np.asarray(weight, np.float32)
            return
        wc = weight_cfg or self._weight_cfg
        if wc is None:
            raise ValueError("call configure_randfield first or pass "
                             "weight_cfg")
        if not np.any(self.data_mask == 1):
            raise ValueError(
                "data_mask has no conditioning cells: the CRF data weight "
                "would be zero everywhere (a frozen chain). Use "
                "block_type='RF' for unconditional proposals, or pass an "
                "explicit weight array.")
        dist = min_dist_from_mask(self.xx, self.yy, self.data_mask == 1)
        weight, _, _ = crf_weight_from_dist(torch.from_numpy(dist), wc.L,
                                            wc.x0, wc.k, wc.offset,
                                            wc.max_dist)
        self.crf_data_weight = weight.numpy().astype(np.float32)

    def loss(self, massConvResidual, dataDiff=0):
        """Loss of a candidate topography (reference MCMC.py:1021-1044).
        Returns (total_loss, loss_mc, loss_data)."""
        if self.sigma_mc is None:
            raise ValueError("call set_loss_type before loss()")
        loss_mc = chain_loss_mc(massConvResidual, self.mc_region_mask,
                                self.sigma_mc)
        loss_data = 0.0
        if self.use_data_loss and np.ndim(dataDiff):
            dd = np.asarray(dataDiff, np.float64)
            m = ((np.asarray(self.data_mask) == 1)
                 & (self.data_region_mask == 1))
            loss_data = float(np.nansum(np.square(dd[m]))
                              / (2.0 * self.sigma_data ** 2))
        return loss_mc + loss_data, loss_mc, loss_data

    def set_random_generator(self, rng_seed=None):
        """Seed for the samplers built from this chain (an int, or None
        for fresh entropy)."""
        self.seed = resolve_seed(rng_seed)

    def set_sample_points_locations(self, loc):
        """(n, 2) (x, y) posterior probe points traced every iteration
        (reference MCMC.py:1068-1081; nearest-cell lookup)."""
        self.sample_loc = None if loc is None else np.asarray(loc)

    def configure_randfield(self, rf_cfg: RandFieldConfig,
                            block_cfg: BlockMenuConfig,
                            weight_cfg: WeightConfig):
        """Attach the proposal engine's typed configs."""
        self._rf_cfg = rf_cfg
        self._block_cfg = block_cfg
        self._weight_cfg = weight_cfg

    # --- building -----------------------------------------------------------

    def _sample_ij(self):
        if self.sample_loc is None:
            return np.zeros((0, 2), np.int64)
        ij = np.zeros((self.sample_loc.shape[0], 2), np.int64)
        for k in range(self.sample_loc.shape[0]):
            ij[k, 0] = int(np.argmin(np.abs(self.yy[:, 0]
                                            - self.sample_loc[k, 1])))
            ij[k, 1] = int(np.argmin(np.abs(self.xx[0, :]
                                            - self.sample_loc[k, 0])))
        return ij

    def build(self, device="cpu"):
        """The configured chain as (CRFStatic, CRFConsts) on ``device``."""
        if self.sigma_mc is None:
            raise ValueError("call set_loss_type before building the chain")
        if self._rf_cfg is None:
            raise ValueError("call configure_randfield before building the "
                             "chain")
        device = torch.device(device)
        rf_static, rf_arrays = build_randfield(
            self._rf_cfg, self._block_cfg, self._weight_cfg, device)
        H, W = self.xx.shape
        S = int(min(H, W, rf_static.B + 4))
        if S < rf_static.B + 4 and (H > S or W > S):
            raise ValueError("grid too small for the configured block sizes")

        update_mask = (self.region_mask if self.update_in_region
                       else self.grounded_ice_mask.astype(np.float32))
        region = (np.argwhere(self.region_mask == 1) if self.update_in_region
                  else np.argwhere(np.ones(self.xx.shape, bool)))
        if region.shape[0] == 0:
            raise ValueError("region_mask selects no cells")

        if self.block_type == "CRF_weight":
            if self.crf_data_weight is None:
                self.set_crf_data_weight()
            crf_weight = self.crf_data_weight
        else:
            crf_weight = np.ones(self.xx.shape, np.float32)

        sample_ij = self._sample_ij()
        static = CRFStatic(H=H, W=W, S=S, n_region=int(region.shape[0]),
                           P=int(sample_ij.shape[0]), rf=rf_static,
                           use_data_loss=bool(self.use_data_loss))
        cond_filled = np.nan_to_num(self.cond_bed, nan=0.0)
        if self.use_data_loss:
            data_loss_mask = (np.asarray(self.data_mask, bool)
                              & np.isfinite(self.cond_bed)
                              & (self.data_region_mask > 0))
        else:
            data_loss_mask = np.zeros(self.xx.shape, bool)
        stacked = np.stack([
            self.surf, self.velx, self.vely,
            np.asarray(self.dhdt, np.float64) - np.asarray(self.smb,
                                                           np.float64),
            ((np.asarray(update_mask) > 0).astype(np.float32)
             + 2.0 * np.asarray(self.mc_region_mask == 1, np.float32)),
            np.asarray(crf_weight, np.float32),
            np.asarray(cond_filled, np.float32),
            np.asarray(data_loss_mask, np.float32),
        ]).astype(np.float32)
        consts = CRFConsts(
            stacked=torch.as_tensor(stacked, device=device),
            region_cells=torch.as_tensor(region, dtype=torch.int64,
                                         device=device),
            sample_ij=torch.as_tensor(sample_ij, dtype=torch.int64,
                                      device=device),
            sigma_mc=float(self.sigma_mc),
            sigma_data=float(self.sigma_data),
            resolution=float(self.resolution),
            rf=rf_arrays)
        return static, consts
