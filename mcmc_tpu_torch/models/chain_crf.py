"""Large-scale MCMC chain with random-field block proposals, batched.

PyTorch counterpart of ``mcmc_tpu/models/chain_crf.py`` (the reference's
``chain_crf``, MCMC.py:1083-1443).  The algorithm is the same:

- Block proposals come from one (B, B) spectral FFT per chain or, with
  the gstools-SRF method (``spectral=False``), one (B, B) sum of 1000
  harmonics per chain (``ops/srf.py``, the SRF kernel); the discrete size
  menu is handled by masks.
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
``torch.Generator`` or, for a farm seeded with a list of per-chain seeds,
from per-chain streams (``utils/rng.PerChainStreams``: one launch of the
step's draw plan and one of the keyed noise, chain i's draws depending on
its own seed alone), and the state's ``fields`` tensor is updated IN PLACE
by each step (the Pallas kernel aliases it the same way).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..ops.chain_draws import cached_plan, draw_plan, entry
from ..ops.distance import min_dist_from_mask
from ..ops.logistic import crf_weight_from_dist
from ..ops.physics import masked_gaussian_loss, mass_conservation_residual
from ..ops.spectral import half_spectrum_noise, spectral_field_from_noise
from ..ops.srf import (draw_srf, sample_wavevectors, srf_draws_from,
                       srf_entries, srf_field)
from ..ops.window_kernel import (fused_window_update,
                                 fused_window_update_reference,
                                 window_geometry)
from ..utils.config import (BlockMenuConfig, LossConfig, RandFieldConfig,
                            WeightConfig)
from ..utils.rng import (PerChainStreams, RowSlice, draw_rows, is_seed_list,
                         resolve_device, resolve_seed)
from ..utils.spans import span
from .randfield import (RandFieldArrays, RandFieldStatic,
                        block_param_entries, block_params_from,
                        build_randfield, draw_block_params, finish_block,
                        finish_block_srf)

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
    parity tests fill with numpy draws).  The spectral method draws
    ``noise``; the gstools-SRF method (``spectral=False``) draws
    ``wave_u``, ``wave_theta``, ``z1``, ``z2`` and, anisotropic,
    ``angle`` (``ops/srf.py``) instead."""

    size_idx: torch.Tensor   # (N,) int64 block-menu index
    scale: torch.Tensor      # (N,) float32, already divided by 3
    range_x: torch.Tensor    # (N,) float32
    range_y: torch.Tensor    # (N,) float32
    cidx: torch.Tensor       # (N,) int64 index into region_cells
    u: torch.Tensor          # (N,) float32 MH uniform
    noise: Optional[torch.Tensor] = None  # (N, B, B//2+1) complex64
    nug: Optional[torch.Tensor] = None           # (N,), nugget configs only
    nugget_noise: Optional[torch.Tensor] = None  # (N, B, B)
    wave_u: Optional[torch.Tensor] = None      # (N, 1000) radius uniforms
    wave_theta: Optional[torch.Tensor] = None  # (N, 1000) angle uniforms
    z1: Optional[torch.Tensor] = None          # (N, 1000) cosine normals
    z2: Optional[torch.Tensor] = None          # (N, 1000) sine normals
    angle: Optional[torch.Tensor] = None       # (N,) azimuth, anisotropic


def init_state(bed, consts: CRFConsts, n_chains: Optional[int] = None
               ) -> ChainState:
    """Fresh chain states: full-grid residual and loss (reference
    MCMC.py:1184-1195).  ``bed`` is (N, H, W), or one (H, W) bed shared by
    ``n_chains`` chains (computed once, then copied per chain).  The
    reference's ``init_state(bed, key, consts)`` has a key in second
    place; the port's states carry none (their random source is the
    runner's ``rng``), so a second argument that is not a ``CRFConsts``
    raises a TypeError naming this form."""
    if not isinstance(consts, CRFConsts):
        raise TypeError("init_state(bed, consts, n_chains=None): consts "
                        "must be a CRFConsts (the port's chain state "
                        f"carries no key); got {type(consts).__name__}")
    device = consts.stacked.device
    beds = torch.as_tensor(bed, dtype=torch.float32, device=device)
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


def draw_plan_entries(static: CRFStatic):
    """A seed-listed CRF step's draw plan: the block's size index and
    variogram parameters, the centre index, the MH uniform, with a
    nugget the (B, B) nugget normals and, by the gstools-SRF method, the
    SRF draws (``ops/srf.srf_entries``); the spectral method's
    half-spectrum noise is the keyed noise kernel's."""
    B = static.rf.B
    nugget = ((entry("nugget_noise", "normal", B * B),)
              if static.rf.has_nugget else ())
    srf = () if static.rf.spectral else srf_entries(static.rf.isotropic)
    return (block_param_entries(static.rf)
            + (entry("cidx", "index", n=static.n_region),
               entry("u", "uniform")) + nugget + srf)


def draw(gen, static: CRFStatic, consts: CRFConsts, n: int,
         impl: str = "auto") -> Draws:
    """One step's draws for ``n`` chains from ``gen``, a generator or
    per-chain streams (``draw_plan_entries``).  The spectral method's
    half-spectrum noise comes from the Philox kernel, or its plain
    version under ``impl="eager"`` (``ops/spectral.half_spectrum_noise``),
    as do the per-chain draws.  From a generator the order is: the size
    index and variogram parameters (``draw_block_params``), then the
    half-spectrum noise's seed or, by the gstools-SRF method, the SRF
    draws (``ops/srf.draw_srf``), then the nugget normals (with a
    nugget), the centre index and the MH uniform.  From a ``RowSlice``
    (a rank of a sharded int-seeded farm): the whole farm's draws from its
    generator, cut to its rows."""
    if isinstance(gen, RowSlice):
        return draw_rows(draw(gen.generator, static, consts, gen.n_total,
                              impl), gen.lo, gen.hi)
    B = static.rf.B
    device = consts.rf.pairs.device
    srf = {}
    noise = None
    if isinstance(gen, PerChainStreams):
        if gen.n_chains != n:
            raise ValueError(f"{gen.n_chains} per-chain streams for {n} "
                             "chains")
        d = draw_plan(gen, cached_plan(draw_plan_entries(static)), impl)
        size_idx, scale, nug, range_x, range_y = block_params_from(
            d, static.rf, consts.rf)
        if static.rf.spectral:
            noise = half_spectrum_noise(gen, n, (B, B), device, impl)
        else:
            srf = srf_draws_from(d, static.rf.isotropic)
        nugget_noise = (d["nugget_noise"].view(n, B, B)
                        if static.rf.has_nugget else None)
        cidx, u = d["cidx"][:, 0], d["u"][:, 0]
    else:
        size_idx, scale, nug, range_x, range_y = draw_block_params(
            gen, n, static.rf, consts.rf)
        if static.rf.spectral:
            noise = half_spectrum_noise(gen, n, (B, B), device, impl)
        else:
            srf = draw_srf(gen, n, static.rf.isotropic, device)
        nugget_noise = None
        if static.rf.has_nugget:
            nugget_noise = torch.randn((n, B, B), generator=gen,
                                       device=device)
        cidx = torch.randint(0, static.n_region, (n,), generator=gen,
                             device=device)
        u = torch.rand((n,), generator=gen, device=device)
    if srf:
        srf = dict(zip(("wave_u", "wave_theta", "z1", "z2", "angle"), srf))
    return Draws(noise=noise, size_idx=size_idx, scale=scale,
                 range_x=range_x, range_y=range_y, cidx=cidx, u=u,
                 nug=nug if static.rf.has_nugget else None,
                 nugget_noise=nugget_noise, **srf)


def propose(static: CRFStatic, consts: CRFConsts, d: Draws,
            impl: str = "auto"):
    """The proposal fields for the window op.  Spectral: raw fields, which
    the op finishes itself, or, with a nugget, fields finished here.
    gstools-SRF: fields finished here (``finish_block_srf``), their
    harmonic sum the SRF kernel's, or its plain version under
    ``impl="eager"``."""
    rf = static.rf
    if not rf.spectral:
        kv = sample_wavevectors(d.wave_u, d.wave_theta, rf.model_name,
                                d.range_x, d.range_y, rf.smoothness,
                                d.angle)
        raw = srf_field(kv, d.z1, d.z2, (rf.B, rf.B), rf.resolution, impl)
        return finish_block_srf(raw, d.size_idx, d.scale, consts.rf,
                                d.nugget_noise, d.nug)
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
    the configuration has a nugget or takes the gstools-SRF method,
    finished fields (JAX ``chain_crf.py:383``).  ``impl`` "auto" or
    "fused" runs the dispatcher (the CUDA kernel for CUDA tensors, the
    plain version for CPU ones); "eager" always runs the plain version.
    ``state.fields`` is updated in place."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    window_op = (fused_window_update_reference if impl == "eager"
                 else fused_window_update)
    prefinished = static.rf.has_nugget or not static.rf.spectral

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


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that shares no memory with it (on the CPU,
    ``.numpy()`` alone would alias a state the next step updates in
    place).  A device tensor's copy waits for the work that writes it."""
    with span("mcmc.host_copy"):
        return t.to("cpu", copy=True).numpy()


def sample_probes(beds, sample_ij, n):
    """(n, P) bed values at the probe cells."""
    if sample_ij.shape[0] == 0:
        return beds.new_zeros((n, 0))
    return beds[:, sample_ij[:, 0], sample_ij[:, 1]]


def make_step(static: CRFStatic, impl: str = "auto"):
    """Build the full batched MH step: ``(consts, state, gen) -> (state,
    trace)`` (draws, proposal, window op, ledger, trace), ``gen`` a
    generator or per-chain streams (``draw``; the caller advances the
    streams' step).  The draws' half-spectrum noise comes from the Philox
    kernel (``ops/noise_kernel.py``), a gstools-SRF proposal's harmonic
    sum from the SRF kernel (``ops/srf_kernel.py``), and under
    ``impl="eager"`` each from its plain version, like the window op."""
    mh_update = make_kernel(static, impl)

    def step(consts: CRFConsts, state: ChainState, gen):
        d = draw(gen, static, consts, state.fields.shape[0], impl)
        cx = consts.region_cells[d.cidx, 0]
        cy = consts.region_cells[d.cidx, 1]
        return mh_update(consts, state, propose(static, consts, d, impl),
                         d.size_idx, d.scale, cx, cy, d.u)

    return step


def chain_loss_mc(massConvResidual, mc_region_mask, sigma_mc) -> float:
    """The reference chain-base mass-conservation loss (MCMC.py:1021-1044):
    nansum of squared residuals over the mc region / (2 sigma^2)."""
    res = np.asarray(massConvResidual, np.float64)
    return float(np.nansum(np.square(res[np.asarray(mc_region_mask) == 1]))
                 / (2.0 * float(sigma_mc) ** 2))


def single_chain_farm(chain, seed, device):
    """The one-chain farm behind ``ChainCRF.run`` / ``ChainSGS.run``: a
    ``MultiChainSampler`` of 1 chain on ``device`` and its initial state.

    The chain is seeded as the per-chain stream of ``[seed]``
    (``utils/rng.PerChainStreams``), so its draws are bitwise chain 0's in
    any list-seeded farm whose first seed is ``seed``, on the CPU and the
    card alike.  ``seed=None`` continues the stream of the chain's last
    ``run``, else takes the ``set_random_generator`` seed (a list: its
    first), else fresh entropy.  The stream stays on the chain."""
    from ..parallel.sampler import MultiChainSampler

    sampler = MultiChainSampler(chain, 1, use_mesh=False, device=device)
    streams = chain._streams if seed is None else None
    if streams is None:
        seed = chain.seed if seed is None else seed
        seeds = seed if is_seed_list(seed) else [resolve_seed(seed)]
        state = sampler.init(seeds=resolve_seed(seeds, 1))
    else:
        state = sampler.init(seeds=[0])
        sampler.generator = PerChainStreams(
            keys=streams.keys.to(sampler.device),
            step=streams.step.to(sampler.device))
    chain._streams = sampler.generator
    return sampler, state


RUN_CHAIN_FORM = ("run_chain(static, consts, state, n_iter, save_beds=False, "
                  "*, rng)")


def run_chain(static: CRFStatic, consts: CRFConsts, state: ChainState,
              n_iter: int, save_beds: bool = False, *, rng=None):
    """``n_iter - 1`` MH steps of one chain (iteration 0 records the
    initial state, as in the reference loop ``for i in range(1, n_iter)``,
    MCMC.py:1247), the reference's ``run_chain``
    (``mcmc_tpu/models/chain_crf.py:678``) with its arguments in its
    order.  ``state`` holds one chain (a leading axis of 1, as
    ``init_state(bed, consts)`` gives); ``rng`` (keyword-only, required)
    is a ``torch.Generator`` or per-chain streams, in place of the key the
    reference's state carries.  The kernels run for CUDA tensors, their
    plain versions for CPU ones.  Returns
    (final_state, traces): device traces with leading dim ``n_iter`` and
    no chain axis, index 0 holding the initial values; ``save_beds`` adds
    ``traces["bed"]``, (n_iter, H, W) beds."""
    from ..parallel.sampler import run_one_chain

    if not isinstance(static, CRFStatic):
        raise TypeError(f"{RUN_CHAIN_FORM}: static must be a CRFStatic, "
                        f"got {type(static).__name__}")
    return run_one_chain(static, consts, state, n_iter, save_beds, rng,
                         "auto", RUN_CHAIN_FORM)


def _run_segmented(run_fn, state, n_iter: int, info_per_iter: int,
                   progress_bar: bool, plot: bool):
    """Run ``run_fn(state, n_rows) -> (state, time-major traces)`` either in
    one segment (no observers) or in ``info_per_iter``-step segments with
    the reference's progress line / live figure (MCMC.py:1368-1432).  A
    segment's row 0 duplicates the carried state and is dropped on
    continuation segments, so the stitched traces equal the one-segment
    ones bit for bit."""
    if not (progress_bar or plot):
        return run_fn(state, n_iter)
    live = None
    if plot:
        from ..utils.plotting import LiveChainPlot

        live = LiveChainPlot()
    total_steps = int(n_iter) - 1
    # observers always get at least one update, even for short runs
    # (MCMC.py:1379,1415)
    seg = max(1, min(int(info_per_iter), max(total_steps, 1)))
    steps_left = total_steps
    chunks = []
    first = True
    t0 = time.time()
    done_steps = 0
    acc0 = int(state.accepted.sum())
    while steps_left > 0 or first:
        s = min(seg, steps_left)
        state, tr = run_fn(state, s + 1)
        keep = tr if first else {k: v[1:] for k, v in tr.items()}
        chunks.append(keep)
        steps_left -= s
        done_steps += s
        loss_now = float((state.loss_mc
                          + getattr(state, "loss_data", 0.0)).sum())
        # cumulative acceptance like the reference (sum(step)/(i+1),
        # MCMC.py:1406), from the state's accepted counter
        acc = (int(state.accepted.sum()) - acc0) / max(done_steps, 1)
        if progress_bar:
            rate = done_steps / max(time.time() - t0, 1e-9)
            print(f"iter {done_steps}/{total_steps} | loss {loss_now:.6e} | "
                  f"acc {acc:.3f} | {rate:,.0f} it/s", flush=True)
        if live is not None:
            live(done_steps, state, {k: v[:, None] for k, v in keep.items()})
        first = False
    return state, {k: np.concatenate([c[k] for c in chunks])
                   for k in chunks[0]}


def run_single_chain(chain, n_iter, only_save_last_bed, info_per_iter,
                     plot, progress_bar, save_beds, seed, device):
    """The single-chain ``run`` of either family (``ChainCRF.run``,
    ``ChainSGS.run``): a one-chain farm (``single_chain_farm``) through
    the runners' one-chain loop (``parallel/sampler.run_one_chain``),
    segmented by the observers, returned as a dict of the
    reference's names (MCMC.py:1147-1155) with every trace's chain axis
    removed; ``bed`` the (n_iter, H, W) saved beds or the final bed, in
    data space."""
    if int(n_iter) < 1:
        raise ValueError("n_iter must be >= 1 (trace row 0 records the "
                         "initial state, reference loop semantics)")
    from ..parallel.sampler import run_one_chain

    save_beds = bool(not only_save_last_bed if save_beds is None
                     else save_beds)
    sampler, state = single_chain_farm(chain, seed, device)

    def run(st, n):
        st, tr = run_one_chain(sampler.static, sampler.consts, st, n,
                               save_beds, sampler.generator, sampler.impl,
                               "run", graphs=sampler.graphs)
        return st, {k: host_copy(v) for k, v in tr.items()}

    final, traces = _run_segmented(run, state, int(n_iter),
                                   int(info_per_iter), bool(progress_bar),
                                   bool(plot))
    out = {
        "bed": (traces["bed"] if save_beds
                else host_copy(sampler.full_bed(final)[0])),
        "loss_mc": traces["loss_mc"],
        "loss_data": traces["loss_data"],
        "loss": traces["loss"],
        "steps": traces["step"],
        "resampled_times": host_copy(final.resampled[0]),
        "blocks": traces["block"],
        "final_state": final,
    }
    if sampler.static.P:
        out["sample_values"] = traces["samples"].T  # (P, n_iter)
    return out


class ChainCRF:
    """Host-side builder with the reference's imperative API surface.

    Mirrors ``chain_crf``'s setters (set_update_region / set_loss_type /
    set_update_type / set_crf_data_weight / set_random_generator /
    set_sample_points_locations), then ``build(device)`` produces the
    (CRFStatic, CRFConsts) pair that ``parallel.sampler`` runs; ``run`` is
    the single-chain convenience, a one-chain farm.
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
        self._streams = None  # the single-chain run's stream, continued
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
        """Seed for the samplers built from this chain: an int, None for
        fresh entropy, or a list of per-chain seeds (one stream a chain).
        The next ``run`` starts from it, not from the last run's
        stream."""
        self.seed = resolve_seed(rng_seed)
        self._streams = None

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

    def build(self, device="cuda"):
        """The configured chain as (CRFStatic, CRFConsts) on ``device``
        (the card unless the caller asks for the CPU)."""
        if self.sigma_mc is None:
            raise ValueError("call set_loss_type before building the chain")
        if self._rf_cfg is None:
            raise ValueError("call configure_randfield before building the "
                             "chain")
        device = resolve_device(device)
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

    def run(self, n_iter, RF=None, only_save_last_bed=True,
            info_per_iter=1000, plot=False, progress_bar=False, *,
            save_beds=None, seed=None, device=None):
        """Single-chain convenience run; returns a dict of the reference's
        return names (MCMC.py:1147-1155).

        Positional order as the reference's ``chain_crf.run(n_iter, RF,
        only_save_last_bed, info_per_iter, plot, progress_bar)``
        (MCMC.py:1137), with the JAX package's defaults (its
        production-driver settings); ``save_beds``, ``seed`` and
        ``device`` (the card unless the caller asks for the CPU) are
        keyword-only.  ``RF`` may be a ``models.RandField`` whose
        configuration the chain adopts.  The run is a one-chain farm
        (``single_chain_farm``: the kernels on the card, their plain
        versions on the CPU), seeded as the per-chain stream of ``[seed]``
        and continued by the next ``run`` when ``seed`` is None; each run
        restarts from the initial bed.  ``progress_bar`` prints the
        cumulative acceptance and it/s every ``info_per_iter`` iterations
        and ``plot`` drives ``utils.plotting.LiveChainPlot``; either
        segments the run, with bitwise the same traces.  Every trace has
        its chain axis removed; ``final_state`` is the port's
        ``ChainState``, with its leading axis of 1."""
        if RF is not None:
            from .randfield import RandField

            if not isinstance(RF, RandField):
                # reference error text, MCMC.py:1160
                raise TypeError('The arugment "RF" has to be an object of '
                                'the class RandField')
            if RF._blocks is None:
                raise ValueError("RF needs set_block_sizes before run")
            if RF._weights is None and self._weight_cfg is None:
                raise ValueError("RF needs set_weight_param before run "
                                 "(no weight config on the chain either)")
            self.configure_randfield(RF.config, RF._blocks,
                                     RF._weights or self._weight_cfg)
        return run_single_chain(self, n_iter, only_save_last_bed,
                                info_per_iter, plot, progress_bar, save_beds,
                                seed, device)
