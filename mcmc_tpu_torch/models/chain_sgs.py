"""Small-scale MCMC chain with SGS block re-simulation, batched over chains.

PyTorch counterpart of ``mcmc_tpu/models/chain_sgs.py`` (the reference's
``chain_sgs``, MCMC.py:1445-1912).  The algorithm is the same: each step
redraws a rectangular block of every chain's bed jointly from its
conditional Gaussian given a packed conditioning set C, the K =
``num_neighbors`` nearest non-simulated cells of the chain's (SB, SB)
window within ``search_radius`` of the block,

    x | y_C = x_u + Sigma_{:,C} w,   (Sigma_CC + eps I) w = (y - x_u)_C

with x_u an unconditional circulant-embedding draw (one inverse FFT of
half-spectrum noise), w from a fixed-iteration CG on the K x K system, and
the kriging adjustment Sigma_{:,C} w a covariance-stamp convolution (an
FFT pair).  The residual is patched exactly over the block and its
one-cell ring (``ring_dist <= 1``, no stale ring), the loss is a
Kahan-compensated ledger, and the MH rule is the reference's
likelihood-only one.

One batched step runs, in order (``make_sgs_kernel``):

1. ``window_start``: block extent and clamped window start (floor
   division: ``(2*cx - bsx)//2`` is negative near the top-left edge);
2. window extract (CUDA kernel, ``ops/sgs_window_kernel.py``);
3. ``prepare``: roles, the unconditional draw, then the K-nearest
   selection with the packed right-hand side and coordinates (one CUDA
   kernel, ``ops/k_nearest_kernel.py``);
4. the packed solve (CUDA kernels, ``ops/cg_kernel.py``): the
   mixture-system CG, or, for a covariance with no mixture fit (a
   spherical variogram), the stamp gather ``cov_stamp[di, dj]`` (a torch
   index op, as the JAX package leaves it to XLA) and the CG on that
   Sigma;
5. ``draw_z``: scatter-back, kriging adjustment, conditional draw;
6. the inverse normal-score LUT (CUDA kernel, ``ops/lut_kernel.py``);
7. ``commit_core``: data-space window, residual patch, thickness guard,
   MH accept, Kahan ledger;
8. window writeback (CUDA kernel), in place;
9. ``assemble``: state and trace.

JAX semantics kept where they differ from the CRF chain's: the trace's
``step`` and ``state.accepted`` count ``accept``, not ``accept & ~viol``;
the state is written only where ``accept & ~viol``.  PyTorch idiom: every
function takes a leading chain axis, the draws come from one explicit
``torch.Generator`` or, for a farm seeded with a list of per-chain seeds,
from one launch of the per-chain draw kernel (``draw_plan_entries``,
``ops/chain_draws.py``), and ``state.fields`` is updated IN PLACE.  Not
carried over: the ``MCMC_TPU_SGS_SURGERY`` gates and the TPU's one-hot
packing matmuls.  ``ChainSGS.run`` is the single-chain convenience, a
one-chain farm as ``ChainCRF.run`` is.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops.cg_kernel import (masked_cg, masked_cg_reference, mix_masked_cg,
                             mix_masked_cg_reference)
from ..ops.chain_draws import cached_plan, draw_plan, entry
from ..ops.covariance import (CovarianceSpec, covariance_norm,
                              fit_cov_mixture, make_rotation_matrix)
from ..ops.k_nearest_kernel import k_nearest, k_nearest_ops
from ..ops.lut_kernel import lut_interp, lut_interp_reference
from ..ops.physics import (masked_gaussian_loss, masked_sq_sum,
                           mass_conservation_residual)
from ..ops.sgs_window_kernel import (window_extract,
                                     window_extract_reference,
                                     window_writeback,
                                     window_writeback_reference)
from ..ops.transforms import NormalScoreLUT, NormalScoreTransform
from ..utils.config import LossConfig, SGSParams, VariogramConfig
from ..utils.rng import (PerChainStreams, RowSlice, draw_rows,
                         resolve_device, resolve_seed)
from .chain_crf import (IMPLS, chain_loss_mc, run_single_chain,
                        sample_probes)

N_CONST = 10   # planes of SGSConsts.stacked


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class SGSStatic:
    """Plain-value configuration of a built SGS chain."""

    H: int
    W: int
    SB: int     # window size = max block + 2 * margin
    BMX: int    # max block rows
    BMY: int    # max block cols
    M: int      # window margin (cells), from search_radius
    K: int      # packed conditioning size = num_neighbors
    n_region: int
    P: int
    spec: CovarianceSpec
    use_transform: bool
    detrend: bool
    dropout: bool
    has_nugget: bool = False
    cg_iters: int = 64
    NE: int = 0  # circulant-embedding FFT size of the unconditional draw
    NA: int = 0  # FFT size of the kriging adjustment
    Mg: int = 0  # Gaussian mixture terms (Mg + Me = 0: stamp gather)
    Me: int = 0  # exponential mixture terms
    # ((ag...), (bg...), (ae...), (be...), (q0, q1, q2)) as float32-rounded
    # Python floats, () when the mixture is unused
    mix: tuple = ()


@dataclasses.dataclass
class SGSConsts:
    """Per-problem constants on the chain's device, shared by all chains.
    ``stacked`` is (10, H, W) float32 in the JAX package's plane order:
    surf, velx, vely, dhdt, smb, trend, grounded, mc_mask, z_cond,
    data_mask.  Scalars are Python floats holding float32 values."""

    stacked: torch.Tensor
    region_cells: torch.Tensor   # (n_region, 2) int64
    sample_ij: torch.Tensor      # (P, 2) int64
    nst: NormalScoreLUT
    cov_stamp: torch.Tensor      # (NE, NE) periodized covariance stamp
    embed_spec: torch.Tensor     # (NA, NA//2+1) adjustment half spectrum
    embed_sqrt: torch.Tensor     # (NE, NE//2+1) sqrt of the draw spectrum
    rot: torch.Tensor            # (2, 2) anisotropy matrix
    sill: float
    nugget: float
    sigma_mc: float
    resolution: float
    block_min_x: int             # rows (reference convention)
    block_max_x: int
    block_min_y: int
    block_max_y: int
    dropout_rate: float
    search_radius: float         # meters
    mean_z: float                # prior mean in simulation space
    mix_ag: torch.Tensor         # (Mg,) Gaussian weights
    mix_bg: torch.Tensor         # (Mg,) Gaussian rates (in h^2)
    mix_ae: torch.Tensor         # (Me,) exponential weights
    mix_be: torch.Tensor         # (Me,) exponential rates (in h)
    qcoef: torch.Tensor          # (3,) h^2 = q0 dj^2 + q1 dj di + q2 di^2

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
    def dhdt(self):
        return self.stacked[3]

    @property
    def smb(self):
        return self.stacked[4]

    @property
    def trend(self):
        return self.stacked[5]

    @property
    def grounded(self):
        return self.stacked[6]

    @property
    def mc_mask(self):
        return self.stacked[7] > 0

    @property
    def z_cond(self):
        return self.stacked[8]

    @property
    def data_mask(self):
        return self.stacked[9]


@dataclasses.dataclass
class SGSState:
    """State of a batch of SGS chains; every tensor has a leading chain
    axis.  ``fields`` (N, 4, H, W): detrended bed, patched residual,
    resample count, and the z-plane, the normal-score transform of the bed
    plane kept in sync on every write (so the step never runs the forward
    transform)."""

    fields: torch.Tensor
    loss_mc: torch.Tensor     # (N,)
    loss_comp: torch.Tensor   # (N,) Kahan compensation
    accepted: torch.Tensor    # (N,) int32

    @property
    def bed(self):
        return self.fields[:, 0]

    @property
    def mc_res(self):
        return self.fields[:, 1]

    @property
    def resampled(self):
        return self.fields[:, 2]

    @property
    def z_bed(self):
        return self.fields[:, 3]


# --- host-side spectra -------------------------------------------------------

def _fft_sizes(lo, hi):
    """Even 2,3,5-smooth FFT sizes in [lo, hi], ascending."""
    out = []
    for n in range(lo + (lo & 1), hi + 1, 2):
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            out.append(n)
    return out or [hi]


def _periodized_stamp(spec, rot_np, sill, nugget, resolution, N):
    """(N, N) covariance by periodic offset, evaluated in float32 as the
    JAX package does, returned as float64."""
    k = np.arange(N)
    off = np.where(k <= N // 2, k, k - N)
    di, dj = np.meshgrid(off, off, indexing="ij")
    pts = np.stack([dj.ravel() * resolution,
                    di.ravel() * resolution], -1) @ rot_np
    d = np.sqrt((pts ** 2).sum(-1)).reshape(N, N)
    return covariance_norm(spec, d, sill, nugget).numpy().astype(np.float64)


def _embedding_spectra(spec, rot_np, sill, nugget, SB, resolution):
    """Circulant-embedding spectra of the stationary window covariance:
    NE, the smallest even 2,3,5-smooth size >= 2*SB whose embedding is
    (near-)nonnegative-definite (capped at 8*SB, then clamped), for the
    unconditional draw; NA, the smallest such size >= 2*SB, for the
    adjustment convolution, which only needs exact linear convolution.
    Returns (stamp f32 (NE, NE), exact half spectrum f32 (NA, NA//2+1),
    half sqrt of the clamped spectrum f32 (NE, NE//2+1) scaled to the
    marginal variance C(0), NE, NA)."""
    sizes = _fft_sizes(2 * SB, 8 * SB)
    NA = sizes[0]
    stamp = E = None
    for N in sizes:
        stamp = _periodized_stamp(spec, rot_np, sill, nugget, resolution, N)
        E = np.fft.fft2(stamp).real
        if E.min() > -1e-6 * E.max():
            break
    NE = stamp.shape[0]
    Ec = np.maximum(E, 0.0)
    var = Ec.mean()
    sqrtE_half = np.sqrt(Ec * (stamp[0, 0] / max(var, 1e-300)))[
        :, : NE // 2 + 1]
    if NA == NE:
        E_a = E
    else:
        stamp_a = _periodized_stamp(spec, rot_np, sill, nugget, resolution,
                                    NA)
        E_a = np.fft.fft2(stamp_a).real
    E_half = E_a[:, : NA // 2 + 1]
    return (stamp.astype(np.float32), E_half.astype(np.float32),
            sqrtE_half.astype(np.float32), NE, NA)


# --- state -------------------------------------------------------------------

def sgs_init_state(bed_detrended, consts: SGSConsts, z0=None,
                   use_transform: bool = True,
                   n_chains: Optional[int] = None) -> SGSState:
    """Fresh chain states: full-grid residual of bed + trend and its loss.
    ``bed_detrended`` is (N, H, W), or one (H, W) bed shared by
    ``n_chains`` chains.  ``z0`` is the host-precomputed exact transform
    of the bed (``ChainSGS.host_transform``), of the same shape; required
    when ``use_transform``, ignored otherwise (the z-plane then mirrors
    the bed plane).  The reference's ``sgs_init_state(bed_detrended, key,
    consts, ...)`` has a key in second place; the port's states carry
    none, so a second argument that is not an ``SGSConsts`` raises a
    TypeError naming this form."""
    if not isinstance(consts, SGSConsts):
        raise TypeError("sgs_init_state(bed_detrended, consts, z0=None, "
                        "use_transform=True, n_chains=None): consts must be "
                        "an SGSConsts (the port's chain state carries no "
                        f"key); got {type(consts).__name__}")
    device = consts.stacked.device
    bed = torch.as_tensor(np.asarray(bed_detrended, np.float32),
                          device=device)
    shared = bed.dim() == 2
    b = bed[None] if shared else bed
    mc_res = mass_conservation_residual(
        b + consts.trend, consts.surf, consts.velx, consts.vely,
        consts.dhdt, consts.smb, consts.resolution)
    loss_mc = masked_gaussian_loss(mc_res, consts.mc_mask, consts.sigma_mc)
    if use_transform:
        if z0 is None:
            raise ValueError(
                "use_transform=True requires the host-precomputed z0 plane")
        z = torch.as_tensor(np.asarray(z0, np.float32), device=device)
        z = z[None] if z.dim() == 2 else z
    else:
        z = b
    fields = torch.stack([b, mc_res, torch.zeros_like(b), z], dim=1)
    if shared:
        n = 1 if n_chains is None else int(n_chains)
        fields = fields.expand(n, -1, -1, -1).contiguous()
        loss_mc = loss_mc.expand(n).contiguous()
    n = fields.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    return SGSState(fields=fields.contiguous(),
                    loss_mc=loss_mc.to(torch.float32), loss_comp=zeros,
                    accepted=torch.zeros(n, dtype=torch.int32,
                                         device=device))


# --- the step's pieces -------------------------------------------------------

def halfspec_noise(noise, NE: int):
    """(N, NE, NE//2+1) complex64 noise distributed exactly as rfft2 of an
    iid standard-normal (NE, NE) field, from (N, NE²) normals in the JAX
    package's layout: interior columns first (Re, Im interleaved), then
    the kx = 0 and kx = NE/2 columns, each as [real ky=0, real ky=NE/2,
    (Re, Im) of ky = 1 .. NE/2-1], mirrored conjugate below."""
    N = noise.shape[0]
    Hh = NE // 2
    sig = _f32(NE * np.sqrt(0.5))
    n_int = NE * (Hh - 1) * 2
    vi = noise[:, :n_int].reshape(N, NE, Hh - 1, 2)
    interior = torch.complex(vi[..., 0] * sig, vi[..., 1] * sig)

    def edge_col(v):                      # (N, NE) normals -> (N, NE)
        up = torch.complex(v[:, 2::2] * sig, v[:, 3::2] * sig)
        zero = torch.zeros_like(v[:, :1])
        return torch.cat([torch.complex(v[:, 0:1] * NE, zero), up,
                          torch.complex(v[:, 1:2] * NE, zero),
                          up.conj().flip(1)], dim=1)

    col0 = edge_col(noise[:, n_int:n_int + NE])
    colH = edge_col(noise[:, n_int + NE:n_int + 2 * NE])
    return torch.cat([col0[:, :, None], interior, colH[:, :, None]], dim=2)


def k_nearest_packed(candidate, rd, cd, K: int):
    """The K candidate cells nearest the block, packed by window index.

    ``candidate`` (N, SB, SB) bool; ``rd``, ``cd`` (N, SB) integer row and
    column distances to the block.  Returns ``idx`` (N, K) int64 indices
    into the raveled window, ascending, and ``sel`` (N, K) bool; when fewer
    than K candidates exist the tail of ``sel`` is False and ``idx`` there
    is SB²-1, masked downstream.  The same set in the same order as the
    JAX package's ``k_nearest_packed`` (``ops/k_nearest_kernel.py``'s
    ``k_nearest_ops``; the step runs the selection through its
    ``k_nearest``)."""
    ops = k_nearest_ops(candidate, rd, cd, K)
    return ops["idx"], ops["sel"]


@dataclasses.dataclass
class BlockGeometry:
    """Per-chain block extent [bxmin, bxmax) x [bymin, bymax) and window
    start (sx, sy), each (N,) int64; ``sx32``/``sy32`` for the kernels."""

    bxmin: torch.Tensor
    bxmax: torch.Tensor
    bymin: torch.Tensor
    bymax: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor

    @property
    def sx32(self):
        return self.sx.to(torch.int32)

    @property
    def sy32(self):
        return self.sy.to(torch.int32)


def window_start(static: SGSStatic, cx, cy, bsx, bsy) -> BlockGeometry:
    """Block extent and clamped window start (reference MCMC.py:1761-1764;
    x -> rows), with floor division as the JAX package's ``//``."""
    def fdiv2(x):
        return torch.div(x, 2, rounding_mode="floor")

    H, W, SB, M = static.H, static.W, static.SB, static.M
    bxmin = torch.clamp(fdiv2(2 * cx - bsx), min=0)
    bxmax = torch.clamp(fdiv2(2 * cx + bsx), max=H)
    bymin = torch.clamp(fdiv2(2 * cy - bsy), min=0)
    bymax = torch.clamp(fdiv2(2 * cy + bsy), max=W)
    return BlockGeometry(bxmin=bxmin, bxmax=bxmax, bymin=bymin, bymax=bymax,
                         sx=torch.clamp(bxmin - M, 0, H - SB),
                         sy=torch.clamp(bymin - M, 0, W - SB))


@dataclasses.dataclass
class Prepared:
    """What ``prepare`` hands the later stages: the extracted windows, the
    cell roles, the unconditional draw and the packed system."""

    windows: torch.Tensor     # (N, 14, SB, SB) const + state windows
    in_block: torch.Tensor    # (N, SB, SB) bool
    sim_mask: torch.Tensor    # cells redrawn
    data_w: torch.Tensor      # radar data cells
    ring_dist: torch.Tensor   # Chebyshev distance to the block
    z_w: torch.Tensor         # current window in simulation space
    z_u: torch.Tensor         # unconditional draw
    idx: torch.Tensor         # (N, K) packed window indices
    sel: torch.Tensor         # (N, K) bool
    m_sel: torch.Tensor       # (N, K) float32
    rhs_p: torch.Tensor       # (N, K) packed right-hand side
    iaf: torch.Tensor         # (N, K) packed rows, float32
    jaf: torch.Tensor         # (N, K) packed cols, float32
    eps: float                # diagonal jitter
    cond_mask: torch.Tensor   # (N, SB, SB) cells that may condition
    rd: torch.Tensor          # (N, SB) int64 row distance to the block
    cd: torch.Tensor          # (N, SB) int64 column distance to the block


def prepare(static: SGSStatic, consts: SGSConsts, windows, geo: BlockGeometry,
            noise, drop_u=None, impl: str = "auto") -> Prepared:
    """Roles, the unconditional draw and the packed conditioning system of
    every chain's window (the JAX package's ``prepare``).  The K-nearest
    selection and the packed system's inputs are one ``k_nearest`` call:
    the CUDA kernel for CUDA tensors, the plain version for CPU ones or
    under ``impl="eager"``."""
    SB, NE, K = static.SB, static.NE, static.K
    N = windows.shape[0]
    ar = torch.arange(SB, device=windows.device)
    rows = geo.sx[:, None] + ar
    cols = geo.sy[:, None] + ar
    in_rows = (rows >= geo.bxmin[:, None]) & (rows < geo.bxmax[:, None])
    in_cols = (cols >= geo.bymin[:, None]) & (cols < geo.bymax[:, None])
    in_block = in_rows[:, :, None] & in_cols[:, None, :]
    zcond_w, dataf_w = windows[:, 8], windows[:, 9]
    bed_w, zbed_w = windows[:, N_CONST], windows[:, N_CONST + 3]
    data_w = dataf_w > 0

    sim_mask = in_block & ~data_w
    rd = torch.clamp(torch.maximum(geo.bxmin[:, None] - rows,
                                   rows - (geo.bxmax[:, None] - 1)), min=0)
    cd = torch.clamp(torch.maximum(geo.bymin[:, None] - cols,
                                   cols - (geo.bymax[:, None] - 1)), min=0)
    ring_dist = torch.maximum(rd[:, :, None], cd[:, None, :])
    cond_mask = ~sim_mask
    if static.dropout:
        cond_mask = cond_mask & (drop_u >= consts.dropout_rate)

    z_w = zbed_w if static.use_transform else bed_w
    z_w = torch.where(in_block & data_w, zcond_w, z_w)

    Z = halfspec_noise(noise[:, :NE * NE], NE)
    z_big = torch.fft.irfft2(Z * consts.embed_sqrt, s=(NE, NE))
    z_u = z_big[:, :SB, :SB] + consts.mean_z

    knn = k_nearest(cond_mask, rd, cd, consts.search_radius,
                    consts.resolution, z_w, z_u, K, impl)
    eps = _f32(np.float32(1e-3) * np.float32(max(consts.sill, 1.0)))
    return Prepared(windows=windows, in_block=in_block, sim_mask=sim_mask,
                    data_w=data_w, ring_dist=ring_dist, z_w=z_w, z_u=z_u,
                    idx=knn.idx, sel=knn.sel, m_sel=knn.m_sel,
                    rhs_p=knn.rhs_p, iaf=knn.iaf, jaf=knn.jaf, eps=eps,
                    cond_mask=cond_mask, rd=rd, cd=cd)


def stamp_sigma(static: SGSStatic, consts: SGSConsts, prep: Prepared):
    """(N, K, K) covariance of the packed neighbours, gathered from the
    covariance stamp at their wrapped offsets: ``cov_stamp[di, dj]``."""
    ia = prep.iaf.long()
    ja = prep.jaf.long()
    di = torch.remainder(ia[:, :, None] - ia[:, None, :], static.NE)
    dj = torch.remainder(ja[:, :, None] - ja[:, None, :], static.NE)
    return consts.cov_stamp[di, dj]


def solve(static: SGSStatic, consts: SGSConsts, prep: Prepared,
          impl: str = "auto"):
    """The packed conditioning solve: w (N, K), zero at masked slots."""
    eager = impl == "eager"
    if static.Mg + static.Me > 0:
        cg = mix_masked_cg_reference if eager else mix_masked_cg
        return cg(prep.iaf, prep.jaf, prep.m_sel, prep.rhs_p, prep.eps,
                  static.mix, static.cg_iters)
    cg = masked_cg_reference if eager else masked_cg
    return cg(stamp_sigma(static, consts, prep), prep.m_sel, prep.rhs_p,
              prep.eps, static.cg_iters)


def adjustment_ops(static: SGSStatic, consts: SGSConsts, prep: Prepared,
                   w_p) -> dict:
    """``draw_z``'s kriging adjustment by op, in its order: the weights'
    ``scatter_add`` into the (N, SB²) window, the ``R2C FFT`` of the
    weights padded to (NA, NA), and the ``C2R FFT`` of its product with
    the adjustment spectrum, uncropped (``testing.sgs_step_stages`` reads
    each)."""
    SB, NA = static.SB, static.NA
    N = w_p.shape[0]
    w = torch.where(prep.sel, w_p, 0.0)
    # masked slots all point at SB²-1 and add exact zeros
    w_full = torch.zeros((N, SB * SB), dtype=torch.float32,
                         device=w_p.device).scatter_add_(1, prep.idx, w)
    w_pad = torch.zeros((N, NA, NA), dtype=torch.float32, device=w_p.device)
    w_pad[:, :SB, :SB] = w_full.view(N, SB, SB)
    spec = torch.fft.rfft2(w_pad)
    return {"scatter_add": w_full, "R2C FFT": spec,
            "C2R FFT": torch.fft.irfft2(spec * consts.embed_spec,
                                        s=(NA, NA))}


def draw_z(static: SGSStatic, consts: SGSConsts, prep: Prepared, w_p, noise):
    """Scatter-back, kriging adjustment and conditional draw.  Returns
    (z_new_w, z_cache_w): the new window in simulation space, and its
    z-plane cache value, clamped to the forward table's range."""
    SB, NE = static.SB, static.NE
    N = w_p.shape[0]
    adj = adjustment_ops(static, consts, prep, w_p)["C2R FFT"][:, :SB, :SB]
    z_draw = prep.z_u + adj
    if static.has_nugget:
        z_draw = z_draw + _f32(np.sqrt(np.float32(consts.nugget))) * noise[
            :, NE * NE:].reshape(N, SB, SB)
    z_new_w = torch.where(prep.sim_mask, z_draw, prep.z_w)
    if static.use_transform:
        table = consts.nst.fwd_table
        z_cache_w = torch.clamp(z_new_w, table[0, 0], table[-1, 1])
    else:
        z_cache_w = z_new_w
    return z_new_w, z_cache_w


@dataclasses.dataclass
class Commit:
    """``commit_core``'s per-chain results, (N,) each."""

    t: torch.Tensor        # new Kahan-summed loss
    comp: torch.Tensor     # new compensation
    accept: torch.Tensor   # bool, the MH decision
    write: torch.Tensor    # bool, accept & ~viol: the state is written


def commit_core(consts: SGSConsts, state: SGSState, prep: Prepared, z_new_w,
                z_cache_w, inv_draw, u):
    """Data-space window, residual patch over block + ring, thickness
    guard, MH accept and the Kahan ledger; everything but the writeback.
    ``inv_draw`` is the inverse LUT of ``z_new_w`` (None without a
    transform).  Returns (new_w (N, 4, SB, SB), Commit): ``new_w`` is the
    window to write where ``write``."""
    (surf_w, velx_w, vely_w, dhdt_w, smb_w, trend_w, grounded_f, mcf_w,
     _, _) = prep.windows[:, :N_CONST].unbind(1)
    bed_w, res_old_w, resampled_w, _ = prep.windows[:, N_CONST:].unbind(1)
    in_block = prep.in_block
    if inv_draw is not None:
        # data cells re-snap to inverse(transform(cond)) like the reference
        bed_new_w = torch.where(prep.sim_mask | (in_block & prep.data_w),
                                inv_draw, bed_w)
    else:
        bed_new_w = torch.where(in_block, z_new_w, bed_w)

    chg = prep.ring_dist <= 1
    full_new = bed_new_w + trend_w
    res_new_w = mass_conservation_residual(
        full_new, surf_w, velx_w, vely_w, dhdt_w, smb_w, consts.resolution)
    patch = chg & (mcf_w > 0)
    denom = _f32(np.float32(2.0) * np.square(np.float32(consts.sigma_mc)))
    delta = (masked_sq_sum(res_new_w, patch)
             - masked_sq_sum(res_old_w, patch)) / denom

    viol = ((((surf_w - full_new) <= 0.0) & in_block & (grounded_f > 0))
            .flatten(1).any(dim=1))
    # a non-finite draw is rejected outright, never written
    viol = viol | (~torch.isfinite(torch.where(prep.sim_mask, bed_new_w,
                                               0.0))).flatten(1).any(dim=1)
    loss_next = torch.where(viol, torch.full_like(delta, float("inf")),
                            state.loss_mc + delta)
    rate = torch.clamp(torch.exp(state.loss_mc - loss_next), max=1.0)
    accept = u <= rate
    write = accept & ~viol

    new_w = torch.stack([
        bed_new_w,
        torch.where(chg, res_new_w, res_old_w),
        resampled_w + in_block.to(torch.float32),
        z_cache_w], dim=1)
    y = torch.where(write, delta, 0.0) - state.loss_comp
    t = state.loss_mc + y
    comp = (t - state.loss_mc) - y
    return new_w, Commit(t=t, comp=comp, accept=accept, write=write)


def assemble(consts: SGSConsts, state: SGSState, sc: Commit, cx, cy, bsx,
             bsy):
    """State and trace after the writeback.  The probes report the full
    (trend-restored) bed like the reference's bed cache."""
    n = state.fields.shape[0]
    sij = consts.sample_ij
    samples = (sample_probes(state.fields[:, 0], sij, n)
               + consts.trend[sij[:, 0], sij[:, 1]])
    new_state = SGSState(fields=state.fields, loss_mc=sc.t,
                         loss_comp=sc.comp,
                         accepted=state.accepted + sc.accept.to(torch.int32))
    trace = {
        "loss_mc": sc.t,
        "loss_data": torch.zeros_like(sc.t),
        "loss": sc.t,
        "step": sc.accept,
        "block": torch.stack([cx, cy, bsx, bsy], dim=1).to(torch.float32),
        "samples": samples,
    }
    return new_state, trace


def make_sgs_kernel(static: SGSStatic, impl: str = "auto"):
    """Build the batched MH update, the parity seam:
    ``(consts, state, cx, cy, bsx, bsy, noise (N, NE²[+SB²]), drop_u
    (N, SB, SB) or None, u) -> (state, trace)``.

    ``impl`` "auto" or "fused" runs the dispatchers (the CUDA kernels for
    CUDA tensors, the plain versions for CPU ones); "eager" always runs
    the plain versions.  ``state.fields`` is updated in place."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    eager = impl == "eager"
    extract = window_extract_reference if eager else window_extract
    writeback = window_writeback_reference if eager else window_writeback
    lut = lut_interp_reference if eager else lut_interp

    def mh_update(consts: SGSConsts, state: SGSState, cx, cy, bsx, bsy,
                  noise, drop_u, u):
        geo = window_start(static, cx, cy, bsx, bsy)
        sx, sy = geo.sx32, geo.sy32
        windows = extract(consts.stacked, state.fields, sx, sy, static.SB)
        prep = prepare(static, consts, windows, geo, noise, drop_u, impl)
        w_p = solve(static, consts, prep, impl)
        z_new_w, z_cache_w = draw_z(static, consts, prep, w_p, noise)
        inv_draw = None
        if static.use_transform:
            nst = consts.nst
            inv_draw = lut(z_new_w, nst.inv_lo, nst.inv_scale, nst.inv_table)
        new_w, sc = commit_core(consts, state, prep, z_new_w, z_cache_w,
                                inv_draw, u)
        writeback(state.fields, new_w, sx, sy, sc.write)
        return assemble(consts, state, sc, cx, cy, bsx, bsy)

    return mh_update


@dataclasses.dataclass
class SGSDraws:
    """One step's random draws for every chain (the JAX package's
    ``_sample_proposal``)."""

    cx: torch.Tensor       # (N,) int64 block centre row
    cy: torch.Tensor       # (N,) int64 block centre col
    bsx: torch.Tensor      # (N,) int64 block rows
    bsy: torch.Tensor      # (N,) int64 block cols
    noise: torch.Tensor    # (N, NE² [+ SB²]) float32 normals
    drop_u: Optional[torch.Tensor]  # (N, SB, SB) uniforms, dropout only
    u: torch.Tensor        # (N,) float32 MH uniform


def draw_plan_entries(static: SGSStatic, consts: SGSConsts):
    """A seed-listed SGS step's draw plan: the centre index, the block's
    rows and columns, the draw's normals, the dropout uniforms (dropout
    only) and the MH uniform."""
    n_noise = static.NE * static.NE + (static.SB * static.SB
                                       if static.has_nugget else 0)
    drop = ((entry("drop_u", "uniform", static.SB * static.SB),)
            if static.dropout else ())
    return ((entry("cidx", "index", n=static.n_region),
             entry("bsx", "index", n=consts.block_max_x - consts.block_min_x,
                   lo=consts.block_min_x),
             entry("bsy", "index", n=consts.block_max_y - consts.block_min_y,
                   lo=consts.block_min_y),
             entry("noise", "normal", n_noise)) + drop
            + (entry("u", "uniform"),))


def draw(gen, static: SGSStatic, consts: SGSConsts, n: int,
         impl: str = "auto") -> SGSDraws:
    """One step's draws for ``n`` chains from ``gen``: a generator, or
    per-chain streams (one launch of ``draw_plan_entries``' plan; its
    plain version under ``impl="eager"``), or a ``RowSlice`` (a rank of a
    sharded int-seeded farm: the whole farm's draws, cut to its rows)."""
    if isinstance(gen, RowSlice):
        return draw_rows(draw(gen.generator, static, consts, gen.n_total,
                              impl), gen.lo, gen.hi)
    device = consts.stacked.device
    if isinstance(gen, PerChainStreams):
        if gen.n_chains != n:
            raise ValueError(f"{gen.n_chains} per-chain streams for {n} "
                             "chains")
        d = draw_plan(gen, cached_plan(draw_plan_entries(static, consts)),
                      impl)
        cidx, bsx, bsy = d["cidx"][:, 0], d["bsx"][:, 0], d["bsy"][:, 0]
        noise, u = d["noise"], d["u"][:, 0]
        drop_u = (d["drop_u"].view(n, static.SB, static.SB)
                  if static.dropout else None)
    else:
        n_noise = static.NE * static.NE + (static.SB * static.SB
                                           if static.has_nugget else 0)
        cidx = torch.randint(0, static.n_region, (n,), generator=gen,
                             device=device)
        bsx = torch.randint(consts.block_min_x, consts.block_max_x, (n,),
                            generator=gen, device=device)
        bsy = torch.randint(consts.block_min_y, consts.block_max_y, (n,),
                            generator=gen, device=device)
        noise = torch.randn((n, n_noise), generator=gen, device=device)
        drop_u = (torch.rand((n, static.SB, static.SB), generator=gen,
                             device=device) if static.dropout else None)
        u = torch.rand((n,), generator=gen, device=device)
    return SGSDraws(cx=consts.region_cells[cidx, 0],
                    cy=consts.region_cells[cidx, 1], bsx=bsx, bsy=bsy,
                    noise=noise, drop_u=drop_u, u=u)


def make_sgs_step(static: SGSStatic, impl: str = "auto"):
    """The full batched SGS step: ``(consts, state, gen) -> (state,
    trace)``, the draws (``gen`` a generator or per-chain streams; the
    caller advances the streams' step) then ``make_sgs_kernel``'s
    update."""
    mh_update = make_sgs_kernel(static, impl)

    def step(consts: SGSConsts, state: SGSState, gen):
        d = draw(gen, static, consts, state.fields.shape[0], impl)
        return mh_update(consts, state, d.cx, d.cy, d.bsx, d.bsy, d.noise,
                         d.drop_u, d.u)

    return step


RUN_SGS_CHAIN_FORM = ("run_sgs_chain(static, consts, state, n_iter, "
                      "save_beds=False, *, rng)")


def run_sgs_chain(static: SGSStatic, consts: SGSConsts, state: SGSState,
                  n_iter: int, save_beds: bool = False, *, rng=None):
    """``n_iter - 1`` SGS steps of one chain with the initial state as
    row 0, the reference's ``run_sgs_chain``
    (``mcmc_tpu/models/chain_sgs.py:1017``) with its arguments in its
    order: the same trace keys (``loss_mc``, ``loss_data`` (0), ``loss``,
    ``step``, ``block``, ``samples`` of the trend-restored bed, and under
    ``save_beds`` ``bed``, the bed plus the trend), as device tensors with
    leading dim ``n_iter`` and no chain axis.  ``state`` holds one chain
    (a leading axis of 1); ``rng`` (keyword-only, required) is a
    ``torch.Generator`` or per-chain streams, in place of the key the
    reference's state carries.  The kernels run for CUDA tensors, their
    plain versions for CPU ones."""
    from ..parallel.sampler import run_one_chain

    if not isinstance(static, SGSStatic):
        raise TypeError(f"{RUN_SGS_CHAIN_FORM}: static must be an SGSStatic,"
                        f" got {type(static).__name__}")
    return run_one_chain(static, consts, state, n_iter, save_beds, rng,
                         "auto", RUN_SGS_CHAIN_FORM)


class ChainSGS:
    """Host-side builder with the reference ``chain_sgs`` setter API
    (set_normal_transformation / set_trend / set_variogram / set_sgs_param
    / set_block_sizes / set_update_region / set_loss_type /
    set_random_generator / set_sample_points_locations); ``build(device)``
    produces the (SGSStatic, SGSConsts) pair that ``parallel.sampler``
    runs."""

    def __init__(self, xx, yy, initial_bed, surf, velx, vely, dhdt, smb,
                 cond_bed, data_mask, grounded_ice_mask, resolution):
        shapes = {np.shape(a) for a in (initial_bed, surf, velx, vely, dhdt,
                                        smb, cond_bed, data_mask)}
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
        self.sigma_mc = None
        self.do_transform = False
        self.nst_trans: Optional[NormalScoreTransform] = None
        self.trend = None
        self.detrend_map = False
        self.vario: Optional[VariogramConfig] = None
        self.sgs_params: Optional[SGSParams] = None
        self.block_min_x = self.block_max_x = None
        self.block_min_y = self.block_max_y = None
        self.sample_loc = None
        self.seed = None
        self._streams = None  # the single-chain run's stream, continued
        self._host_nst = None
        self._initial_detrended = None
        self._initial_z = None

    # --- reference-parity setters ------------------------------------------

    def set_update_region(self, update_in_region, region_mask=None):
        """Restrict proposal centres to ``region_mask`` cells (reference
        chain.set_update_region, MCMC.py:849-872)."""
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

    def set_loss_type(self, sigma_mc=-1, massConvInRegion=True):
        """Gaussian mass-conservation loss (reference chain.set_loss_type,
        MCMC.py:950-1018)."""
        cfg = LossConfig(sigma_mc=sigma_mc,
                         mass_conv_in_region=massConvInRegion)
        self.sigma_mc = cfg.sigma_mc
        self.mc_region_mask = (self.region_mask if massConvInRegion
                               else np.ones(self.xx.shape, np.float32))

    def set_normal_transformation(self, nst_trans, do_transform=True):
        """Attach the normal-score transform of the (detrended) state
        (reference MCMC.py:1465-1480; a ``NormalScoreTransform`` or a fitted
        sklearn QuantileTransformer)."""
        self.do_transform = bool(do_transform)
        self.nst_trans = nst_trans if do_transform else None

    def set_trend(self, trend=None, detrend_map=True):
        """Smooth trend subtracted before transform and simulation and
        re-added for the physics (reference MCMC.py:1482-1503)."""
        if detrend_map:
            trend = np.asarray(trend) if trend is not None else None
            if trend is None or trend.shape != self.xx.shape:
                raise ValueError(
                    "if detrend_map is set to True, then the trend of the "
                    "topography, which is a 2D numpy array, must be "
                    "provided")
            self.trend = trend.astype(np.float32)
        else:
            self.trend = None
        self.detrend_map = bool(detrend_map)

    def set_variogram(self, vario_type, vario_range, vario_sill,
                      vario_nugget, isotropic=True, vario_smoothness=None,
                      vario_azimuth=None):
        """Variogram of the transformed residual field (reference
        MCMC.py:1505-1543)."""
        if isotropic:
            self.vario = VariogramConfig.isotropic(
                vario_type, vario_range, vario_sill, vario_nugget,
                smoothness=vario_smoothness)
        else:
            if not (hasattr(vario_range, "__len__")
                    and len(vario_range) == 2):
                raise ValueError(
                    "vario_range need to be a list with two floats to "
                    "specifying for major range and minor range of the "
                    "variogram when isotropic is set to False")
            self.vario = VariogramConfig(
                vtype=vario_type, major_range=vario_range[0],
                minor_range=vario_range[1], sill=vario_sill,
                nugget=vario_nugget, azimuth=vario_azimuth or 0.0,
                smoothness=vario_smoothness)

    def set_sgs_param(self, sgs_num_nearest_neighbors, sgs_searching_radius,
                      sgs_rand_dropout_on=False, dropout_rate=0.0):
        """Conditioning knobs (reference MCMC.py:1545-1561): the draw
        conditions on the num_neighbors nearest non-simulated window cells
        within search_radius of the block; the radius also sizes the window
        margin (2 to 8 cells)."""
        self.sgs_params = SGSParams(
            num_neighbors=sgs_num_nearest_neighbors,
            search_radius=sgs_searching_radius,
            rand_dropout_on=sgs_rand_dropout_on, dropout_rate=dropout_rate)

    def set_block_sizes(self, block_min_x, block_max_x, block_min_y,
                        block_max_y):
        """Half-open per-axis bounds of the uniformly drawn block sizes
        (reference MCMC.py:1563-1597)."""
        self.block_min_x, self.block_max_x = int(block_min_x), int(
            block_max_x)
        self.block_min_y, self.block_max_y = int(block_min_y), int(
            block_max_y)

    def loss(self, massConvResidual, dataDiff=0):
        """Loss of a candidate topography (reference MCMC.py:1021-1044).
        Returns (total, loss_mc, loss_data=0)."""
        if self.sigma_mc is None:
            raise ValueError("call set_loss_type before loss()")
        loss_mc = chain_loss_mc(massConvResidual, self.mc_region_mask,
                                self.sigma_mc)
        return loss_mc, loss_mc, 0.0

    def set_random_generator(self, rng_seed=None):
        """Seed for the samplers built from this chain: an int, None for
        fresh entropy, or a list of per-chain seeds (one stream a
        chain).  The next ``run`` starts from it, not from the last run's
        stream."""
        self.seed = resolve_seed(rng_seed)
        self._streams = None

    def set_sample_points_locations(self, loc):
        """(n, 2) (x, y) posterior probe points traced every iteration
        (reference MCMC.py:1068-1081; nearest-cell lookup)."""
        self.sample_loc = None if loc is None else np.asarray(loc)

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

    def _coerce_nst(self):
        nst = self.nst_trans
        if nst is None:
            raise ValueError("set_normal_transformation(nst, True) requires "
                             "a fitted transform")
        if not isinstance(nst, NormalScoreTransform):
            nst = NormalScoreTransform(
                quantiles=np.asarray(nst.quantiles_).ravel(),
                references=np.asarray(nst.references_).ravel())
        return nst

    def preprocess_beds(self, beds):
        """Detrend, then the reference's whole-grid transform -> inverse
        clamp (MCMC.py:1644-1659), of full-space beds (H, W) or (n, H, W),
        on the host: the same preprocessing ``build`` gives the initial
        bed."""
        beds = np.asarray(beds, np.float32)
        trend = (self.trend if self.detrend_map
                 else np.zeros(self.xx.shape, np.float32))
        out = beds - trend
        if self.do_transform:
            nst = self._coerce_nst()
            out = np.asarray(nst.inverse_np(nst.transform_np(out)),
                             np.float32)
        return out

    def build(self, device="cuda"):
        """The configured chain as (SGSStatic, SGSConsts) on ``device``
        (the card unless the caller asks for the CPU)."""
        if self.sigma_mc is None:
            raise ValueError("call set_loss_type before building the chain")
        if self.vario is None:
            raise ValueError("call set_variogram before building the chain")
        if self.block_max_x is None:
            raise ValueError("call set_block_sizes before building the "
                             "chain")
        if self.sgs_params is None:
            self.sgs_params = SGSParams(num_neighbors=32, search_radius=30e3)
        device = resolve_device(device)
        H, W = self.xx.shape
        rad_cells = int(np.ceil(self.sgs_params.search_radius
                                / self.resolution))
        M = int(np.clip(rad_cells, 2, 8))
        BMX, BMY = self.block_max_x, self.block_max_y
        SB = int(min(H, W, max(BMX, BMY) + 2 * M))
        if SB < max(BMX, BMY) + 4 and (H > SB or W > SB):
            raise ValueError("grid too small for the configured block sizes")
        # a grid-clipped window shrinks the margin so a max-size block
        # starting at bxmin - M always fits inside it
        M = (max(2, (SB - max(BMX, BMY)) // 2)
             if SB < max(BMX, BMY) + 2 * M else M)
        K = int(np.clip(self.sgs_params.num_neighbors, 1, SB * SB - 1))

        trend = (self.trend if self.detrend_map
                 else np.zeros(self.xx.shape, np.float32))
        bed0 = self.preprocess_beds(self.initial_bed)
        cond0 = self.cond_bed - trend
        # conditioning needs data_mask AND a finite cond_bed
        dmask = (np.asarray(self.data_mask, bool)
                 & np.isfinite(np.asarray(cond0)))

        if self.do_transform:
            nst = self._coerce_nst()
            z_cond = np.asarray(nst.transform_np(
                np.where(np.isnan(cond0), 0.0, cond0)), np.float32)
            z_cond = np.where(dmask, z_cond, 0.0)
            mean_z = 0.0
            lut = NormalScoreLUT.from_transform(nst, device=device)
            self._host_nst = nst
            initial_z = np.asarray(nst.transform_np(bed0), np.float32)
        else:
            z_cond = np.where(dmask, np.nan_to_num(cond0), 0.0)
            cvals = np.asarray(cond0)[np.isfinite(np.asarray(cond0))]
            mean_z = float(cvals.mean()) if cvals.size else 0.0
            # identity placeholder: use_transform=False never reads it
            eye = torch.tensor([[0.0, 1.0], [1.0, 1.0]], device=device)
            lut = NormalScoreLUT(fwd_lo=0.0, fwd_scale=1.0, fwd_table=eye,
                                 inv_lo=0.0, inv_scale=1.0, inv_table=eye)
            self._host_nst = None
            initial_z = None

        viol0 = np.sum(((self.surf - self.initial_bed) <= 0)
                       & (np.asarray(self.grounded_ice_mask) > 0))
        if viol0 > 0:
            warnings.warn(
                f"initial bed violates thickness>0 at {viol0} grounded "
                "cells; the reference chain would reject every proposal "
                "(MCMC.py:1789-1795). Sanitize the initial bed as the "
                "reference drivers do.")

        region = (np.argwhere(self.region_mask == 1) if self.update_in_region
                  else np.argwhere(np.ones(self.xx.shape, bool)))
        if region.shape[0] == 0:
            raise ValueError("region_mask selects no cells")
        spec = CovarianceSpec(self.vario.vtype.lower(),
                              s=self.vario.smoothness)
        rot = make_rotation_matrix(self.vario.azimuth,
                                   self.vario.major_range,
                                   self.vario.minor_range)
        rot_np = rot.numpy().astype(np.float64)
        cov_stamp, embed_spec, embed_sqrt, NE, NA = _embedding_spectra(
            spec, rot_np, self.vario.sill, self.vario.nugget, SB,
            self.resolution)

        # analytic S_CC mixture over the window's distance range, accepted
        # when its max abs error is below the solve's own diagonal jitter
        Q = rot_np @ rot_np.T
        qcoef = np.array([Q[0, 0], 2.0 * Q[0, 1], Q[1, 1]],
                         np.float64) * self.resolution ** 2
        S1 = float(SB - 1)
        h_max = max(
            float(np.sqrt(qcoef[0] * dj * dj + qcoef[1] * dj * di
                          + qcoef[2] * di * di))
            for dj, di in ((S1, S1), (S1, -S1)))
        amp = self.vario.sill - self.vario.nugget
        mix_tol = 1e-3 * max(abs(amp), 1e-6)
        mix_ag, mix_bg, mix_ae, mix_be, mix_err = fit_cov_mixture(
            spec, self.vario.sill, self.vario.nugget, h_max * 1.02,
            target_err=mix_tol)
        if mix_err > mix_tol:
            mix_ag = mix_bg = mix_ae = mix_be = np.zeros((0,), np.float32)
        sample_ij = self._sample_ij()
        dropout = bool(self.sgs_params.rand_dropout_on
                       and self.sgs_params.dropout_rate > 0)
        # CG budget by covariance smoothness (override with chain.cg_iters)
        rough = (spec.vtype == "exponential"
                 or (spec.vtype == "matern" and (spec.s or 0.5) <= 0.5))
        budget = 32 if rough else (48 if spec.vtype == "spherical" else 64)
        cg_iters = int(getattr(self, "cg_iters", 0)) or min(budget, K + 16)
        mix_static = ()
        if mix_ag.shape[0] + mix_ae.shape[0] > 0:
            mix_static = tuple(
                tuple(float(v) for v in np.asarray(a, np.float32))
                for a in (mix_ag, mix_bg, mix_ae, mix_be, qcoef))
        static = SGSStatic(
            H=H, W=W, SB=SB, BMX=BMX, BMY=BMY, M=M, K=K,
            n_region=int(region.shape[0]), P=int(sample_ij.shape[0]),
            spec=spec, use_transform=self.do_transform,
            detrend=self.detrend_map, dropout=dropout,
            has_nugget=self.vario.nugget > 0, cg_iters=cg_iters, NE=NE,
            NA=NA, Mg=int(mix_ag.shape[0]), Me=int(mix_ae.shape[0]),
            mix=mix_static)
        stacked = np.stack([
            self.surf, self.velx, self.vely, self.dhdt, self.smb,
            np.asarray(trend, np.float32),
            np.asarray(self.grounded_ice_mask, np.float32),
            np.asarray(self.mc_region_mask == 1, np.float32),
            np.asarray(z_cond, np.float32),
            np.asarray(dmask, np.float32),
        ]).astype(np.float32)

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        consts = SGSConsts(
            stacked=dev(stacked),
            region_cells=dev(region, torch.int64),
            sample_ij=dev(sample_ij, torch.int64),
            nst=lut,
            cov_stamp=dev(cov_stamp), embed_spec=dev(embed_spec),
            embed_sqrt=dev(embed_sqrt), rot=rot.to(device),
            sill=_f32(self.vario.sill), nugget=_f32(self.vario.nugget),
            sigma_mc=_f32(self.sigma_mc), resolution=_f32(self.resolution),
            block_min_x=self.block_min_x, block_max_x=self.block_max_x,
            block_min_y=self.block_min_y, block_max_y=self.block_max_y,
            dropout_rate=_f32(self.sgs_params.dropout_rate),
            search_radius=_f32(self.sgs_params.search_radius),
            mean_z=_f32(mean_z),
            mix_ag=dev(mix_ag), mix_bg=dev(mix_bg), mix_ae=dev(mix_ae),
            mix_be=dev(mix_be), qcoef=dev(qcoef))
        self._initial_detrended = bed0
        self._initial_z = initial_z
        return static, consts

    def host_transform(self, bed_detrended):
        """Exact normal-score transform of a (batched) detrended bed on the
        host (the z-plane for ``sgs_init_state``); None without a
        transform."""
        if not self.do_transform:
            return None
        if self._host_nst is None:
            raise ValueError("call build() before host_transform()")
        return np.asarray(self._host_nst.transform_np(
            np.asarray(bed_detrended)), np.float32)

    def run(self, n_iter, only_save_last_bed=True, info_per_iter=100,
            plot=False, progress_bar=False, *, save_beds=None, seed=None,
            device=None):
        """Single-chain convenience run, positional order as the
        reference's ``chain_sgs.run(n_iter, only_save_last_bed,
        info_per_iter, plot, progress_bar)`` (MCMC.py:1599) with the JAX
        package's defaults; ``save_beds``, ``seed`` and ``device`` are
        keyword-only.  A one-chain farm, seeded, continued and segmented
        as ``ChainCRF.run``'s; ``bed`` is in data space (the trend
        restored), and row 0's ``loss_data`` is 0.  ``final_state`` is the
        port's ``SGSState``, with its leading axis of 1."""
        return run_single_chain(self, n_iter, only_save_last_bed,
                                info_per_iter, plot, progress_bar, save_beds,
                                seed, device)
