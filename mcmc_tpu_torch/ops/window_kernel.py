"""The CRF chain's fused window update, batched over chains.

One call runs the whole window phase of one Metropolis-Hastings step for
every chain: finish the proposal, perturb the bed over the block, the
windowed mass-conservation residual, the NaN-safe loss delta (plus the
optional data-misfit delta), the thickness guard, the MH accept against
``u``, and the conditional in-place writeback of the three state planes.

Three pieces, as for every kernel of the port:

- ``fused_window_update_reference``: the plain PyTorch version, vectorised
  over chains (gathers each chain's (S, S) window, S = B + 4, by advanced
  indexing as ``mcmc_tpu/models/chain_crf.py::make_kernel`` slices it, and
  scatters it back with ``index_put_``).
- ``csrc/window_kernel.cu``: the hand-written CUDA kernel for Hopper that
  replaces the Pallas kernel ``mcmc_tpu/ops/window_kernel.py::
  make_fused_window_update``.
- ``fused_window_update``: the dispatcher.  A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises.  Nothing falls
  back.  ``fused_window_update.launches`` counts kernel launches.
  ``window_launch_config`` is the launch's one configuration (threads,
  the tile's shared bytes), which the dispatcher hands to the kernel; it
  refuses a canvas whose tile does not fit.  ``window_kernel_info`` reads
  the built kernel's registers and resident CTAs off the card.

Both update ``fields`` IN PLACE (the Pallas kernel aliases it input to
output) and return ``(accept, delta, delta_data)``, each ``(N,)`` float32
with the deltas zeroed unless the chain accepted.

Operands: ``consts`` (6 or 8, H, W) packed planes [surf, velx, vely,
forcing, maskpack, crf_weight, cond_bed, data_loss_mask]; ``fields``
(N, 3, H, W) [bed, mc_res, resampled]; ``fraw`` (N, B, B) raw spectral
fields (finished fields when ``prefinished``); ``edge_masks``
(n_sizes, B, B); ``geom`` (N, 9) int32 from ``window_geometry`` [bxmin,
bxmax, bymin, bymax, off_x, off_y, h, w, size_idx]; ``fvals`` (N, 6)
float32 [u, loss_prev, sigma_mc, resolution, sigma_data, scale].
"""

from __future__ import annotations

import ctypes

import torch

from .launch_counts import counted
from .spectral import block_mask, standardize_masked

# the shared memory one block of an H100 can opt in to (227 KB)
MAX_SHARED_BYTES = 232_448


def window_launch_config(B: int):
    """``(threads, dynamic shared bytes)`` of the kernel's launch for a
    (B, B) proposal canvas: one CTA of 256 threads per chain staging a
    (B + 3, B + 2) float32 tile (csrc/window_kernel.cu, which refuses any
    other thread count).  A canvas whose tile does not fit one block's
    shared memory is refused here, before any launch; the runtime refuses
    a tile that leaves no room for the kernel's static scratch."""
    if B < 1:
        raise ValueError(f"the proposal canvas must be at least 1 wide, "
                         f"got B = {B}")
    smem = 4 * (B + 3) * (B + 2)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"B = {B}: the window kernel stages a ({B + 3}, {B + 2}) float32 "
            f"tile, {smem} bytes of shared memory, above the "
            f"{MAX_SHARED_BYTES} a block can have; use smaller blocks")
    return 256, smem


def window_geometry(cx, cy, h, w, size_idx, H: int, W: int):
    """(N, 9) int32 block geometry with floor semantics, as
    ``mcmc_tpu/models/chain_crf.py:210-215`` computes it: the block spans
    rows [bxmin, bxmax) and cols [bymin, bymax); global row g maps to
    field row g - off_x."""
    def fdiv2(x):
        return torch.div(x, 2, rounding_mode="floor")

    lo_x, hi_x = fdiv2(2 * cx - h), fdiv2(2 * cx + h)
    lo_y, hi_y = fdiv2(2 * cy - w), fdiv2(2 * cy + w)
    return torch.stack([
        torch.clamp(lo_x, min=0), torch.clamp(hi_x, max=H),
        torch.clamp(lo_y, min=0), torch.clamp(hi_y, max=W),
        lo_x, lo_y, h, w, size_idx], dim=1).to(torch.int32)


def _nansq(x):
    s = x * x
    return torch.where(torch.isnan(s), torch.zeros_like(s), s)


def _window_residual(surf, bed_new, velx, vely, forcing, resolution):
    """numpy-gradient residual of (N, S, S) windows; ``resolution`` (N,)."""
    r = resolution[:, None, None]
    two_r = 2.0 * r
    thick = surf - bed_new
    fx = velx * thick
    fy = vely * thick
    dx = torch.cat([(fx[:, :, 1:2] - fx[:, :, 0:1]) / r,
                    (fx[:, :, 2:] - fx[:, :, :-2]) / two_r,
                    (fx[:, :, -1:] - fx[:, :, -2:-1]) / r], dim=2)
    dy = torch.cat([(fy[:, 1:2, :] - fy[:, 0:1, :]) / r,
                    (fy[:, 2:, :] - fy[:, :-2, :]) / two_r,
                    (fy[:, -1:, :] - fy[:, -2:-1, :]) / r], dim=1)
    return dx + dy + forcing


def fused_window_update_reference(consts, fields, fraw, edge_masks, geom,
                                  fvals, *, use_data_loss=False,
                                  prefinished=False):
    """Plain PyTorch version of the fused window update (module docstring);
    any device."""
    N, _, H, W = fields.shape
    B = fraw.shape[-1]
    S = min(H, W, B + 4)
    g = geom.long()
    bxmin, bxmax, bymin, bymax, off_x, off_y, h, w, size_idx = g.unbind(1)
    u, loss_prev, sigma, resolution, sigma_data, scale = fvals.unbind(1)

    # finish the proposal: standardized over its (h, w) block, scaled,
    # edge-masked (a nugget configuration hands it over finished)
    f = fraw if prefinished else (
        standardize_masked(fraw, block_mask(h, w, B))
        * scale[:, None, None] * edge_masks[size_idx])

    ar = torch.arange(S, device=fields.device)
    rows = torch.clamp(bxmin - 1, 0, H - S)[:, None] + ar      # (N, S)
    cols = torch.clamp(bymin - 1, 0, W - S)[:, None] + ar
    in_block = (((rows >= bxmin[:, None]) & (rows < bxmax[:, None]))[:, :, None]
                & ((cols >= bymin[:, None]) & (cols < bymax[:, None]))[:, None, :])
    r3, c3 = rows[:, :, None], cols[:, None, :]
    n3 = torch.arange(N, device=fields.device)[:, None, None]

    NP = 8 if use_data_loss else 6
    cw = consts[:NP][:, r3, c3]                                # (NP, N, S, S)
    surf, velx, vely, forcing, mp, crfw = cw[:6]
    upd = mp - 2.0 * torch.floor(mp * 0.5)
    sw = fields[n3, :, r3, c3].permute(0, 3, 1, 2)             # (N, 3, S, S)
    bed, res_old, resampled = sw.unbind(1)

    # proposal cell of each window cell (clamped; used only inside the block)
    fr = torch.clamp(rows - off_x[:, None], 0, B - 1)[:, :, None]
    fc = torch.clamp(cols - off_y[:, None], 0, B - 1)[:, None, :]
    moved = in_block & (upd > 0)
    pert = torch.where(moved, f[n3, fr, fc] * crfw, torch.zeros_like(bed))
    bed_new = bed + pert
    res_new = _window_residual(surf, bed_new, velx, vely, forcing, resolution)

    zero = torch.zeros_like(bed)
    patch = in_block & (mp >= 2.0)
    delta = ((torch.where(patch, _nansq(res_new), zero).sum(dim=(1, 2))
              - torch.where(patch, _nansq(res_old), zero).sum(dim=(1, 2)))
             / (2.0 * sigma * sigma))
    if use_data_loss:
        cond, dmask = cw[6], cw[7]
        dpatch = in_block & (dmask > 0)
        delta_data = (
            (torch.where(dpatch, _nansq(bed_new - cond), zero).sum(dim=(1, 2))
             - torch.where(dpatch, _nansq(bed - cond), zero).sum(dim=(1, 2)))
            / (2.0 * sigma_data * sigma_data))
    else:
        delta_data = torch.zeros_like(delta)

    viol = (((surf - bed_new) <= 0.0) & moved).flatten(1).any(dim=1)
    loss_next = torch.where(viol, torch.full_like(delta, float("inf")),
                            loss_prev + delta + delta_data)
    rate = torch.clamp(torch.exp(loss_prev - loss_next), max=1.0)
    ok = (u <= rate) & ~viol

    new = torch.stack([bed_new, torch.where(in_block, res_new, res_old),
                       resampled + torch.where(in_block, upd, zero)], dim=1)
    new = torch.where(ok[:, None, None, None], new, sw)
    fields[n3, :, r3, c3] = new.permute(0, 2, 3, 1)
    zn = torch.zeros_like(delta)
    return (ok.to(torch.float32), torch.where(ok, delta, zn),
            torch.where(ok, delta_data, zn))


def _check_cuda_operands(consts, fields, fraw, edge_masks, geom, fvals,
                         use_data_loss):
    N, _, H, W = fields.shape
    B = fraw.shape[-1]
    want = {
        "consts": (consts, torch.float32, None),
        "fields": (fields, torch.float32, (N, 3, H, W)),
        "fraw": (fraw, torch.float32, (N, B, B)),
        "edge_masks": (edge_masks, torch.float32, None),
        "geom": (geom, torch.int32, (N, 9)),
        "fvals": (fvals, torch.float32, (N, 6)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != fields.device:
            raise ValueError(f"{name} is on {t.device}, fields on "
                             f"{fields.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    NP = 8 if use_data_loss else 6
    if (consts.dim() != 3 or consts.shape[0] < NP
            or tuple(consts.shape[1:]) != (H, W)):
        raise ValueError(f"consts must be ({NP}+, {H}, {W}), got "
                         f"{tuple(consts.shape)}")
    if edge_masks.dim() != 3 or tuple(edge_masks.shape[1:]) != (B, B):
        raise ValueError(f"edge_masks must be (n_sizes, {B}, {B}), got "
                         f"{tuple(edge_masks.shape)}")


def _cuda_library():
    from .cuda_build import load_library

    kl = load_library("window_kernel")
    fn = kl.lib.mcmc_fused_window_update
    if fn.argtypes is None:  # without argtypes ctypes would cut pointers
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        kl.lib.mcmc_fused_window_info.argtypes = [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        kl.lib.mcmc_fused_window_info.restype = ctypes.c_int
        kl.lib.mcmc_cuda_error_string.argtypes = [ctypes.c_int]
        kl.lib.mcmc_cuda_error_string.restype = ctypes.c_char_p
    return kl.lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.mcmc_cuda_error_string(err).decode()
        raise RuntimeError(f"window kernel {what} failed: {msg} ({err})")


def window_kernel_info(B: int) -> dict:
    """The built kernel's launch at canvas size ``B`` as the CUDA runtime
    reports it on the current card: threads, dynamic and static shared
    bytes, registers and local (spill) bytes a thread, and resident CTAs
    a multiprocessor."""
    threads, smem = window_launch_config(B)
    lib = _cuda_library()
    out = (ctypes.c_int * 4)()
    _raise_on(lib, lib.mcmc_fused_window_info(threads, smem,
                                              ctypes.addressof(out)),
              "query")
    return dict(threads=threads, dynamic_shared_bytes=smem,
                **dict(zip(("static_shared_bytes", "registers", "local_bytes",
                            "resident_ctas_per_sm"), list(out))))


@counted("19fused_window_kernel")
def fused_window_update(consts, fields, fraw, edge_masks, geom, fvals, *,
                        use_data_loss=False, prefinished=False):
    """Fused window update (module docstring): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if fields.device.type == "cpu":
        return fused_window_update_reference(
            consts, fields, fraw, edge_masks, geom, fvals,
            use_data_loss=use_data_loss, prefinished=prefinished)
    if fields.device.type != "cuda":
        raise ValueError(f"no window kernel for device {fields.device}")
    _check_cuda_operands(consts, fields, fraw, edge_masks, geom, fvals,
                         use_data_loss)
    N, _, H, W = fields.shape
    B = fraw.shape[-1]
    threads, smem = window_launch_config(B)
    lib = _cuda_library()
    out = torch.empty((3, N), dtype=torch.float32, device=fields.device)
    stream = torch.cuda.current_stream(fields.device).cuda_stream
    with torch.cuda.device(fields.device):
        err = lib.mcmc_fused_window_update(
            consts.data_ptr(), fields.data_ptr(), fraw.data_ptr(),
            edge_masks.data_ptr(), geom.data_ptr(), fvals.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            N, H, W, B, int(bool(use_data_loss)), int(bool(prefinished)),
            threads, smem, stream)
    _raise_on(lib, err, "launch")
    fused_window_update.launches += 1
    return out[0], out[1], out[2]
