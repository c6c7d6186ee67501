"""The SGS step's K-nearest selection and its packed system's inputs,
batched over chains.

For chain n's (SB, SB) window, with ``rd``, ``cd`` (N, SB) integer row and
column distances to the block:

    candidate = cond_mask & (fl32(sqrt(rd² + cd²))·resolution <= radius)
    d2 = rd² + cd² (exact integers); T = the K-th smallest d2 over the
    candidates; taken: the candidates with d2 < T, then those at T by
    lowest window index, in window-index order (the JAX package's
    ``k_nearest_packed``); slot j holds the (j+1)-th cell taken:

    idx (N, K) int64   its raveled window index; SB² - 1 where fewer than
                       K candidates exist (masked downstream)
    sel (N, K) bool    the slot holds a cell;  m_sel = sel as float32
    iaf, jaf           idx // SB and idx % SB as float32
    rhs_p              z_w - z_u at idx where sel, else 0

Three pieces, as for every kernel of the port:

- ``k_nearest_reference``: the plain PyTorch version, the step's code
  before the kernel (``k_nearest_ops``: ``torch.kthvalue`` for T, the tie
  and rank ``cumsum`` scans, ``searchsorted``; then the gather and the
  casts); ``k_nearest_stages`` returns each of its ops by name;
- ``csrc/k_nearest.cu``: the hand-written CUDA kernel for Hopper, one CTA
  a chain (a histogram of d2 in shared memory, two block-wide scans).  It
  is the port's own kernel: the JAX package finds T by integer bisection
  in XLA ops (``mcmc_tpu/models/chain_sgs.py::_k_nearest_valid``) and has
  no Pallas kernel for it.  The float32 distance test is monotone in the
  integer d2, so the dispatcher turns it into d2 <= D once on the host
  (``_max_key``) and the kernel tests integers.  It agrees with the plain
  version bit for bit on all six outputs;
- ``k_nearest``: the dispatcher.  CPU tensors and ``impl="eager"`` go to
  the plain version; CUDA tensors launch the kernel or raise.  Nothing
  falls back.  ``k_nearest.launches`` counts kernel launches.

The plain version takes any SB; the kernel takes every SB whose histogram
of d2 and keys fit a CTA's opt-in shared memory on the card
(``kernel_max_sb``), and the dispatcher refuses a larger one, naming that
limit.  Both take K in 1 .. SB², and distances as the step makes them,
0 <= rd, cd < SB.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .launch_counts import counted

IMPLS = ("auto", "fused", "eager")


class KNearest(NamedTuple):
    """The selection's six outputs, each (N, K)."""

    idx: torch.Tensor     # int64 packed window indices
    sel: torch.Tensor     # bool
    m_sel: torch.Tensor   # float32 sel
    iaf: torch.Tensor     # float32 packed rows
    jaf: torch.Tensor     # float32 packed columns
    rhs_p: torch.Tensor   # float32 packed right-hand side


def k_nearest_ops(candidate, rd, cd, K: int) -> dict:
    """The K nearest candidates packed by window index, by op, in order:
    ``kthvalue`` (T), the ``tie cumsum`` and ``rank cumsum`` scans,
    ``searchsorted``, then the packed ``idx`` and ``sel``.

    ``candidate`` (N, SB, SB) bool; ``rd``, ``cd`` (N, SB) integer row and
    column distances to the block.  Squared distances are integers, so the
    K-th smallest one, T, is exact (``torch.kthvalue``; the JAX package
    finds the same T by integer bisection); cells strictly nearer than T
    are taken, then ties at T by lowest index."""
    N, SB = rd.shape
    big = 2 * SB * SB  # > any real squared distance
    d2 = (rd.long()[:, :, None] ** 2 + cd.long()[:, None, :] ** 2)
    d2r = torch.where(candidate, d2, big).reshape(N, SB * SB)
    cand = candidate.reshape(N, SB * SB)
    T = torch.kthvalue(d2r, K, dim=1).values[:, None]
    strict = d2r < T
    ties = cand & (d2r == T)
    n_strict = strict.sum(dim=1, keepdim=True)
    tie_scan = torch.cumsum(ties.long(), dim=1)
    valid = strict | (ties & (tie_scan <= K - n_strict))
    rank = torch.cumsum(valid.long(), dim=1)          # inclusive
    js = torch.arange(K, device=rd.device).expand(N, K).contiguous()
    # index of the (j+1)-th valid cell = #{i : rank_i <= j}
    pos = torch.searchsorted(rank, js, right=True)
    return {"kthvalue": T, "tie cumsum": tie_scan, "rank cumsum": rank,
            "searchsorted": pos, "idx": torch.clamp(pos, max=SB * SB - 1),
            "sel": js < rank[:, -1:]}


def k_nearest_stages(cond_mask, rd, cd, radius: float, resolution: float,
                     z_w, z_u, K: int) -> dict:
    """The plain version by op (``candidate``, ``k_nearest_ops``' ops),
    then the six outputs by ``KNearest``'s names, on any device."""
    N, SB = rd.shape
    rdf, cdf = rd.to(torch.float32), cd.to(torch.float32)
    euclid = torch.sqrt(rdf[:, :, None] * rdf[:, :, None]
                        + cdf[:, None, :] * cdf[:, None, :]) * resolution
    candidate = cond_mask & (euclid <= radius)
    out = {"candidate": candidate, **k_nearest_ops(candidate, rd, cd, K)}
    idx, sel = out["idx"], out["sel"]
    dz = torch.where(cond_mask, z_w - z_u, 0.0).reshape(N, SB * SB)
    ia = torch.div(idx, SB, rounding_mode="floor")
    ja = idx - SB * ia
    out.update(m_sel=sel.to(torch.float32), iaf=ia.to(torch.float32),
               jaf=ja.to(torch.float32),
               rhs_p=torch.where(sel, torch.gather(dz, 1, idx), 0.0))
    return out


def k_nearest_reference(cond_mask, rd, cd, radius: float, resolution: float,
                        z_w, z_u, K: int) -> KNearest:
    """Plain PyTorch version (module docstring), on any device."""
    out = k_nearest_stages(cond_mask, rd, cd, radius, resolution, z_w, z_u,
                           K)
    return KNearest(*(out[name] for name in KNearest._fields))


def bind_library(lib):
    """Type the entry points of a built ``k_nearest.cu``; returns
    ``lib``."""
    lib.mcmc_k_nearest.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7)
    lib.mcmc_k_nearest.restype = ctypes.c_int
    lib.mcmc_k_nearest_max_sb.argtypes = [ctypes.c_void_p]
    lib.mcmc_k_nearest_max_sb.restype = ctypes.c_int
    lib.mcmc_k_nearest_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.mcmc_k_nearest_info.restype = ctypes.c_int
    lib.mcmc_k_nearest_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.mcmc_k_nearest_empty.restype = ctypes.c_int
    lib.mcmc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_library():
    from .cuda_build import load_library

    lib = load_library("k_nearest").lib
    if lib.mcmc_k_nearest.argtypes is None:  # else pointers are cut
        bind_library(lib)
    return lib


def _raise_on(err, what):
    if err != 0:
        msg = _cuda_library().mcmc_cuda_error_string(err).decode()
        raise RuntimeError(f"K-nearest kernel {what} failed: {msg} ({err})")


@functools.lru_cache(maxsize=64)
def _max_key(SB: int, radius: float, resolution: float) -> int:
    """D: the largest squared distance whose float32 distance test,
    fl(fl(sqrt(d2))·resolution) <= radius as the plain version rounds it,
    holds (-1 where none does).  The test is monotone in the exact integer
    d2 for a positive resolution, so it holds for 0 .. D and no other d2,
    and the kernel tests d2 <= D; a test that is not such a prefix (a
    resolution below 0 or infinite) is refused."""
    d2 = np.arange(2 * (SB - 1) ** 2 + 1, dtype=np.float32)
    ok = np.sqrt(d2) * np.float32(resolution) <= np.float32(radius)
    D = int(ok.sum()) - 1
    if not ok[:D + 1].all():
        raise ValueError(f"the K-nearest kernel takes a positive, finite "
                         f"resolution (its distance test must hold for the "
                         f"squared distances 0 .. D alone); got resolution "
                         f"{resolution}, radius {radius}")
    return D


@functools.lru_cache(maxsize=None)
def _max_sb(device_index: int) -> int:
    lib = _cuda_library()
    out = ctypes.c_int()
    with torch.cuda.device(device_index):
        _raise_on(lib.mcmc_k_nearest_max_sb(ctypes.addressof(out)), "query")
    return out.value


def _index(device) -> int:
    dev = torch.device("cuda" if device is None else device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def kernel_max_sb(device=None) -> int:
    """The largest window side SB the kernel takes on ``device`` (the
    current card by default): one chain's histogram of d2 (2 (SB - 1)² + 1
    16-bit counts), its SB² 16-bit keys and its distances in one CTA's
    opt-in shared memory, and SB² within the 15 bits the kernel's scan
    gives a count (computed beside the kernel, ``csrc/k_nearest.cu::
    max_sb``)."""
    return _max_sb(_index(device))


def k_nearest_kernel_info(SB: int, device=None) -> dict:
    """The kernel's launch at ``SB`` as the CUDA runtime reports it on the
    card: threads a CTA (one CTA a chain), dynamic and static shared
    bytes, registers and local (spill) bytes a thread, resident CTAs a
    multiprocessor."""
    lib = _cuda_library()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(_index(device)):
        _raise_on(lib.mcmc_k_nearest_info(int(SB), ctypes.addressof(out)),
                  "query")
    return dict(zip(("threads", "dynamic_shared_bytes",
                     "static_shared_bytes", "registers", "local_bytes",
                     "resident_ctas_per_sm"), list(out)))


def empty_launch(blocks: int, device=None):
    """Launch an empty kernel on ``blocks`` CTAs of the kernel's width on
    the current stream: the floor under any launch of that grid."""
    lib = _cuda_library()
    index = _index(device)
    with torch.cuda.device(index):
        _raise_on(lib.mcmc_k_nearest_empty(
            int(blocks), torch.cuda.current_stream(index).cuda_stream),
            "empty launch")


def _check_operands(cond_mask, rd, cd, z_w, z_u, K, impl):
    """The operand rules, held on both devices: a CPU or CUDA device,
    every tensor contiguous, on cond_mask's device, of its type and shape;
    K in 1 .. SB²; on the card, SB within the kernel's limit."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    if cond_mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no K-nearest kernel for device {cond_mask.device}")
    if rd.dim() != 2:
        raise ValueError(f"rd must be (N, SB), got {tuple(rd.shape)}")
    N, SB = rd.shape
    for name, t, dtype, shape in (
            ("cond_mask", cond_mask, torch.bool, (N, SB, SB)),
            ("rd", rd, torch.int64, (N, SB)),
            ("cd", cd, torch.int64, (N, SB)),
            ("z_w", z_w, torch.float32, (N, SB, SB)),
            ("z_u", z_u, torch.float32, (N, SB, SB))):
        if t.device != cond_mask.device:
            raise ValueError(f"{name} is on {t.device}, cond_mask on "
                             f"{cond_mask.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= K <= SB * SB:
        raise ValueError(f"K must be in 1 .. SB² = {SB * SB}; got {K}")
    if (cond_mask.device.type == "cuda" and impl != "eager"
            and SB > kernel_max_sb(cond_mask.device)):
        raise ValueError(
            f"the K-nearest kernel takes SB <= "
            f"{kernel_max_sb(cond_mask.device)} on this card (one chain's "
            f"histogram of squared distances in one CTA's shared memory); "
            f"got SB = {SB}")


@counted("16k_nearest_kernel")
def k_nearest(cond_mask, rd, cd, radius: float, resolution: float, z_w, z_u,
              K: int, impl: str = "auto") -> KNearest:
    """The K-nearest selection and the packed system's inputs (module
    docstring): the operands checked, then the plain version for CPU
    tensors or ``impl="eager"``, the CUDA kernel for CUDA tensors."""
    _check_operands(cond_mask, rd, cd, z_w, z_u, K, impl)
    if cond_mask.device.type == "cpu" or impl == "eager":
        return k_nearest_reference(cond_mask, rd, cd, radius, resolution,
                                   z_w, z_u, K)
    N, SB = rd.shape
    dev = cond_mask.device
    out = KNearest(
        idx=torch.empty((N, K), dtype=torch.int64, device=dev),
        sel=torch.empty((N, K), dtype=torch.bool, device=dev),
        **{name: torch.empty((N, K), dtype=torch.float32, device=dev)
           for name in ("m_sel", "iaf", "jaf", "rhs_p")})
    max_key = _max_key(SB, float(radius), float(resolution))
    lib = _cuda_library()
    with torch.cuda.device(dev):
        err = lib.mcmc_k_nearest(
            *(t.data_ptr() for t in (cond_mask, rd, cd, z_w, z_u)),
            max_key, N, SB, int(K),
            *(t.data_ptr() for t in out),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "launch")
    k_nearest.launches += 1
    return out


__all__ = ["KNearest", "k_nearest", "k_nearest_ops", "k_nearest_reference",
           "k_nearest_stages", "kernel_max_sb"]
