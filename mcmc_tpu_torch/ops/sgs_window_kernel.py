"""The SGS chain's window extract and window writeback, batched over
chains.

Each step of the SGS chain works on one (SB, SB) window per chain, at a
per-chain start (sx, sy) that ``models/chain_sgs.window_start`` clamps
into [0, H - SB] x [0, W - SB]:

- extract: ``windows[i, :NP] = cons[:, sx:sx+SB, sy:sy+SB]`` and
  ``windows[i, NP:] = fields[i, :, sx:sx+SB, sy:sy+SB]``, (N, NP+NS, SB,
  SB) from the (NP, H, W) shared planes and the (N, NS, H, W) state;
- writeback: ``fields[i, :, sx:sx+SB, sy:sy+SB] = new_w[i]`` where
  ``write[i]``, IN PLACE; the other chains' planes are not touched.

Pure data movement: the kernels and their plain versions agree bitwise.
Three pieces each, as for every kernel of the port:

- ``window_extract_reference`` / ``window_writeback_reference``: plain
  PyTorch (advanced indexing);
- ``csrc/sgs_window_kernel.cu``: the hand-written CUDA kernels for Hopper
  that replace the Pallas kernels ``mcmc_tpu/ops/sgs_window_kernel.py::
  make_window_extract`` and ``make_window_writeback``: one CTA per (chain,
  plane); where W % 8 == 0 the writeback writes whole 32-byte sectors,
  rewriting the cells beside the window unchanged
  (``sgs_window_kernel_info``);
- ``window_extract`` / ``window_writeback``: the dispatchers.  A CPU
  tensor goes to the plain version; a CUDA tensor launches the kernel or
  raises.  Nothing falls back.  ``.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .launch_counts import counted


def _window_index(sx, sy, SB: int):
    """(N, SB, 1) rows and (N, 1, SB) cols of each chain's window."""
    ar = torch.arange(SB, device=sx.device)
    rows = (sx.long()[:, None] + ar)[:, :, None]
    cols = (sy.long()[:, None] + ar)[:, None, :]
    return rows, cols


def window_extract_reference(cons, fields, sx, sy, SB: int):
    """Plain PyTorch window extract (module docstring); any device."""
    N = fields.shape[0]
    rows, cols = _window_index(sx, sy, SB)
    n3 = torch.arange(N, device=fields.device)[:, None, None]
    cw = cons[:, rows, cols].permute(1, 0, 2, 3)        # (N, NP, SB, SB)
    sw = fields[n3, :, rows, cols].permute(0, 3, 1, 2)  # (N, NS, SB, SB)
    return torch.cat([cw, sw], dim=1)


def window_writeback_reference(fields, new_w, sx, sy, write):
    """Plain PyTorch window writeback (module docstring), in place; any
    device.  Rejected chains rewrite the values just read, which leaves
    their planes bitwise unchanged without a host sync on ``write``."""
    N, NS = fields.shape[:2]
    SB = new_w.shape[-1]
    rows, cols = _window_index(sx, sy, SB)
    n3 = torch.arange(N, device=fields.device)[:, None, None]
    old = fields[n3, :, rows, cols].permute(0, 3, 1, 2)
    new = torch.where(write[:, None, None, None], new_w, old)
    fields[n3, :, rows, cols] = new.permute(0, 2, 3, 1)
    return fields


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, fields on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bind_library(lib):
    """Type the two launches' C entry points of a loaded
    ``sgs_window_kernel`` library (this one, or another checkout's in
    ``ab_window_kernels.py``); untyped, ctypes cuts the pointers."""
    lib.mcmc_window_extract.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.mcmc_window_extract.restype = ctypes.c_int
    lib.mcmc_window_writeback.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.mcmc_window_writeback.restype = ctypes.c_int
    lib.mcmc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_library():
    from .cuda_build import load_library

    lib = load_library("sgs_window_kernel").lib
    if lib.mcmc_window_extract.argtypes is None:
        bind_library(lib)
        lib.mcmc_window_writeback_in_window.argtypes = (
            lib.mcmc_window_writeback.argtypes)
        lib.mcmc_window_writeback_in_window.restype = ctypes.c_int
        lib.mcmc_window_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.mcmc_window_info.restype = ctypes.c_int
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.mcmc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


WINDOW_KERNELS = ("extract", "writeback_in_window", "writeback_sectors")


def sgs_window_kernel_info(kernel: str, device=None) -> dict:
    """The launch of one of ``WINDOW_KERNELS`` (the extract; the writeback
    of the window's own cells; the full-sector writeback, which the
    dispatcher takes where W % 8 == 0) as the CUDA runtime reports it on
    the card: threads a CTA, registers and local (spill) bytes a thread,
    resident CTAs a multiprocessor.  Each launch runs one CTA per (chain,
    plane)."""
    lib = _cuda_library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(torch.device("cuda" if device is None
                                        else device)):
        _raise_on(lib, lib.mcmc_window_info(WINDOW_KERNELS.index(kernel),
                                            ctypes.addressof(out)),
                  "window info")
    return dict(zip(("threads", "registers", "local_bytes",
                     "resident_ctas_per_sm"), list(out)))


def launch_extract(fn, cons, fields, sx, sy, SB: int):
    """Check CUDA operands and launch the extract entry point ``fn`` (this
    library's, or another checkout's in ``ab_window_kernels.py``) on the
    current stream; returns the (N, NP + NS, SB, SB) windows."""
    N, NS, H, W = fields.shape
    NP = cons.shape[0]
    dev = fields.device
    _check("fields", fields, torch.float32, None, dev)
    _check("cons", cons, torch.float32, (NP, H, W), dev)
    _check("sx", sx, torch.int32, (N,), dev)
    _check("sy", sy, torch.int32, (N,), dev)
    if not 0 < SB <= min(H, W):
        raise ValueError(f"window size {SB} does not fit the {H}x{W} grid")
    out = torch.empty((N, NP + NS, SB, SB), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(cons.data_ptr(), fields.data_ptr(), sx.data_ptr(),
                 sy.data_ptr(), out.data_ptr(), N, NP, NS, H, W, SB, stream)
    _raise_on(_cuda_library(), err, "window extract")
    return out


def launch_writeback(fn, fields, new_w, sx, sy, write):
    """Check CUDA operands and launch the writeback entry point ``fn``
    (as ``launch_extract``) on the current stream, in place."""
    N, NS, H, W = fields.shape
    SB = new_w.shape[-1]
    dev = fields.device
    _check("fields", fields, torch.float32, None, dev)
    _check("new_w", new_w, torch.float32, (N, NS, SB, SB), dev)
    _check("sx", sx, torch.int32, (N,), dev)
    _check("sy", sy, torch.int32, (N,), dev)
    _check("write", write, torch.bool, (N,), dev)
    if not 0 < SB <= min(H, W):
        raise ValueError(f"window size {SB} does not fit the {H}x{W} grid")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(fields.data_ptr(), new_w.data_ptr(), sx.data_ptr(),
                 sy.data_ptr(), write.data_ptr(), N, NS, H, W, SB, stream)
    _raise_on(_cuda_library(), err, "window writeback")
    return fields


@counted("21window_extract_kernel")
def window_extract(cons, fields, sx, sy, SB: int):
    """Window extract (module docstring): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if fields.device.type == "cpu":
        return window_extract_reference(cons, fields, sx, sy, SB)
    if fields.device.type != "cuda":
        raise ValueError(f"no window extract kernel for {fields.device}")
    out = launch_extract(_cuda_library().mcmc_window_extract, cons, fields,
                         sx, sy, SB)
    window_extract.launches += 1
    return out


@counted("23window_writeback_kernel")
def window_writeback(fields, new_w, sx, sy, write):
    """Window writeback (module docstring), in place: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    if fields.device.type == "cpu":
        return window_writeback_reference(fields, new_w, sx, sy, write)
    if fields.device.type != "cuda":
        raise ValueError(f"no window writeback kernel for {fields.device}")
    launch_writeback(_cuda_library().mcmc_window_writeback, fields, new_w,
                     sx, sy, write)
    window_writeback.launches += 1
    return fields
