"""Per-chain draws for a farm seeded with a list of per-chain seeds: all of
a step's uniforms, indices and normals in one launch.

A farm seeded with a seed list (``utils/rng.PerChainStreams``) keys chain
c by its own 64-bit Philox key and counts steps on the device.  A step's
draws follow a static **draw plan**: a tuple of ``DrawEntry(name, slot,
kind, count, n, lo)`` (``entry``), each ``count`` values of one kind for
every chain
at the draw site ``slot`` (a fixed small int, ``SLOTS``).  The kernel
fills a per-chain float32 buffer (uniforms and normals) and an int64
buffer (indices); ``DrawPlan.views`` cuts them into the step's fields.
The conversions are fixed here:

- **Philox4x32-10**, the constants of ``csrc/noise_kernel.cu`` (those of
  curand and Random123), keyed by chain c's (k0, k1) and countered by
  (step low word, slot, call, step high word): every value is a pure
  function of (key c, step, slot, index), whatever the plan's layout or
  the number of chains;
- **uniform** on [0, 1): element e takes word e % 4 of call e // 4, and
  its top 24 bits times 2⁻²⁴;
- **index** in [lo, lo + n): element e takes words (2(e % 2), 2(e % 2) +
  1) of call e // 2 as x = w_a·2³² + w_b, and gives lo + ⌊x·n / 2⁶⁴⌋,
  the high word of the 64 × 32-bit product, whose bias is below 2⁻³² for
  n < 2³²;
- **normal**: call e // 4 gives elements 4c, 4c + 1 (r cos t, r sin t of
  words 0, 1) and 4c + 2, 4c + 3 (of words 2, 3), through the JAX
  kernel's Box–Muller (``noise_kernel.box_muller``: 24-bit uniforms, u1
  offset by 2⁻²⁵, the tail capped at √(50 ln 2)).

Three pieces, as for every kernel of the port:

- ``chain_draws_reference``: the plain PyTorch version, Philox in int64
  arithmetic (``noise_kernel.keyed_words``) and the index product split
  with ``noise_kernel._mulhilo``;
- ``csrc/chain_draws.cu``: the hand-written CUDA kernel for Hopper,
  tiles of a chain's calls with several Philox calls a thread under one
  key schedule past one wave of calls, a flat grid of one call a thread
  up to one, built with ``-fmad=false``: the
  two agree bitwise on the card.  It is the port's own kernel: the JAX
  package draws these values with ``jax.random`` under ``vmap``, not in
  Pallas;
- ``chain_draws``: the dispatcher.  CPU keys go to the plain version;
  CUDA keys launch the kernel or raise.  Nothing falls back.
  ``chain_draws.launches`` counts kernel launches.

``draw_plan(streams, plan, impl)`` is what the chain families call: one
launch, then the views.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .launch_counts import counted
from .noise_kernel import _mulhilo, box_muller, check_streams, keyed_words

UNIFORM, INDEX, NORMAL = 0, 1, 2
KINDS = {"uniform": UNIFORM, "index": INDEX, "normal": NORMAL}
# values a Philox call gives, and the alignment (elements) of an entry's
# columns, so that one call stores 16 bytes
PER_CALL = {UNIFORM: 4, INDEX: 2, NORMAL: 4}
MAX_ENTRIES = 16
# the draw sites: fixed, so a checkpointed stream draws the same values
# after any change of plan layout
SLOTS = {"size_idx": 1, "scale": 2, "nugget": 3, "range_x": 4,
         "range_y": 5, "cidx": 6, "u": 7, "nugget_noise": 8, "spectrum": 9,
         "bsx": 10, "bsy": 11, "noise": 12, "drop_u": 13, "wave_u": 14,
         "wave_theta": 15, "z1": 16, "z2": 17, "angle": 18}


@dataclasses.dataclass(frozen=True)
class DrawEntry:
    """``count`` values of ``kind`` ("uniform", "index" or "normal") for
    every chain at draw site ``slot``; an index lies in [lo, lo + n)."""

    name: str
    slot: int
    kind: str
    count: int
    n: int = 0
    lo: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {tuple(KINDS)}, got "
                             f"{self.kind!r}")
        if self.count < 1:
            raise ValueError(f"{self.name}: count must be >= 1")
        if self.kind == "index" and not 0 < self.n < 2 ** 32:
            raise ValueError(f"{self.name}: an index range needs 0 < n < "
                             f"2^32, got {self.n}")
        if not 0 <= self.slot < 2 ** 31:
            raise ValueError(f"{self.name}: slot {self.slot} is not a "
                             "non-negative int32")


def entry(name: str, kind: str, count: int = 1, n: int = 0, lo: int = 0):
    """A ``DrawEntry`` at the named site's slot (``SLOTS``)."""
    return DrawEntry(name=name, slot=SLOTS[name], kind=kind,
                     count=int(count), n=int(n), lo=int(lo))


class DrawPlan:
    """A static draw plan and its buffer layout: each entry's columns
    start at a multiple of 4 floats or 2 ints, and its calls at its
    first call ``call0`` within the chain's ``calls``."""

    def __init__(self, entries):
        self.entries = tuple(entries)
        if not 0 < len(self.entries) <= MAX_ENTRIES:
            raise ValueError(f"a plan holds 1 to {MAX_ENTRIES} entries")
        if len({e.name for e in self.entries}) != len(self.entries):
            raise ValueError("entry names must differ")
        rows, floats, ints, calls = [], 0, 0, 0
        for e in self.entries:
            kind = KINDS[e.kind]
            per = PER_CALL[kind]
            n_calls = -(-e.count // per)
            if kind == INDEX:
                out, ints = ints, ints + n_calls * per
            else:
                out, floats = floats, floats + n_calls * per
            rows.append((e.slot, kind, e.count, e.n, e.lo, out, calls))
            calls += n_calls
        self.floats, self.ints, self.calls = floats, ints, calls
        # one row an entry: slot, kind, count, n, lo, out column, call0;
        # the kernel's launcher reads it from host memory
        self.table = np.asarray(rows, dtype=np.int64)

    def views(self, fout, iout) -> dict:
        """{name: (N, count) view} of the kernel's two buffers."""
        out = {}
        for e, row in zip(self.entries, self.table):
            buf = iout if e.kind == "index" else fout
            start = int(row[5])
            out[e.name] = buf[:, start:start + e.count]
        return out


def uniform_from_words(w):
    """Float32 uniforms on [0, 1): the top 24 bits of int64 tensors of
    32-bit words, times 2⁻²⁴."""
    return (w >> 8).to(torch.float32) * 2.0 ** -24


def index_from_words(wa, wb, n: int, lo: int = 0):
    """lo + ⌊(wa·2³² + wb)·n / 2⁶⁴⌋ for int64 tensors of 32-bit words
    and 0 < n < 2³²: the high word of the 64 × 32-bit product, its three
    32 × 32-bit pieces exact in int64 (``noise_kernel._mulhilo``)."""
    hh, hl = _mulhilo(n, wa)
    h2, _ = _mulhilo(n, wb)
    return lo + hh + ((hl + h2) >> 32)


def chain_draws_reference(keys, step, plan: DrawPlan):
    """Plain PyTorch version (module docstring): the (N, floats) float32
    and (N, ints) int64 buffers of ``plan`` for the chains' ``keys`` at
    ``step``, on their device."""
    n = keys.shape[0]
    fout = torch.zeros((n, plan.floats), dtype=torch.float32,
                       device=keys.device)
    iout = torch.zeros((n, plan.ints), dtype=torch.int64, device=keys.device)
    for e, row in zip(plan.entries, plan.table):
        kind, start = int(row[1]), int(row[5])
        calls = -(-e.count // PER_CALL[kind])
        w0, w1, w2, w3 = keyed_words(keys, step, e.slot, calls)
        if kind == UNIFORM:
            vals = uniform_from_words(torch.stack([w0, w1, w2, w3], dim=-1))
        elif kind == INDEX:
            vals = torch.stack([index_from_words(w0, w1, e.n, e.lo),
                                index_from_words(w2, w3, e.n, e.lo)], dim=-1)
        else:
            zc0, zs0 = box_muller(w0, w1)
            zc1, zs1 = box_muller(w2, w3)
            vals = torch.stack([zc0, zs0, zc1, zs1], dim=-1)
        buf = iout if kind == INDEX else fout
        buf[:, start:start + e.count] = vals.reshape(n, -1)[:, :e.count]
    return fout, iout


def bind_library(lib):
    """Type the entry points of a built ``chain_draws.cu`` (the launch
    description and the empty launch where the source has them)."""
    lib.mcmc_chain_draws.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    lib.mcmc_chain_draws.restype = ctypes.c_int
    if hasattr(lib, "mcmc_chain_draws_info"):
        lib.mcmc_chain_draws_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p]
        lib.mcmc_chain_draws_info.restype = ctypes.c_int
        lib.mcmc_chain_draws_empty.argtypes = [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        lib.mcmc_chain_draws_empty.restype = ctypes.c_int
    lib.mcmc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mcmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_library():
    from .cuda_build import load_library

    lib = load_library("chain_draws").lib
    if lib.mcmc_chain_draws.argtypes is None:  # else pointers are cut
        bind_library(lib)
    return lib


def launch_draws(lib, keys, step, plan: DrawPlan):
    """Launch the draw kernel of ``lib`` (this checkout's, or another's in
    ``ab_draw_kernel.py``) on CUDA ``keys`` and ``step`` on the current
    stream; returns the two buffers."""
    n = keys.shape[0]
    keys, step = keys.contiguous(), step.contiguous()
    fout = torch.empty((n, plan.floats), dtype=torch.float32,
                       device=keys.device)
    iout = torch.empty((n, plan.ints), dtype=torch.int64, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    with torch.cuda.device(keys.device):
        err = lib.mcmc_chain_draws(
            keys.data_ptr(), step.data_ptr(),
            plan.table.ctypes.data, len(plan.entries), n, plan.calls,
            plan.floats, plan.ints, fout.data_ptr(), iout.data_ptr(), stream)
    _raise_on(lib, err, "kernel launch")
    return fout, iout


@counted("12tiled_kernel", "11flat_kernel")
def chain_draws(keys, step, plan: DrawPlan):
    """``plan``'s two buffers (module docstring): the operands checked,
    then the plain version for CPU keys, the CUDA kernel for CUDA keys."""
    check_streams(keys, step)
    n = keys.shape[0]
    if n * plan.calls > 2 ** 31 - 257 or max(plan.floats,
                                               plan.ints) >= 2 ** 31:
        raise ValueError(f"{n} chains x {plan.calls} Philox calls, "
                         f"{plan.floats} floats and {plan.ints} ints a "
                         "chain: the kernel takes at most 2^31 - 257 calls "
                         "a launch and 2^31 - 1 values of a type a chain")
    if keys.device.type == "cpu":
        return chain_draws_reference(keys, step, plan)
    out = launch_draws(_cuda_library(), keys, step, plan)
    chain_draws.launches += 1
    return out


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.mcmc_cuda_error_string(err).decode()
        raise RuntimeError(f"chain draws {what} failed: {msg} ({err})")


def chain_draws_info(n_chains: int, calls: int) -> dict:
    """The kernel's launch for ``n_chains`` chains of ``calls`` Philox
    calls: threads a CTA, CTAs, Philox calls a thread, registers and
    local memory bytes a thread, and resident CTAs an SM (the CUDA
    occupancy API)."""
    lib = _cuda_library()
    out = (ctypes.c_int * 6)()
    _raise_on(lib, lib.mcmc_chain_draws_info(int(n_chains), int(calls),
                                             out), "info")
    return dict(zip(("threads", "ctas", "calls_a_thread", "registers",
                     "local_bytes", "resident_ctas_per_sm"), out))


def empty_draws_launch(n_chains: int, calls: int, device=None):
    """An empty kernel on the grid of a launch for ``n_chains`` chains of
    ``calls`` Philox calls, on the current stream: that launch's floor."""
    lib = _cuda_library()
    device = torch.device("cuda" if device is None else device)
    with torch.cuda.device(device):
        _raise_on(lib, lib.mcmc_chain_draws_empty(
            int(n_chains), int(calls),
            torch.cuda.current_stream(device).cuda_stream), "empty launch")


def draw_plan(streams, plan: DrawPlan, impl: str = "auto") -> dict:
    """One step's draws of ``plan`` from the per-chain ``streams``:
    {name: (N, count) view}.  ``impl="eager"`` runs the plain version
    on any device, anything else the dispatcher."""
    fn = chain_draws_reference if impl == "eager" else chain_draws
    return plan.views(*fn(streams.keys, streams.step, plan))


@functools.lru_cache(maxsize=64)
def cached_plan(entries: tuple) -> DrawPlan:
    """The plan of ``entries``, built once (its layout and host table)."""
    return DrawPlan(entries)


__all__ = ["DrawEntry", "DrawPlan", "SLOTS", "cached_plan", "chain_draws",
           "chain_draws_info", "chain_draws_reference", "draw_plan",
           "empty_draws_launch", "entry", "index_from_words", "launch_draws",
           "uniform_from_words"]
