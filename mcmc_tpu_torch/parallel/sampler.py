"""Multi-chain sampler: the chain farm on one device.

PyTorch counterpart of ``mcmc_tpu/parallel/sampler.py`` (the reference's
``multiprocessing.Pool`` farm, largeScaleChain_multiprocessing.py:19-98).
Chains are the leading batch axis of one state; they exchange nothing
while sampling.  ``run`` loops over segments of steps; inside a segment
every trace stays on the device in preallocated ``(n_steps, N, ...)``
tensors and nothing waits for the host, and each segment's traces are
copied to the host once, at its end.

Both chain families run here: a ``ChainCRF`` steps through
``models/chain_crf.make_step``, a ``ChainSGS`` through
``models/chain_sgs.make_sgs_step``.  Not carried over from the JAX package:
chunked launches (``scan_chunked``) and grid auto-padding, which were TPU
workarounds.

The segment scan.  The JAX package runs a segment as one ``lax.scan``
inside ``jax.jit``: one device program, no host in the loop.  Here, on the
card, ``run_chains`` runs the steps of a segment as replays of one CUDA
graph of ``CHUNK_STEPS`` consecutive steps (``run_chains_chunked``): the
first ``WARM_STEPS`` steps run eagerly (they build the kernels, cuFFT's
plans and the caches a step fills once), then the chunk is captured, then
replayed, and the steps left over run eagerly.  Every step updates the
caller's state tensors in place, so a replay continues from the last one;
the graph writes its rows into staging buffers that one copy a trace key
moves into the segment's traces.  The owner of a farm keeps its graph: a
``MultiChainSampler`` holds a ``GraphCache`` and passes it to every
segment, so later calls on the same state object and stream replay the
graph captured once; other operands capture anew, and ``init`` and
``restore_generator`` drop it.  A call given no cache captures for itself
alone.  The steps launch the same kernels in the same order either way,
so the traces, the states and the random streams come out bit for bit
those of the eager loop, ``run_chains_eager``, the plain version that CPU
tensors run.  A capture or replay that fails raises.

Over several ranks (one process a card, ``parallel/distributed.py``) the
farm is sharded on a ``chains`` mesh: in a world of more than one rank the
sampler builds one over every rank unless given one, and refuses a chain
count the ranks do not divide.  Each rank steps its contiguous block of
chains through the same ``run_chains``, so every kernel runs on its own
card, and ``run`` gathers the traces, the bed snapshots and the progress
values at the end of every segment, so that every rank returns the same
global result (the reference's ``_host_np``).  Those gathers are
collectives: every rank enters each of them in the same order, whatever
``progress`` says; only rank 0 prints.  Chain i's draws do not depend on
the number of ranks (``utils/rng``: a rank holds its chains' keys, or the
farm's generator in a ``RowSlice``), so a rank's chains are bitwise the
same rows of the one-rank farm wherever the step is batch-invariant.
``init(seeds=...)`` takes an int master seed (one
``torch.Generator`` for the farm) or, as the JAX package does, a list of
per-chain seeds (``utils/rng.PerChainStreams``: chain i's draws depend
on ``seeds[i]`` alone; ``run_segment`` advances their step counter once
a step, on the device).  The stream's state goes in and out for
checkpoints (``io/checkpoint.py``).  ``run`` also thins each chain's bed
to one snapshot a segment (``collect_beds``) and traces its second
segment with ``torch.profiler`` (``profile_dir``); ``run_segment`` can
trace every step's bed (``save_beds``).  Under any profiler a call shows
as spans (``utils/spans.py``): ``mcmc.run_chains``, and inside it
``mcmc.run_chains.eager`` (the warm-up steps, the tail),
``mcmc.run_chains.capture`` and one ``mcmc.run_chains.replay`` a chunk;
the traces' copy to the host is ``mcmc.host_copy``.

The reference's functional forms are here too, with its arguments in its
order: ``run_chains(static, consts, states, n_steps, save_beds, *, rng)``
(both families, picked by the static's type; the random source a
keyword-only ``rng`` where the reference's states carry keys) and
``init_states(initial_beds, consts, ...)``.  ``MultiChainSampler``'s
``run_segment`` and ``init`` call them: one code path.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models.chain_crf import (ChainState, CRFConsts, CRFStatic, IMPLS,
                                host_copy, init_state, make_step)
from ..models.chain_sgs import (ChainSGS, SGSConsts, SGSState, SGSStatic,
                                make_sgs_step, sgs_init_state)
from ..ops.launch_counts import COUNTED
from ..utils.graphs import capture_graph
from ..utils.progress import MultiChainProgress
from ..utils.rng import (PER_CHAIN_KIND, PerChainStreams, RowSlice,
                         generator_kind, generator_state, is_seed_list,
                         make_generator, resolve_device, resolve_seed,
                         restore_generator)
from ..utils.spans import span
from .distributed import bound_device, global_chains_mesh, world
from .mesh import gather_rows


RUN_CHAINS_FORM = ("run_chains(static, consts, states, n_steps, "
                   "save_beds=False, *, rng, impl='auto', graphs=None)")

WARM_STEPS = 1    # eager steps of a segment before its chunk is captured
# Steps a captured graph replays.  On the card (chip_smoke.py [graph]'s
# sweep) a replayed step takes the same time at 10 to 100 steps a graph,
# while the capture's time grows with them and a new graph's segment runs
# up to CHUNK_STEPS - 1 steps eagerly after it: the shortest chunk wins.
CHUNK_STEPS = 10


def check_rng(rng, form: str) -> None:
    """Raise a TypeError naming the port's ``form`` unless ``rng`` is the
    port's random source: a ``torch.Generator`` or per-chain streams."""
    if not isinstance(rng, (torch.Generator, PerChainStreams, RowSlice)):
        raise TypeError(
            f"{form}: rng must be a torch.Generator or per-chain streams "
            "(utils/rng.PerChainStreams), the port's random source in place "
            f"of the reference's key; got {type(rng).__name__}")


def full_bed(consts, states) -> torch.Tensor:
    """(n_chains, H, W) beds in data space: an SGS chain's with its trend
    restored."""
    return (states.bed + consts.trend if isinstance(consts, SGSConsts)
            else states.bed)


def trace_buffers(static, n_chains: int, n_steps: int, device,
                  save_beds: bool = False) -> dict:
    """Empty time-major traces of ``n_steps`` steps of ``n_chains``
    chains: the losses, the MH decision, the block and the probes, and
    with ``save_beds`` every step's full bed."""
    N, P = n_chains, static.P
    kw = dict(device=device)
    beds = ({"bed": torch.empty((n_steps, N, static.H, static.W),
                                dtype=torch.float32, **kw)}
            if save_beds else {})
    return beds | {
        "loss_mc": torch.empty((n_steps, N), dtype=torch.float32, **kw),
        "loss_data": torch.empty((n_steps, N), dtype=torch.float32, **kw),
        "loss": torch.empty((n_steps, N), dtype=torch.float32, **kw),
        "step": torch.empty((n_steps, N), dtype=torch.bool, **kw),
        "block": torch.empty((n_steps, N, 4), dtype=torch.float32, **kw),
        "samples": torch.empty((n_steps, N, P), dtype=torch.float32, **kw),
    }


def initial_row(consts, states, save_beds: bool = False) -> dict:
    """Trace row 0, the states themselves, as device tensors with a
    leading (time) axis of 1: the losses, no step, a NaN block, the probes
    and, with ``save_beds``, a copy of the full bed."""
    n = states.fields.shape[0]
    device = states.fields.device
    sij = consts.sample_ij
    samples = (states.bed[:, sij[:, 0], sij[:, 1]] if sij.shape[0]
               else states.bed.new_zeros((n, 0)))
    if isinstance(consts, SGSConsts):  # probes report the trend-restored bed
        samples = samples + consts.trend[sij[:, 0], sij[:, 1]]
    loss_data = getattr(states, "loss_data",
                        torch.zeros_like(states.loss_mc))
    row = {  # copies: a captured segment updates the state's tensors
        "loss_mc": states.loss_mc.clone(),
        "loss_data": loss_data.clone(),
        "loss": states.loss_mc + loss_data,
        "step": torch.zeros(n, dtype=torch.bool, device=device),
        "block": torch.full((n, 4), float("nan"), device=device),
        "samples": samples,
    }
    if save_beds:  # the state's bed plane is updated in place by steps
        row["bed"] = full_bed(consts, states).clone()
    return {k: v[None] for k, v in row.items()}


def family_step(static, impl: str = "auto"):
    """The batched step of ``static``'s family: ``make_step`` for a
    ``CRFStatic``, ``make_sgs_step`` for an ``SGSStatic``."""
    if isinstance(static, SGSStatic):
        return make_sgs_step(static, impl)
    if isinstance(static, CRFStatic):
        return make_step(static, impl)
    raise TypeError(f"{RUN_CHAINS_FORM}: static must be a CRFStatic or "
                    f"an SGSStatic, got {type(static).__name__}")


def run_chains(static, consts, states, n_steps: int, save_beds: bool = False,
               *, rng=None, impl: str = "auto",
               graphs: Optional[GraphCache] = None):
    """Advance a batch of chains ``n_steps`` MH steps, the reference's
    ``run_chains`` (``mcmc_tpu/parallel/sampler.py:39``) with its
    arguments in its order.

    Both chain families: ``static`` is a ``CRFStatic`` or an
    ``SGSStatic``, which picks the step (``make_step`` /
    ``make_sgs_step``).  ``states`` has a leading chain axis.  ``rng``
    (keyword-only, required) is the port's random source in place of the
    key the reference's states carry: a ``torch.Generator``, or per-chain
    streams whose step counter advances once a step.  ``impl``: "auto"
    runs the CUDA kernels for CUDA tensors and their plain versions for
    CPU ones, "eager" always the plain versions, "fused" the kernels or
    raises; the reference's "xla" is refused.  Returns (states, traces)
    with time-major device traces of shape (n_steps, n_chains, ...);
    ``save_beds`` adds ``traces["bed"]``, every step's ``full_bed``.

    CUDA states run through a captured graph (``run_chains_chunked``,
    module docstring) and come back as the object passed in, its tensors
    updated in place; ``graphs`` (keyword-only) is the caller's
    ``GraphCache``, kept across calls, else the graph serves this call
    alone.  CPU states run the eager loop (``run_chains_eager``).  Both
    give the same bits."""
    check_rng(rng, RUN_CHAINS_FORM)
    with span("mcmc.run_chains"):
        if states.fields.device.type != "cuda":
            return run_chains_eager(static, consts, states, n_steps,
                                    save_beds, rng=rng, impl=impl)
        return run_chains_chunked(static, consts, states, n_steps, save_beds,
                                  rng=rng, impl=impl, graphs=graphs)


def run_chains_eager(static, consts, states, n_steps: int,
                     save_beds: bool = False, *, rng=None,
                     impl: str = "auto"):
    """``run_chains`` as a Python loop that launches every op of every
    step: the plain version of the captured loop, and what CPU states
    run.  ``states.fields`` is updated in place; the other state tensors
    are new each step, and the returned state is the last step's."""
    check_rng(rng, RUN_CHAINS_FORM)
    step = family_step(static, impl)
    n_steps = int(n_steps)
    bufs = trace_buffers(static, states.fields.shape[0], n_steps,
                         states.fields.device, save_beds)
    per_chain = isinstance(rng, PerChainStreams)
    for t in range(n_steps):
        states, tr = step(consts, states, rng)
        if per_chain:
            rng.advance()
        if save_beds:
            tr = dict(tr, bed=full_bed(consts, states))
        for k, buf in bufs.items():
            buf[t] = tr[k]
    return states, bufs


@dataclasses.dataclass
class SegmentGraph:
    """A captured chunk of steps: the graph, the staging buffers it writes
    its trace rows to, and the launches each counted dispatcher made at its
    capture, as (dispatcher, count) pairs (``ops/launch_counts``).  ``key``
    names the operands it ran by identity; ``operands`` holds them, so no
    other object takes their identity, nor another tensor their memory,
    while the graph may replay."""

    key: tuple
    operands: tuple
    graph: object
    staging: dict
    launches: tuple
    replays: int = 0

    @property
    def steps(self) -> int:
        return next(iter(self.staging.values())).shape[0]

    def replay(self) -> None:
        """One replay; each dispatcher's count moves as its launches in
        the capture did, since a replay runs no Python."""
        self.graph.replay()
        for counter, n in self.launches:
            counter.launches += n
        self.replays += 1


class GraphCache:
    """Where the owner of a farm keeps the graph its ``run_chains`` calls
    replay: ``graph``, the last one captured, or None.  A call on other
    operands replaces it; ``drop`` lets it go, and with it its hold on the
    operands and the graph's memory."""

    def __init__(self):
        self.graph: Optional[SegmentGraph] = None

    def drop(self) -> None:
        self.graph = None


def _operand_key(static, consts, states, rng, save_beds, impl) -> tuple:
    """The operands a captured chunk bakes in: the objects by identity,
    the state tensors by memory as well (a field replaced in the same
    state object is new memory), a sharded farm's stream by its generator
    and rows."""
    stream = ((id(rng.generator), rng.n_total, rng.lo, rng.hi)
              if isinstance(rng, RowSlice) else id(rng))
    ptrs = tuple(getattr(states, f.name).data_ptr()
                 for f in dataclasses.fields(states))
    return (id(static), id(consts), id(states), ptrs, stream,
            bool(save_beds), impl, CHUNK_STEPS)


def _advance(step, consts, states, rng, save_beds: bool, rows: dict) -> None:
    """One step of ``states`` in place: the trace row written into
    ``rows`` ({key: (n_chains, ...) destination}), each new state tensor
    copied into the one it replaces (``fields`` is updated in place by
    the step itself)."""
    new, tr = step(consts, states, rng)
    if isinstance(rng, PerChainStreams):
        rng.advance()
    if save_beds:
        tr = dict(tr, bed=full_bed(consts, new))
    for k, row in rows.items():
        row.copy_(tr[k])
    for f in dataclasses.fields(new):
        if f.name != "fields":
            getattr(states, f.name).copy_(getattr(new, f.name))


def _capture_segment(step, consts, states, rng, save_beds, bufs, capture,
                     key, operands) -> SegmentGraph:
    """Capture ``CHUNK_STEPS`` steps of ``_advance`` into staging buffers,
    with ``capture(body, generator)``; the launch counters go back to
    where they stood, since the capture ran nothing."""
    staging = {k: torch.empty((CHUNK_STEPS,) + tuple(b.shape[1:]),
                              dtype=b.dtype, device=b.device)
               for k, b in bufs.items()}

    def body():
        for i in range(CHUNK_STEPS):
            _advance(step, consts, states, rng, save_beds,
                     {k: s[i] for k, s in staging.items()})

    before = {c: c.launches for c in COUNTED}
    try:
        with span("mcmc.run_chains.capture"):
            graph = capture(body, rng.generator if isinstance(rng, RowSlice)
                            else rng if isinstance(rng, torch.Generator)
                            else None)
        counted = tuple((c, c.launches - before.get(c, 0)) for c in COUNTED
                        if c.launches != before.get(c, 0))
    finally:
        for c in COUNTED:
            c.launches = before.get(c, 0)
    return SegmentGraph(key=key, operands=operands, graph=graph,
                        staging=staging, launches=counted)


def run_chains_chunked(static, consts, states, n_steps: int,
                       save_beds: bool = False, *, rng=None,
                       impl: str = "auto",
                       graphs: Optional[GraphCache] = None,
                       capture=capture_graph):
    """``run_chains`` as chunks of ``CHUNK_STEPS`` steps replayed from one
    capture (module docstring): unless ``graphs`` holds a graph of these
    operands, ``WARM_STEPS`` eager steps, then the capture by
    ``capture(body, generator) -> graph`` (the graph needs only a
    ``replay()``) kept in ``graphs``; as many replays as whole chunks
    remain, then the rest eagerly.  Returns ``(states, traces)``: the
    object passed in, its tensors updated in place, and the traces
    ``run_chains_eager`` gives."""
    check_rng(rng, RUN_CHAINS_FORM)
    step = family_step(static, impl)
    n_steps, chunk = int(n_steps), CHUNK_STEPS
    tensors = [getattr(states, f.name) for f in dataclasses.fields(states)]
    if len({t.data_ptr() for t in tensors}) != len(tensors):
        raise ValueError("the state's tensors share memory; a captured "
                         "step writes each of them in place")
    bufs = trace_buffers(static, states.fields.shape[0], n_steps,
                         states.fields.device, save_beds)

    def eager(lo, hi):
        if hi <= lo:
            return
        with span("mcmc.run_chains.eager"):
            for t in range(lo, hi):
                _advance(step, consts, states, rng, save_beds,
                         {k: b[t] for k, b in bufs.items()})

    graphs = GraphCache() if graphs is None else graphs
    key = _operand_key(static, consts, states, rng, save_beds, impl)
    seg = graphs.graph
    t = 0
    if seg is None or seg.key != key:
        graphs.drop()  # its memory goes back before the next capture
        seg = None
        t = min(WARM_STEPS, n_steps)
        eager(0, t)
        if n_steps - t >= chunk:
            seg = _capture_segment(step, consts, states, rng, save_beds,
                                   bufs, capture, key,
                                   (static, consts, states, rng))
            graphs.graph = seg
    while seg is not None and n_steps - t >= chunk:
        with span("mcmc.run_chains.replay"):
            seg.replay()
            for k, b in bufs.items():
                b[t:t + chunk].copy_(seg.staging[k])
        t += chunk
    eager(t, n_steps)
    return states, bufs


def run_one_chain(static, consts, state, n_iter: int, save_beds: bool,
                  rng, impl: str, form: str,
                  graphs: Optional[GraphCache] = None):
    """``n_iter - 1`` steps of one chain through ``run_chains``, with the
    initial state prepended as row 0 (the reference loop ``for i in
    range(1, n_iter)``, MCMC.py:1247): (state, device traces of leading
    dim ``n_iter`` and no chain axis).  ``form`` names the caller in
    errors; ``graphs`` is the caller's ``GraphCache``, if it keeps one."""
    check_rng(rng, form)
    if int(n_iter) < 1:
        raise ValueError(f"{form}: n_iter must be >= 1 (trace row 0 "
                         "records the initial state)")
    if state.fields.shape[0] != 1:
        raise ValueError(f"{form} runs one chain (a state with a leading "
                         f"axis of 1), got {state.fields.shape[0]}; "
                         "run_chains runs a batch")
    head = initial_row(consts, state, save_beds)
    state, tail = run_chains(static, consts, state, int(n_iter) - 1,
                             save_beds, rng=rng, impl=impl, graphs=graphs)
    return state, {k: torch.cat([head[k], tail[k]])[:, 0] for k in head}


def init_states(initial_beds, consts, n_chains: Optional[int] = None, *,
                z0=None):
    """Batched initial states (full-grid residual and loss of every
    chain), the reference's ``init_states`` (``mcmc_tpu/parallel/
    sampler.py:169``) for either family, picked by ``consts``' type.

    The reference's ``keys`` argument has no counterpart: the port's
    states carry no key (their random source is ``run_chains``' ``rng``),
    and a call that passes one raises a TypeError naming this form.
    ``initial_beds``: (N, H, W), or one (H, W) bed for ``n_chains``
    chains; an SGS chain's detrended.  ``z0``, required for an SGS chain
    and refused for a CRF one: the z-plane of the beds, their normal
    scores (``ChainSGS.host_transform``) when the chain transforms, else
    the detrended beds themselves.  The consts do not say whether the
    chain transforms (its static does), so the caller states the plane."""
    if isinstance(consts, SGSConsts):
        if z0 is None:
            raise ValueError(
                "an SGS chain's init_states needs z0, the z-plane of its "
                "beds: their normal scores (ChainSGS.host_transform) when "
                "the chain transforms, else the detrended beds themselves")
        return sgs_init_state(initial_beds, consts, z0, True, n_chains)
    if isinstance(consts, CRFConsts):
        if z0 is not None:
            raise ValueError("z0 is an SGS chain's z-plane; a CRF chain "
                             "has none")
        return init_state(initial_beds, consts, n_chains)
    raise TypeError("init_states(initial_beds, consts, n_chains=None, *, "
                    "z0=None): consts must be a CRFConsts or an SGSConsts "
                    "(the port's states carry no key); got "
                    f"{type(consts).__name__}")


class MultiChainSampler:
    """Farm of ``n_chains`` chains built from one prototype ``ChainCRF`` or
    ``ChainSGS``.

    ``mesh``: a ``chains`` mesh to shard the farm over (module
    docstring); ``None`` builds one over every rank when there is more
    than one, unless ``use_mesh`` is false (then every rank runs the whole
    farm).  A farm's mesh spans every rank and has no grid axis of more
    than one rank.  ``rows``: this rank's chains [lo, hi).
    ``device``: the mesh's, else the card (``None`` or "cuda") unless the
    caller or ``initialize_distributed`` asks for the CPU; with no card,
    ``None`` raises rather than running elsewhere.
    ``impl``: "auto" runs the CUDA kernels for CUDA tensors and their
    plain versions for CPU ones; "eager" always runs the plain versions;
    "fused" demands the kernels and raises on a CPU device.
    """

    def __init__(self, chain, n_chains: int, mesh=None,
                 use_mesh: bool = True, device=None, impl: str = "auto"):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
        self.n_chains = int(n_chains)
        _, size = world()
        if mesh is None and use_mesh and size > 1:
            if self.n_chains % size:
                raise ValueError(
                    f"n_chains={self.n_chains} is not divisible by the "
                    f"{size} ranks of this run; use a chain count divisible "
                    "by the number of ranks, or pass use_mesh=False to run "
                    "the whole farm on every rank")
            mesh = global_chains_mesh(device=device)
        if mesh is not None:
            self._check_mesh(mesh, size, device)
            device = mesh.device
        elif device is None:
            device = bound_device()
        self.device = resolve_device(device)
        if impl == "fused" and self.device.type != "cuda":
            raise ValueError("impl='fused' runs the CUDA kernels and needs a "
                             f"CUDA device, not {self.device}")
        self.mesh = mesh
        n_shards = mesh.shape["chains"] if mesh is not None else 1
        self.sharded = n_shards > 1
        per = self.n_chains // n_shards
        lo = mesh.index("chains") * per if mesh is not None else 0
        self.rows = (lo, lo + per)
        self.chain = chain
        self.impl = impl
        self.is_sgs = isinstance(chain, ChainSGS)
        self.static, self.consts = chain.build(self.device)
        self.generator = None
        self.graphs = GraphCache()  # the segments' captured chunk

    def _check_mesh(self, mesh, size: int, device) -> None:
        """Refuse a mesh a farm cannot run on: one that leaves out a rank
        (its gathers would wait for that rank forever), shards the grid,
        does not divide the chains, or is on another device than
        ``device``."""
        if sorted(mesh.ranks.ravel().tolist()) != list(range(size)):
            raise ValueError(
                f"the mesh holds ranks {sorted(mesh.ranks.ravel().tolist())}"
                f" of a {size}-rank run: a farm's mesh must span every rank "
                "(parallel.distributed.global_chains_mesh())")
        if any(n > 1 for axis, n in mesh.shape.items() if axis != "chains"):
            raise ValueError(f"mesh {mesh.shape}: the farm shards chains "
                             "only; a sharded grid runs through "
                             "grid_sharded.make_sharded_crf_chains")
        if self.n_chains % mesh.shape["chains"]:
            raise ValueError(f"n_chains={self.n_chains} is not divisible by "
                             f"the mesh's {mesh.shape['chains']} chain shards")
        if device is not None and resolve_device(device).type \
                != mesh.device.type:
            raise ValueError(f"device {device} but the mesh is on "
                             f"{mesh.device}")

    # -- state ---------------------------------------------------------------

    def init(self, initial_beds=None, seeds=None) -> ChainState | SGSState:
        """Batched initial states, and the sampler's generator.

        initial_beds: (n_chains, H, W), one (H, W) bed shared by every
        chain, or None for the prototype chain's initial bed.  An SGS
        chain's beds are full-space: they are detrended and clamp-
        roundtripped like the builder's (``ChainSGS.preprocess_beds``),
        and their z-planes computed on the host.
        seeds: int master seed, a list of per-chain ints (at least
        ``n_chains``; the first ``n_chains`` are used), or None (fresh
        entropy); a None falls back to the chain's
        ``set_random_generator`` seed when it has one.
        """
        self.graphs.drop()  # new states and stream: its graph is stale
        lo, hi = self.rows
        if seeds is None:
            seeds = self.chain.seed
        if is_seed_list(seeds):
            self.generator = PerChainStreams.from_seeds(
                resolve_seed(seeds, self.n_chains), self.device).rows(lo, hi)
        else:
            self.generator = make_generator(self._shared_seed(seeds),
                                            self.device)
        if initial_beds is not None:
            initial_beds = np.asarray(initial_beds)
            if initial_beds.ndim == 3:
                if initial_beds.shape[0] != self.n_chains:
                    raise ValueError("initial_beds leading dim must equal "
                                     "n_chains")
                initial_beds = initial_beds[lo:hi]
        if self.is_sgs:
            if initial_beds is None:
                beds = self.chain._initial_detrended
                z0 = self.chain._initial_z
            else:
                beds = self.chain.preprocess_beds(initial_beds)
                z0 = self.chain.host_transform(beds)
            return init_states(beds, self.consts, hi - lo,
                               z0=z0 if self.static.use_transform else beds)
        beds = (self.chain.initial_bed if initial_beds is None
                else initial_beds.astype(np.float32))
        return init_states(beds, self.consts, hi - lo)

    def _shared_seed(self, seed) -> int:
        """An int seed that every rank of a sharded farm holds alike: a
        None draws fresh entropy on the mesh's first rank and sends it to
        the others."""
        if not self.sharded or seed is not None:
            return resolve_seed(seed)
        src = int(self.mesh.ranks.flat[0])
        value = torch.tensor([resolve_seed(None) if world()[0] == src else 0],
                             dtype=torch.int64, device=self.device)
        torch.distributed.broadcast(value, src=src,
                                    group=self.mesh.group("chains"))
        return int(value.item())

    def rng_kind(self, seeds=None) -> str:
        """The kind of stream this sampler owns: its stream's after
        ``init``, else the kind ``init(seeds)`` would make (a seed list
        gives per-chain streams, anything else the device's
        generator)."""
        if seeds is None and self.generator is not None:
            per_chain = isinstance(self.generator, PerChainStreams)
        else:
            per_chain = is_seed_list(self.chain.seed if seeds is None
                                     else seeds)
        return PER_CHAIN_KIND if per_chain else generator_kind(self.device)

    def generator_state(self):
        """``(kind, uint8 state)`` of the sampler's stream, for a
        checkpoint (``utils/rng.generator_state``)."""
        if self.generator is None:
            raise RuntimeError("call init() before reading the generator")
        return generator_state(self.generator)

    def restore_generator(self, kind: str, state, seeds=None) -> None:
        """Continue the stream a checkpoint stored (the whole farm's: a
        rank keeps its chains' streams); a state of another kind than
        ``rng_kind(seeds)`` raises, and per-chain streams for another
        number of chains too."""
        gen = restore_generator(kind, state, self.device,
                                want=self.rng_kind(seeds))
        if isinstance(gen, PerChainStreams):
            if gen.n_chains != self.n_chains:
                raise ValueError(f"the state holds {gen.n_chains} per-chain "
                                 f"streams, the sampler runs "
                                 f"{self.n_chains} chains")
            gen = gen.rows(*self.rows)
        self.graphs.drop()  # its graph draws from the stream replaced
        self.generator = gen

    def stream(self):
        """The random source of this rank's steps: the sampler's stream,
        or in a sharded int-seeded farm its generator in a ``RowSlice``."""
        if self.sharded and isinstance(self.generator, torch.Generator):
            return RowSlice(self.generator, self.n_chains, *self.rows)
        return self.generator

    def gather(self, x: torch.Tensor, dim: int = 0) -> np.ndarray:
        """Host copy of the whole farm's ``x``, whose dimension ``dim``
        runs over this rank's chains: gathered over the ranks in a
        sharded farm (a collective every rank enters)."""
        if self.sharded:
            x = gather_rows(x, self.mesh, dim=dim)
        return host_copy(x)

    # -- execution -----------------------------------------------------------

    def full_bed(self, states: ChainState | SGSState) -> torch.Tensor:
        """(n_chains, H, W) beds in data space (``full_bed``)."""
        return full_bed(self.consts, states)

    def run_segment(self, states: ChainState | SGSState, n_steps: int,
                    save_beds: bool = False):
        """``n_steps`` MH steps of ``run_chains`` on the sampler's stream;
        returns (states, traces) with time-major device traces of shape
        (n_steps, n_chains, ...).  ``save_beds`` adds ``traces["bed"]``,
        every step's ``full_bed``."""
        if self.generator is None:
            raise RuntimeError("call init() before running the sampler")
        return run_chains(self.static, self.consts, states, n_steps,
                          save_beds, rng=self.stream(), impl=self.impl,
                          graphs=self.graphs)

    def initial_row(self, states: ChainState | SGSState,
                    save_beds: bool = False):
        """Trace row 0, the state itself (``initial_row``), as host numpy
        with a leading axis of 1, the whole farm's (``gather``)."""
        return {k: self.gather(v, dim=1) for k, v in
                initial_row(self.consts, states, save_beds).items()}

    def run(self, states: ChainState | SGSState, n_iter: int,
            segment_size: int = 2000,
            progress: bool = True,
            segment_callback: Optional[Callable] = None,
            collect_beds: bool = False, fancy_progress: bool = False,
            profile_dir: Optional[str] = None):
        """Run ``n_iter`` iterations in segments of ``segment_size`` steps.

        Iteration 0 records the initial state (reference loop semantics);
        ``segment_callback(cumulative_iter, states, traces_np)`` fires after
        each segment, the first carrying the initial row; at ``n_iter = 1``
        it fires once, with that row and an empty segment.  Returns
        (states, traces) with chain-major numpy traces of length n_iter.

        progress: one status line a segment (iterations, chain-it/s, mean
        loss, mean acceptance), or with ``fancy_progress`` the reference's
        per-chain progress block (``utils/progress.py``) redrawn in place.
        collect_beds: each chain's ``full_bed`` after every segment (the
        empty one at ``n_iter = 1`` too) into ``traces["bed_thin"]``,
        (n_chains, n_segments, H, W).
        profile_dir: a ``torch.profiler`` trace (CPU, and CUDA on the card)
        of the second segment, exported there as a Chrome trace (one a
        rank in a sharded farm); written only when there is a second
        segment.

        In a sharded farm the traces, snapshots and progress values are
        the whole farm's on every rank; the returned states are the
        rank's own chains.
        """
        n_iter = int(n_iter)
        if n_iter < 1:
            raise ValueError("n_iter must be >= 1 (trace row 0 records "
                             "the initial state)")
        emit = world()[0] == 0
        renderer = (MultiChainProgress(self.n_chains, n_iter)
                    if progress and fancy_progress and emit else None)
        rank_tag = f".rank{world()[0]}" if self.sharded else ""
        init_np = self.initial_row(states)
        collected = []
        bed_snaps = []
        remaining = n_iter - 1
        done = 1
        first = True
        seg_index = 0
        t0 = time.time()
        while remaining > 0 or first:
            n = min(int(segment_size), remaining)
            if n > 0:
                prof = (self._profiler() if profile_dir is not None
                        and seg_index == 1 else None)
                states, traces = self.run_segment(states, n)
                traces_np = {k: self.gather(v, dim=1)
                             for k, v in traces.items()}
                if prof is not None:
                    prof.stop()
                    os.makedirs(profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(
                        profile_dir,
                        f"segment{seg_index}{rank_tag}.pt.trace.json"))
            else:
                traces_np = {k: v[:0] for k, v in init_np.items()}
            if first:  # the initial row travels with the first segment
                traces_np = {k: np.concatenate([init_np[k], v])
                             for k, v in traces_np.items()}
                first = False
            collected.append(traces_np)
            if collect_beds:
                bed_snaps.append(self.gather(self.full_bed(states)))
            remaining -= n
            done += n
            seg_index += 1
            loss_np = self.gather(states.loss_mc)
            acc_np = self.gather(states.accepted) / max(done - 1, 1)
            if progress and emit:
                if renderer is not None:
                    renderer.update(done, loss_np, acc_np)
                else:
                    rate = ((done - 1) * self.n_chains
                            / max(time.time() - t0, 1e-9))
                    print(f"[sampler] iter {done}/{n_iter} | "
                          f"{rate:,.0f} chain-it/s | "
                          f"loss mean {loss_np.mean():.4e} | "
                          f"acc {acc_np.mean():.3f}", flush=True)
            if segment_callback is not None:
                segment_callback(done, states, traces_np)
        traces = {k: np.moveaxis(np.concatenate([c[k] for c in collected]),
                                 0, 1)
                  for k in collected[0]}
        if collect_beds:
            traces["bed_thin"] = np.stack(bed_snaps, axis=1)
        return states, traces

    def _profiler(self):
        """A started ``torch.profiler`` over the CPU and, on the card, the
        device."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    # -- diagnostics ---------------------------------------------------------

    def diagnostics(self, traces, elapsed_seconds=None, *, device=None):
        """Convergence summary: acceptance, split R-hat and ESS of the loss
        and the probes (+ chain-it/s and ESS/s when ``elapsed_seconds`` is
        given), computed on the farm's device unless ``device`` names
        another.  ``traces`` are chain-major: ``run``'s numpy traces, or
        device tensors such as ``run_chains``' time-major traces
        transposed."""
        from . import diagnostics as diag

        dev = self.device if device is None else resolve_device(device)

        def on(name):  # each trace copied to the device once
            return torch.as_tensor(traces[name], device=dev)

        out = {"acceptance_rate": diag.acceptance_rate(on("step"))}
        if traces["samples"].shape[-1] > 0:
            samp = on("samples")
            out["rhat"] = diag.split_rhat(samp)
            out["ess"] = diag.ess(samp)
            out["rhat_rank"] = diag.rank_normalized_rhat(samp)
            out["ess_bulk"] = diag.ess_bulk(samp)
            out["ess_tail"] = diag.ess_tail(samp)
        loss_tr = on("loss")
        out["rhat_loss"] = float(diag.split_rhat(loss_tr))
        out["ess_loss"] = float(diag.ess(loss_tr))
        out["rhat_rank_loss"] = float(diag.rank_normalized_rhat(loss_tr))
        if elapsed_seconds:
            n_iter = traces["loss"].shape[1]
            out["chain_iters_per_sec"] = (n_iter * self.n_chains
                                          / elapsed_seconds)
            out["ess_per_sec"] = out["ess_loss"] / elapsed_seconds
            if "ess" in out:
                out["ess_per_sec_probes"] = (np.asarray(out["ess"])
                                             / elapsed_seconds)
        return out
