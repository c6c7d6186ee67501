"""The port's segment scan: ``run_chains`` as chunks of steps replayed from
one captured CUDA graph (``mcmc_tpu_torch/parallel/sampler.py``).

A CUDA graph exists only on the card, so here the chunked loop's own code
(warm-up steps, the capture of a chunk into staging buffers, the copy of
each step's state back into the caller's tensors, replays, the eager
remainder, the graph its owner keeps) runs with a stub in place of
``capture_graph``, at the package's ``WARM_STEPS`` and ``CHUNK_STEPS``.
The stub does what a capture and a replay do to
everything the loop can see: the capture runs the chunk's Python once
(the launch counters move) and leaves the state, the random stream and
the buffers as they were; a replay runs the chunk's work (the state and
the stream advance) and moves no counter.  Held bitwise to
``run_chains_eager``, the plain loop; and one case, at the seam where
both packages take the same draws, to the JAX package's ``run_chains``
(a ``lax.scan``) with the tolerances of ``tests/test_torch_chain_crf.py``.
The card's own capture is held to the eager loop by the ``cuda``-marked
tests in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import gc
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.models.chain_crf import make_kernel as jmake_kernel
from mcmc_tpu.parallel import sampler as jsampler
from mcmc_tpu_torch import MultiChainSampler
from mcmc_tpu_torch.interop import consts_from_numpy, state_from_numpy
from mcmc_tpu_torch.models import chain_crf
from mcmc_tpu_torch.ops.launch_counts import COUNTED
from mcmc_tpu_torch.parallel import sampler as ps
from mcmc_tpu_torch.utils.rng import PerChainStreams, make_generator
from tests.test_torch_chain_crf import (N as SEAM_N, _draws, _jax_chain,
                                        _jax_finished, _jax_states,
                                        _numpy_state, _port_draws)
from tests.conftest import make_synthetic_problem
from tests.torch_helpers import small_chain, small_problem, small_sgs_chain

CPU = torch.device("cpu")
N = 3
WARM, CHUNK = ps.WARM_STEPS, ps.CHUNK_STEPS
# n_steps: none, one, the warm-up, a chunk short of whole, the warm-up and
# one chunk, two chunks and a remainder
STEPS = tuple(sorted({0, 1, WARM, WARM + CHUNK - 1, WARM + CHUNK,
                      WARM + 2 * CHUNK + 3}))
KERNELS = {
    ("crf", "int"): ("fused_window_update", "batched_normal"),
    ("crf", "list"): ("fused_window_update", "batched_normal_keyed",
                      "chain_draws"),
    ("sgs", "int"): ("window_extract", "window_writeback", "mix_masked_cg",
                     "lut_interp", "k_nearest"),
    ("sgs", "list"): ("window_extract", "window_writeback", "mix_masked_cg",
                      "lut_interp", "chain_draws", "k_nearest"),
}


class StubGraph:
    """A replay: the chunk's work, no launch counted."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        counts = [c.launches for c in COUNTED]
        self.body()
        for c, n in zip(COUNTED, counts):
            c.launches = n


class StubCapture:
    """``capture(body, generator)`` for ``states`` and ``rng``: runs the
    chunk's Python once, then puts back the state, the stream and the
    staging buffers, since a capture runs no device work."""

    def __init__(self, states, rng):
        self.states, self.rng = states, rng
        self.generators = []
        self.graphs = []  # weak references to the graphs it made

    def _tensors(self):
        st = [getattr(self.states, f.name)
              for f in dataclasses.fields(self.states)]
        if isinstance(self.rng, PerChainStreams):
            st.append(self.rng.step)
        return st

    def __call__(self, body, generator):
        self.generators.append(generator)
        saved = [t.clone() for t in self._tensors()]
        gen_state = (self.rng.get_state()
                     if isinstance(self.rng, torch.Generator) else None)
        body()
        for t, s in zip(self._tensors(), saved):
            t.copy_(s)
        if gen_state is not None:
            self.rng.set_state(gen_state)
        graph = StubGraph(body)
        self.graphs.append(weakref.ref(graph))
        return graph


@pytest.fixture(scope="module")
def farms():
    p = small_problem(H=48, W=48)
    return {"crf": MultiChainSampler(small_chain(p, blocks=(8, 12)), N,
                                     device="cpu"),
            "sgs": MultiChainSampler(small_sgs_chain(p), N, device="cpu")}


def _start(sampler, seeding):
    """A fresh state and stream of the farm, and a second, equal pair."""
    seeds = 11 if seeding == "int" else [11, 12, 13]
    states = sampler.init(seeds=seeds)
    other = dataclasses.replace(states, **{
        f.name: getattr(states, f.name).clone()
        for f in dataclasses.fields(states)})
    rng = (make_generator(11, CPU) if seeding == "int"
           else PerChainStreams.from_seeds(seeds, CPU))
    return (states, sampler.generator), (other, rng)


def _stream_state(rng):
    return (rng.get_state() if isinstance(rng, torch.Generator)
            else rng.step.clone())


def _assert_same(got, want):
    """Traces and states bit for bit (the bytes of every tensor)."""
    got_states, got_tr = got
    want_states, want_tr = want
    assert set(got_tr) == set(want_tr)
    for k in want_tr:
        assert got_tr[k].shape == want_tr[k].shape, k
        assert torch.equal(got_tr[k].view(torch.uint8),
                           want_tr[k].view(torch.uint8)), k
    for f in dataclasses.fields(want_states):
        assert torch.equal(getattr(got_states, f.name),
                           getattr(want_states, f.name)), f.name


def _chunked(sampler, states, rng, n, save_beds=False, capture=None,
             graphs=None, **kw):
    capture = capture or StubCapture(states, rng)
    return ps.run_chains_chunked(sampler.static, sampler.consts, states, n,
                                 save_beds, rng=rng, capture=capture,
                                 graphs=graphs, **kw)


@pytest.mark.parametrize("save_beds", [False, True])
@pytest.mark.parametrize("n_steps", STEPS)
@pytest.mark.parametrize("seeding", ["int", "list"])
@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_chunked_loop_is_the_eager_loop(farms, family, seeding, n_steps,
                                        save_beds):
    """Warm-up, chunks replayed from staging, copy-back and remainder give
    ``run_chains_eager``'s traces, states and stream bit for bit; the
    returned state is the caller's, its tensors updated in place; a graph
    is kept only when a whole chunk follows the warm-up."""
    sampler = farms[family]
    (st_a, rng_a), (st_b, rng_b) = _start(sampler, seeding)
    ids = [getattr(st_b, f.name).data_ptr()
           for f in dataclasses.fields(st_b)]
    want = ps.run_chains_eager(sampler.static, sampler.consts, st_a,
                               n_steps, save_beds, rng=rng_a)
    capture = StubCapture(st_b, rng_b)
    graphs = ps.GraphCache()
    got = _chunked(sampler, st_b, rng_b, n_steps, save_beds, capture, graphs)
    assert got[0] is st_b
    assert [getattr(st_b, f.name).data_ptr()
            for f in dataclasses.fields(st_b)] == ids
    _assert_same(got, want)
    assert torch.equal(_stream_state(rng_b), _stream_state(rng_a))
    kept = graphs.graph
    captured = n_steps >= WARM + CHUNK
    assert (kept is not None) == captured
    if captured:
        assert kept.replays == (n_steps - WARM) // CHUNK
        assert kept.steps == CHUNK
        assert set(kept.staging) == set(want[1])
        assert capture.generators == [rng_b if seeding == "int" else None]


@pytest.mark.parametrize("seeding", ["int", "list"])
@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_kept_graph_replays_across_calls(farms, family, seeding):
    """Three segments on the same operands: the first captures, the later
    ones replay the kept graph from their first step (no warm-up, no
    capture), and all three are the eager loop's, bit for bit."""
    sampler = farms[family]
    (st_a, rng_a), (st_b, rng_b) = _start(sampler, seeding)
    capture = StubCapture(st_b, rng_b)
    graphs = ps.GraphCache()
    for i, n in enumerate((WARM + CHUNK + 1, 2 * CHUNK, CHUNK + 2)):
        want = ps.run_chains_eager(sampler.static, sampler.consts, st_a, n,
                                   rng=rng_a)
        st_a = want[0]
        got = _chunked(sampler, st_b, rng_b, n, capture=capture,
                       graphs=graphs)
        _assert_same(got, want)
        assert len(capture.generators) == 1, i
    assert graphs.graph.replays == 1 + 2 + 1


def test_kept_graph_is_dropped_when_an_operand_changes(farms,
                                                      monkeypatch):
    """Another state, ``save_beds``, stream, chunk length or ``impl``
    captures anew; the sampler's ``init`` and ``restore_generator`` drop
    the graph it keeps."""
    sampler = farms["crf"]
    (states, rng), (other, _) = _start(sampler, "int")
    graphs = sampler.graphs
    capture = StubCapture(states, rng)
    n = WARM + CHUNK
    _chunked(sampler, states, rng, n, capture=capture, graphs=graphs)
    first = graphs.graph
    _chunked(sampler, states, rng, CHUNK, capture=capture, graphs=graphs)
    assert graphs.graph is first and len(capture.generators) == 1
    for kw in (dict(save_beds=True), dict(impl="eager")):
        _chunked(sampler, states, rng, n, capture=capture, graphs=graphs,
                 **kw)
        assert graphs.graph is not first
        first = graphs.graph
    monkeypatch.setattr(ps, "CHUNK_STEPS", CHUNK + 1)
    _chunked(sampler, states, rng, n + 1, capture=capture, graphs=graphs)
    assert graphs.graph.steps == CHUNK + 1
    monkeypatch.undo()
    _chunked(sampler, other, rng, n, capture=StubCapture(other, rng),
             graphs=graphs)
    assert graphs.graph.operands[2] is other
    first = graphs.graph
    rng2 = make_generator(3, CPU)
    _chunked(sampler, other, rng2, n, capture=StubCapture(other, rng2),
             graphs=graphs)
    assert graphs.graph is not first
    sampler.restore_generator(*sampler.generator_state())
    assert graphs.graph is None
    _chunked(sampler, other, rng2, n, capture=StubCapture(other, rng2),
             graphs=graphs)
    sampler.init(seeds=1)
    assert graphs.graph is None


def test_graph_lives_with_its_owner(farms):
    """A graph lives as long as the cache that holds it: a call given no
    cache lets its graph go when it returns; one farm's cache does not
    touch another's; a dropped graph and its hold on the operands go."""
    sampler = farms["crf"]
    (states, rng), (other, rng_o) = _start(sampler, "list")
    n = WARM + CHUNK
    capture = StubCapture(states, rng)
    _chunked(sampler, states, rng, n, capture=capture)
    gc.collect()
    assert len(capture.graphs) == 1 and capture.graphs[0]() is None
    mine, theirs = ps.GraphCache(), ps.GraphCache()
    _chunked(sampler, states, rng, n, graphs=mine)
    _chunked(sampler, other, rng_o, n, graphs=theirs)
    kept = mine.graph
    _chunked(sampler, states, rng, CHUNK, graphs=mine)
    assert mine.graph is kept and kept.replays == 2
    assert theirs.graph.operands[2] is other
    probe = weakref.ref(kept)
    del kept
    mine.drop()
    gc.collect()
    assert probe() is None and theirs.graph is not None


@pytest.mark.parametrize("seeding", ["int", "list"])
@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_launch_counts_add_up_over_replays(farms, family, seeding,
                                           monkeypatch):
    """With every plain version counted as its dispatcher counts a kernel
    launch, the chunked loop's counts equal the eager loop's, each kernel
    of the path once a step: the capture's count is taken back, and each
    replay adds it."""
    for fn in COUNTED:  # every registered dispatcher's plain version
        module = sys.modules[fn.__module__]
        plain = getattr(module, fn.__name__ + "_reference")

        def counted(*a, _fn=fn, _plain=plain, **kw):
            _fn.launches += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(module, fn.__name__ + "_reference", counted)
    counters = {c.__name__: c for c in COUNTED}
    for c in counters.values():
        monkeypatch.setattr(c, "launches", 0)
    sampler = farms[family]
    (st_a, rng_a), (st_b, rng_b) = _start(sampler, seeding)
    n = WARM + 2 * CHUNK + 1
    ps.run_chains_eager(sampler.static, sampler.consts, st_a, n, rng=rng_a)
    eager = {k: c.launches for k, c in counters.items()}
    for c in counters.values():
        c.launches = 0
    graphs = ps.GraphCache()
    _chunked(sampler, st_b, rng_b, n, graphs=graphs)
    chunked = {k: c.launches for k, c in counters.items()}
    want = {k: n if k in KERNELS[family, seeding] else 0 for k in counters}
    assert eager == want
    assert chunked == want
    kept = graphs.graph
    assert kept.replays == 2
    assert {c.__name__: m for c, m in kept.launches} == {
        k: CHUNK for k, v in want.items() if v}


def test_counts_stand_when_the_capture_fails(farms):
    """A capture that raises leaves the launch counters as they stood and
    keeps no graph; the error reaches the caller."""
    sampler = farms["crf"]
    (states, rng), _ = _start(sampler, "int")
    before = [c.launches for c in COUNTED]
    graphs = ps.GraphCache()

    def failing(body, generator):
        COUNTED[0].launches += 5
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        _chunked(sampler, states, rng, WARM + CHUNK, capture=failing,
                 graphs=graphs)
    assert [c.launches for c in COUNTED] == before
    assert graphs.graph is None


def test_cpu_states_run_the_eager_loop(farms):
    """``run_chains`` on CPU tensors is ``run_chains_eager`` (no graph is
    captured or kept, a cache given or not); the chunked loop refuses a
    state whose tensors share memory."""
    sampler = farms["crf"]
    (st_a, rng_a), (st_b, rng_b) = _start(sampler, "list")
    n = WARM + CHUNK
    want = ps.run_chains_eager(sampler.static, sampler.consts, st_a, n,
                               rng=rng_a)
    graphs = ps.GraphCache()
    got = ps.run_chains(sampler.static, sampler.consts, st_b, n, rng=rng_b,
                        graphs=graphs)
    _assert_same(got, want)
    assert graphs.graph is None
    shared = dataclasses.replace(st_b, loss_data_comp=st_b.loss_comp)
    with pytest.raises(ValueError, match="share memory"):
        _chunked(sampler, shared, rng_b, n)


def test_one_chain_rows_survive_the_in_place_state(farms):
    """The single-chain runners prepend the initial state as row 0; the
    chunked loop updates that state's tensors in place, so row 0 is a
    copy taken before the steps."""
    sampler = farms["crf"]
    (states, rng), _ = _start(sampler, "list")
    one = dataclasses.replace(states, **{
        f.name: getattr(states, f.name)[:1].clone()
        for f in dataclasses.fields(states)})
    loss0 = one.loss_mc.clone()
    head = ps.initial_row(sampler.consts, one)
    _chunked(sampler, one, PerChainStreams.from_seeds([11], CPU),
             WARM + CHUNK)
    assert not torch.equal(one.loss_mc, loss0) or one.accepted.sum() == 0
    assert torch.equal(head["loss_mc"][0], loss0)


# --- against the JAX package's run_chains, at the seam ----------------------

def test_chunked_loop_matches_jax_run_chains_at_the_seam(monkeypatch):
    """The JAX package's ``run_chains`` (one ``lax.scan``) and the port's
    chunked loop over ``WARM + 2 * CHUNK + 3`` steps of the CRF Matérn
    case, both fed the same numpy draws a step: the JAX step reads them
    by (chain, step) from its key's data, the port's by the per-chain
    streams' device step.  Accept flags and blocks equal, losses to rtol
    1e-6, fields and probes to rtol 5e-5 / atol 1e-3 (float32 gradient
    arithmetic in another order, as in ``tests/test_torch_chain_crf.py``).
    """
    p = make_synthetic_problem(H=64, W=64)
    jchain = _jax_chain(p, "crf_matern")
    jstatic, jconsts = jchain.build()
    pstatic, pconsts = consts_from_numpy(jax.tree.map(np.asarray, jconsts),
                                         dataclasses.asdict(jstatic),
                                         device="cpu")
    beds = np.random.default_rng(3).normal(
        p["initial_bed"], 5.0, (SEAM_N, 64, 64)).astype(np.float32)
    beds = np.minimum(beds, p["surf"] - 5.0).astype(np.float32)
    built = dict(jconsts=jconsts, beds=beds)
    T = WARM + 2 * CHUNK + 3
    rng = np.random.default_rng(17)
    draws = [_draws(rng, pstatic, pconsts) for _ in range(T)]
    region = np.asarray(jconsts.region_cells)
    pairs = np.asarray(jconsts.rf.pairs)

    # the JAX side: a step reading its draws at (chain, step) = key data
    tab = {
        "f": jnp.stack([_jax_finished(d, jstatic, jconsts) for d in draws]),
        "h": jnp.asarray(np.stack([pairs[1, d["size_idx"]] for d in draws])),
        "w": jnp.asarray(np.stack([pairs[0, d["size_idx"]] for d in draws])),
        "cx": jnp.asarray(np.stack([region[d["cidx"], 0] for d in draws])),
        "cy": jnp.asarray(np.stack([region[d["cidx"], 1] for d in draws])),
        "u": jnp.asarray(np.stack([d["u"] for d in draws]))}
    mh = jmake_kernel(jstatic)

    def table_step(static):
        def step(consts, state):
            kd = jax.random.key_data(state.key)
            i, t = kd[0], kd[1]
            nxt = jax.random.wrap_key_data(kd + jnp.array([0, 1], kd.dtype))
            return mh(consts, state, tab["f"][t, i], tab["h"][t, i],
                      tab["w"][t, i], tab["cx"][t, i], tab["cy"][t, i],
                      tab["u"][t, i], nxt)
        return step

    monkeypatch.setattr(jsampler, "make_step", table_step)
    jstates = _jax_states(built)
    data = jax.random.key_data(jstates.key)
    jstates = dataclasses.replace(jstates, key=jax.random.wrap_key_data(
        jnp.zeros_like(data).at[:, 0].set(jnp.arange(SEAM_N,
                                                     dtype=data.dtype))))
    jfinal, jtr = jsampler.run_chains.__wrapped__(jstatic, jconsts, jstates,
                                                  T)

    # the port's side: a draw reading its draws at the streams' step
    ptab = [_port_draws(d) for d in draws]
    stacked = {f.name: torch.stack([getattr(d, f.name) for d in ptab])
               for f in dataclasses.fields(chain_crf.Draws)
               if getattr(ptab[0], f.name) is not None}

    def table_draw(gen, static, consts, n, impl="auto"):
        return chain_crf.Draws(**{k: v[gen.step][0]
                                  for k, v in stacked.items()})

    monkeypatch.setattr(chain_crf, "draw", table_draw)
    pstates = state_from_numpy(_numpy_state(_jax_states(built)),
                               device="cpu")
    streams = PerChainStreams.from_seeds(list(range(SEAM_N)), CPU)
    graphs = ps.GraphCache()
    pfinal, ptr = ps.run_chains_chunked(
        pstatic, pconsts, pstates, T, rng=streams, graphs=graphs,
        capture=StubCapture(pstates, streams))
    assert graphs.graph.replays == 2
    assert int(streams.step) == T
    np.testing.assert_array_equal(ptr["step"].numpy(), np.asarray(jtr["step"]))
    np.testing.assert_array_equal(ptr["block"].numpy(),
                                  np.asarray(jtr["block"]))
    for k in ("loss_mc", "loss_data", "loss"):
        np.testing.assert_allclose(ptr[k].numpy(), np.asarray(jtr[k]),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(ptr["samples"].numpy(),
                               np.asarray(jtr["samples"]), rtol=5e-5,
                               atol=1e-3)
    np.testing.assert_allclose(pfinal.fields.numpy(),
                               np.asarray(jfinal.fields), rtol=5e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(pfinal.accepted.numpy(),
                                  np.asarray(jfinal.accepted))
    assert 0 < int(pfinal.accepted.sum()) < T * SEAM_N
