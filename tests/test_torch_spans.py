"""The port's spans on the profiler's timeline (``mcmc_tpu_torch/utils/
spans.py``): the T2 chunk loop's (``geostats/sgs.py``) and the segment
loop's (``parallel/sampler.py``, ``models/chain_crf.host_copy``).

The captured loops run here through the stub captures of
``tests/test_torch_geostats_graph.py`` and ``tests/test_torch_graph_loop.py``
under a CPU ``torch.profiler``: each span appears as often as the loop's
phase runs, nested in the span the table below names, and the counts agree
with the stubs' own.  With no profiler recording, ``record_function`` is
never entered, and the results are bitwise those of a profiled call.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mcmc_tpu_torch import geostats as tgeo
from mcmc_tpu_torch.models.chain_crf import host_copy
from mcmc_tpu_torch.parallel import sampler as ps
from mcmc_tpu_torch.utils import spans
from tests.test_torch_geostats import EXP
from tests.test_torch_geostats_graph import (  # noqa: F401  (fixtures)
    C, KW, LENGTHS, _bits, _bounds, _mask, captured, problem)
from tests.test_torch_graph_loop import (  # noqa: F401  (the fixture farms)
    CHUNK, STEPS, WARM, StubCapture, _assert_same, _chunked, _start, farms)

# each span's parent: the innermost span around it
SGS_PARENTS = {"mcmc.sgs": None, "mcmc.sgs.prepare": "mcmc.sgs",
               "mcmc.sgs.eager": "mcmc.sgs", "mcmc.sgs.capture": "mcmc.sgs",
               "mcmc.sgs.chunk": "mcmc.sgs", "mcmc.sgs.finish": "mcmc.sgs",
               "mcmc.sgs.replay": "mcmc.sgs.chunk",
               "mcmc.sgs.wait": "mcmc.sgs.chunk"}
SEGMENT_PARENTS = {"mcmc.run_chains": None,
                   "mcmc.run_chains.eager": "mcmc.run_chains",
                   "mcmc.run_chains.capture": "mcmc.run_chains",
                   "mcmc.run_chains.replay": "mcmc.run_chains"}


def _profiled(fn):
    """``fn()`` under a CPU profiler: its result and the port's spans in
    the trace, [(start_ns, end_ns, name, parent name)] by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    found = sorted(
        (int(e.start_ns()), int(e.start_ns() + e.duration_ns()), e.name())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("mcmc."))
    return out, [(s, t, n, _parent(found, s, t, n)) for s, t, n in found]


def _parent(found, s, t, name):
    """The name of the shortest other span holding [s, t], or None."""
    around = [(t2 - s2, n2) for s2, t2, n2 in found
              if s2 <= s and t <= t2 and (s2, t2, n2) != (s, t, name)]
    return min(around)[1] if around else None


def _count(found, name):
    return sum(n == name for _, _, n, _ in found)


def _inside(found, outer, name):
    s, t = outer[:2]
    return [x for x in found if x[2] == name and s <= x[0] and x[1] <= t]


def _sgs_call(p, n, seed=5):
    return lambda: tgeo.sgs(p["xx"], p["yy"], p["cond_bed"], EXP,
                            device="cpu", **dict(KW, seed=seed,
                                                 sim_mask=_mask(p, n),
                                                 bounds=_bounds(p)))


def _raise(name):
    raise AssertionError(f"record_function({name!r}) entered with no "
                         "profiler recording")


@pytest.mark.parametrize("n", LENGTHS)
def test_sgs_spans_follow_the_chunk_loop(problem, captured, n):
    """One ``mcmc.sgs``, ``prepare`` and ``finish`` a call; a ``capture``
    and ``full - 1`` ``chunk`` spans where a full chunk follows the eager
    first one, as many as the stub's replays, each holding one ``replay``,
    one ``wait`` and one ``draw``; an ``eager`` span for the first chunk
    and for a tail, and a ``draw`` for every chunk of the path."""
    _, found = _profiled(_sgs_call(problem, n))
    full = n // C
    assert (_count(found, "mcmc.sgs"), _count(found, "mcmc.sgs.prepare"),
            _count(found, "mcmc.sgs.finish")) == (1, 1, 1)
    assert _count(found, "mcmc.sgs.capture") == captured.captures \
        == (1 if full >= 2 else 0)
    chunks = [x for x in found if x[2] == "mcmc.sgs.chunk"]
    assert len(chunks) == captured.replays == max(full - 1, 0)
    for chunk in chunks:
        for name in ("mcmc.sgs.replay", "mcmc.sgs.wait", "mcmc.sgs.draw"):
            assert len(_inside(found, chunk, name)) == 1, name
    eager = 1 if full < 2 else 1 + (n > full * C)
    assert _count(found, "mcmc.sgs.eager") == eager
    assert _count(found, "mcmc.sgs.draw") == -(-n // C)
    for _, _, name, parent in found:
        if name == "mcmc.sgs.draw":
            assert parent in ("mcmc.sgs.chunk", "mcmc.sgs.eager")
        else:
            assert parent == SGS_PARENTS[name], name


@pytest.mark.parametrize("n_steps", STEPS)
@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_segment_spans_follow_the_chunked_loop(farms, family, n_steps):
    """``run_chains_chunked``: one ``capture`` and ``(n - WARM_STEPS) //
    CHUNK_STEPS`` ``replay`` spans where a whole chunk follows the
    warm-up, an ``eager`` span for the warm-up and one for a tail; a
    second call on the same ``GraphCache`` captures nothing and replays
    from its first step."""
    sampler = farms[family]
    (states, rng), _ = _start(sampler, "int")
    graphs = ps.GraphCache()
    capture = StubCapture(states, rng)
    _, found = _profiled(lambda: _chunked(sampler, states, rng, n_steps,
                                          capture=capture, graphs=graphs))
    captured = n_steps >= WARM + CHUNK
    replays = (n_steps - WARM) // CHUNK if captured else 0
    warm = min(WARM, n_steps)
    tail = n_steps - warm - replays * CHUNK
    assert _count(found, "mcmc.run_chains.capture") == int(captured)
    assert _count(found, "mcmc.run_chains.replay") == replays
    assert _count(found, "mcmc.run_chains.eager") == (warm > 0) + (tail > 0)
    assert all(parent is None for *_, parent in found)  # no run_chains here
    if not captured:
        return
    assert graphs.graph.replays == replays
    _, again = _profiled(lambda: _chunked(sampler, states, rng, 2 * CHUNK,
                                          capture=capture, graphs=graphs))
    assert _count(again, "mcmc.run_chains.capture") == 0
    assert _count(again, "mcmc.run_chains.replay") == 2
    assert _count(again, "mcmc.run_chains.eager") == 0


@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_sampler_run_spans_segments_and_copies(farms, family):
    """``MultiChainSampler.run`` on the CPU: one ``mcmc.run_chains`` span
    a segment, each outermost (the eager loop has no inner spans on the
    CPU), and the segment-end copies as ``mcmc.host_copy`` outside them."""
    sampler = farms[family]
    states = sampler.init(seeds=3)
    _, found = _profiled(lambda: sampler.run(states, 1 + 3 * 4,
                                             segment_size=4, progress=False))
    names = {name for _, _, name, _ in found}
    assert names == {"mcmc.run_chains", "mcmc.host_copy"}
    assert _count(found, "mcmc.run_chains") == 3
    assert all(parent is None for *_, parent in found)


def test_spans_nest_as_the_table_says(farms, monkeypatch):
    """Through ``run_chains`` on the card's path (the chunked loop, with
    the stub capture): every segment span sits in ``mcmc.run_chains``."""
    sampler = farms["crf"]
    (states, rng), _ = _start(sampler, "int")
    capture = StubCapture(states, rng)
    monkeypatch.setattr(ps, "run_chains_eager",  # CPU states, card's path
                        lambda *a, **k: ps.run_chains_chunked(
                            *a, capture=capture, **k))
    _, found = _profiled(lambda: ps.run_chains(
        sampler.static, sampler.consts, states, WARM + 2 * CHUNK + 1,
        rng=rng))
    assert _count(found, "mcmc.run_chains") == 1
    assert _count(found, "mcmc.run_chains.replay") == 2
    for _, _, name, parent in found:
        assert parent == SEGMENT_PARENTS[name], name


def test_host_copy_span_under_a_profiler_only(monkeypatch):
    """``host_copy`` is one ``mcmc.host_copy`` span under a profiler and
    enters no ``record_function`` without one."""
    t = torch.arange(6.0)
    got, found = _profiled(lambda: host_copy(t))
    assert [x[2] for x in found] == ["mcmc.host_copy"]
    monkeypatch.setattr(spans, "record_function", _raise)
    np.testing.assert_array_equal(host_copy(t), got)


def test_idle_spans_enter_nothing_and_change_no_bits(problem, farms,
                                                    request, monkeypatch):
    """With no profiler recording, ``record_function`` is never entered
    (it raises here); the bed, the traces and the states are bitwise those
    of a profiled call with the same seed."""
    p = problem
    n = 2 * C + 3
    (st_a, rng_a), (st_b, rng_b) = _start(farms["sgs"], "int")
    steps = WARM + 2 * CHUNK + 3
    stub = request.getfixturevalue("captured")
    bed, found = _profiled(_sgs_call(p, n))
    segment, _ = _profiled(lambda: _chunked(farms["sgs"], st_a, rng_a,
                                            steps))
    assert found and stub.replays == n // C - 1
    assert not spans._profiler_enabled()
    monkeypatch.setattr(spans, "record_function", _raise)
    np.testing.assert_array_equal(_bits(_sgs_call(p, n)()), _bits(bed))
    _assert_same(_chunked(farms["sgs"], st_b, rng_b, steps), segment)
    assert torch.equal(rng_a.get_state(), rng_b.get_state())
    for f in dataclasses.fields(st_a):
        assert torch.equal(getattr(st_a, f.name), getattr(st_b, f.name))


def test_span_is_a_shared_null_context_when_idle():
    """Idle, every span is the one null context, whatever its name."""
    assert spans.span("mcmc.a") is spans.span("mcmc.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("mcmc.a") is not spans.span("mcmc.b")
