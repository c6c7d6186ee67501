"""The port's run API against the JAX package's, on the CPU.

- ``ChainCRF.run`` / ``ChainSGS.run``: the return dict against the JAX
  package's (keys, shapes and dtypes; row 0, the initial state, to rtol
  1e-5: both packages compute the initial loss in float32 with sums in
  another order).  The draws cannot match across frameworks, so the rest
  holds the port to its own contracts: a run is the one-chain farm seeded
  ``[seed]`` bit for bit; its draws are bitwise chain 0's in a farm seeded
  ``[seed, seed + 1]``, and its traces agree with that chain to rtol 1e-6
  (the CPU's batched ``irfft2`` is not batch-invariant,
  ``tests/test_torch_seeds.py``); observers, a ``RandField`` configured
  like the chain and ``set_random_generator`` change no bit; a second run
  continues the stream; the JAX error texts.
- ``MultiChainSampler.run(collect_beds=...)`` and
  ``run_segment(save_beds=...)``: layouts against the JAX sampler's at 2
  chains, values against the JAX sampler's where no draw is involved
  (``n_iter = 1``) and against the port's own states elsewhere.
- ``profile_dir``: a trace is written only when there is a second
  segment.
- The progress output: one status line a segment, field by field as the
  JAX sampler's; the per-chain block only with ``fancy_progress``.
"""

import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from mcmc_tpu.models.randfield import RandField as JRandField
from mcmc_tpu.parallel.sampler import MultiChainSampler as JSampler
from mcmc_tpu_torch import MultiChainSampler
from mcmc_tpu_torch.models import chain_crf as crf
from mcmc_tpu_torch.models import chain_sgs as sgs
from mcmc_tpu_torch.models.randfield import RandField
from mcmc_tpu_torch.utils.rng import PerChainStreams
from tests.conftest import make_synthetic_problem
from tests.test_torch_chain_crf import _jax_chain, _port_chain
from tests.test_torch_chain_sgs import chain_pair

N_ITER = 21
PROBES_SGS = np.array([[8000.0, 9000.0]])
ROW0_RTOL = 1e-5
TRACE_RTOL = 1e-6
LINE = re.compile(r"^\[sampler\] iter (\d+)/(\d+) \| ([\d,]+) chain-it/s \| "
                  r"loss mean (-?\d\.\d{4}e[+-]\d\d) \| acc (\d\.\d{3})$")


@pytest.fixture(scope="module")
def problem():
    return make_synthetic_problem(H=48, W=48)


@pytest.fixture(scope="module")
def crf_pair(problem):
    jchain = _jax_chain(problem, "crf_matern")
    return jchain, _port_chain(problem, jchain)


@pytest.fixture(scope="module")
def sgs_pair(problem):
    jchain, pchain = chain_pair(problem, "transform_detrend")
    for c in (jchain, pchain):
        c.set_sample_points_locations(PROBES_SGS)
    return jchain, pchain


def _pair(request, family):
    return request.getfixturevalue(f"{family}_pair")


def _same(a, b):
    """Two run dicts equal bit for bit (final states aside)."""
    assert set(a) == set(b)
    for k in a:
        if k != "final_state":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --- ChainCRF.run / ChainSGS.run --------------------------------------------

@pytest.mark.parametrize("family,save_beds", [("crf", True), ("crf", False),
                                              ("sgs", False)])
def test_run_dict_matches_jax(request, family, save_beds):
    jchain, pchain = _pair(request, family)
    n = 6
    want = jchain.run(n, save_beds=save_beds, seed=1)
    got = pchain.run(n, save_beds=save_beds, seed=1, device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "final_state":
            continue
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        assert got[k].dtype == w.dtype, k
    for k in ("loss_mc", "loss_data", "loss"):
        np.testing.assert_allclose(got[k][0], np.asarray(want[k])[0],
                                   rtol=ROW0_RTOL, err_msg=k)
    assert not got["steps"][0] and np.isnan(got["blocks"][0]).all()
    np.testing.assert_allclose(got["sample_values"][:, 0],
                               np.asarray(want["sample_values"])[:, 0],
                               rtol=ROW0_RTOL)
    if save_beds:
        np.testing.assert_allclose(got["bed"][0], np.asarray(want["bed"])[0],
                                   rtol=ROW0_RTOL)
        np.testing.assert_array_equal(got["bed"][-1],
                                      got["final_state"].bed[0].numpy())
    if family == "sgs":
        assert got["loss_data"][0] == 0.0
        # a data-space bed: the trend restored
        np.testing.assert_array_equal(
            got["bed"], (got["final_state"].bed[0]
                         + torch.as_tensor(pchain.trend)).numpy())
    assert got["final_state"].fields.shape[0] == 1


@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_run_is_the_one_chain_farm(request, family):
    """run(seed=s) is the 1-chain farm seeded [s] bit for bit; its draws
    are chain 0's in the farm seeded [s, s + 1], bit for bit, and its
    traces that chain's to rtol 1e-6."""
    _, pchain = _pair(request, family)
    s = 41
    out = pchain.run(N_ITER, seed=s, save_beds=True, device="cpu")
    sampler = MultiChainSampler(pchain, 1, device="cpu")
    _, tr = sampler.run(sampler.init(seeds=[s]), N_ITER, progress=False)
    for k, name in (("loss", "loss"), ("step", "steps"), ("block", "blocks"),
                    ("loss_mc", "loss_mc")):
        np.testing.assert_array_equal(out[name], tr[k][0], err_msg=k)
    pair = MultiChainSampler(pchain, 2, device="cpu")
    _, tr2 = pair.run(pair.init(seeds=[s, s + 1]), N_ITER, progress=False)
    np.testing.assert_allclose(out["loss"], tr2["loss"][0], rtol=TRACE_RTOL)
    static, consts = pchain.build("cpu")
    draw = crf.draw if family == "crf" else sgs.draw
    one = PerChainStreams.from_seeds([s], "cpu")
    two = PerChainStreams.from_seeds([s, s + 1], "cpu")
    for _ in range(3):
        d1, d2 = draw(one, static, consts, 1), draw(two, static, consts, 2)
        for f in dataclasses.fields(d1):
            a, b = getattr(d1, f.name), getattr(d2, f.name)
            if a is not None:
                assert torch.equal(a[0], b[0]), f.name
        one.advance()
        two.advance()


@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_observers_change_no_bit(request, family, capsys):
    """progress_bar and plot segment the run into info_per_iter steps;
    the traces are those of the one-segment run, bit for bit, and the
    progress line is the JAX package's (iteration count, loss, cumulative
    acceptance, it/s)."""
    import matplotlib

    matplotlib.use("Agg")
    _, pchain = _pair(request, family)
    plain = pchain.run(N_ITER, seed=3, save_beds=True, device="cpu")
    capsys.readouterr()
    seen = pchain.run(N_ITER, seed=3, save_beds=True, device="cpu",
                      progress_bar=True, plot=True, info_per_iter=8)
    _same(plain, seen)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" | ")[0] for ln in lines] == [
        "iter 8/20", "iter 16/20", "iter 20/20"]
    _, loss, acc, _ = lines[-1].split(" | ")
    assert loss == f"loss {float(plain['loss'][-1]):.6e}"
    assert acc == f"acc {plain['steps'][1:].mean():.3f}"


def test_stream_continues_and_restarts_from_the_initial_bed(crf_pair):
    """A second run with no seed continues the first run's stream (as
    ``self._key = final.key`` does) from the initial bed: its traces are
    those of a 1-chain farm [s] that drew the first run's steps and then
    restarted from the initial bed."""
    _, pchain = crf_pair
    s = 9
    first = pchain.run(N_ITER, seed=s, device="cpu")
    second = pchain.run(N_ITER, device="cpu")
    assert not np.array_equal(first["loss"], second["loss"])
    assert second["loss"][0] == first["loss"][0]
    sampler = MultiChainSampler(pchain, 1, device="cpu")
    sampler.run_segment(sampler.init(seeds=[s]), N_ITER - 1)
    state = crf.init_state(pchain.initial_bed, sampler.consts, 1)
    _, tr = sampler.run(state, N_ITER, progress=False)
    np.testing.assert_array_equal(second["loss"], tr["loss"][0])
    # set_random_generator restarts the stream
    pchain.set_random_generator(s)
    _same(first, pchain.run(N_ITER, device="cpu"))


def test_randfield_is_adopted_and_errors_are_the_references(crf_pair):
    jchain, pchain = crf_pair
    cfg, blocks, weights = (pchain._rf_cfg, pchain._block_cfg,
                            pchain._weight_cfg)

    def wrapper(cls, **kw):
        rf = cls(cfg.range_min_x, cfg.range_max_x, cfg.range_min_y,
                 cfg.range_max_y, cfg.scale_min, cfg.scale_max,
                 cfg.nugget_max, cfg.model_name, cfg.isotropic,
                 cfg.smoothness, **kw)
        rf.set_block_sizes(blocks.min_block_x, blocks.max_block_x,
                           blocks.min_block_y, blocks.max_block_y,
                           blocks.steps)
        rf.set_weight_param(weights.L, weights.x0, weights.k, weights.offset,
                            weights.max_dist, weights.resolution)
        return rf

    plain = pchain.run(N_ITER, seed=2, device="cpu")
    _same(plain, pchain.run(N_ITER, wrapper(RandField, device="cpu"),
                            seed=2, device="cpu"))
    # the same texts as the JAX package's
    for chain, cls in ((jchain, JRandField), (pchain, RandField)):
        with pytest.raises(TypeError, match='The arugment "RF" has to be an '
                                            'object of the class RandField'):
            chain.run(5, object())
        bare = cls(1e3, 2e3, 1e3, 2e3, 1, 2, 0, "Gaussian", True)
        with pytest.raises(ValueError, match="RF needs set_block_sizes"):
            chain.run(5, bare)
    with pytest.raises(ValueError, match="n_iter must be >= 1"):
        pchain.run(0, device="cpu")
    with pytest.raises(ValueError, match="n_iter must be >= 1"):
        jchain.run(0)


# --- the farm's bed snapshots, profiler and progress --------------------------

def _farms(request, family, n=2):
    jchain, pchain = _pair(request, family)
    js = JSampler(jchain, n, use_mesh=False)
    ps = MultiChainSampler(pchain, n, device="cpu")
    beds = pchain.initial_bed[None].repeat(n, 0) + np.arange(n)[
        :, None, None].astype(np.float32)
    return js, ps, beds


@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_collect_beds_matches_jax(request, family):
    """``bed_thin`` is (n_chains, n_segments, H, W): at ``n_iter = 1`` one
    snapshot, the initial full-space beds, equal to the JAX sampler's; over
    3 segments the JAX layout, each snapshot the beds ``save_beds`` traced
    at that segment's end, the last the final state's."""
    js, ps, beds = _farms(request, family)
    _, jtr = js.run(js.init(initial_beds=beds, seeds=0), 1, progress=False,
                    collect_beds=True)
    _, ptr = ps.run(ps.init(initial_beds=beds, seeds=0), 1, progress=False,
                    collect_beds=True)
    assert ptr["bed_thin"].shape == jtr["bed_thin"].shape == (2, 1, 48, 48)
    np.testing.assert_allclose(ptr["bed_thin"], jtr["bed_thin"], rtol=1e-6,
                               atol=1e-3)
    _, jtr = js.run(js.init(initial_beds=beds, seeds=0), 7, segment_size=2,
                    progress=False, collect_beds=True)
    states, ptr = ps.run(ps.init(initial_beds=beds, seeds=0), 7,
                         segment_size=2, progress=False, collect_beds=True)
    assert ptr["bed_thin"].shape == jtr["bed_thin"].shape == (2, 3, 48, 48)
    assert set(ptr) == set(jtr)
    np.testing.assert_array_equal(ptr["bed_thin"][:, -1],
                                  ps.full_bed(states).numpy())
    traced = []
    st = ps.init(initial_beds=beds, seeds=0)
    for n in (2, 2):
        st, tr = ps.run_segment(st, n, save_beds=True)
        traced.append(tr["bed"][-1].numpy())
    np.testing.assert_array_equal(ptr["bed_thin"][:, :2],
                                  np.stack(traced, axis=1))


@pytest.mark.parametrize("family", ["crf", "sgs"])
def test_save_beds_layout_matches_jax(request, family):
    """``run_segment(save_beds=True)`` adds a time-major (n_steps,
    n_chains, H, W) ``traces["bed"]`` as the JAX sampler's does, each row
    the full-space bed after that step (an SGS bed with its trend)."""
    js, ps, beds = _farms(request, family)
    _, jtr = js.run_segment(js.init(initial_beds=beds, seeds=0), 3,
                            save_beds=True)
    states, ptr = ps.run_segment(ps.init(initial_beds=beds, seeds=0), 3,
                                 save_beds=True)
    assert set(ptr) == set(jtr)
    assert tuple(ptr["bed"].shape) == np.shape(jtr["bed"]) == (3, 2, 48, 48)
    torch.testing.assert_close(ptr["bed"][-1], ps.full_bed(states),
                               rtol=0, atol=0)
    _, no = ps.run_segment(ps.init(initial_beds=beds, seeds=0), 3)
    assert "bed" not in no


def test_profile_dir_traces_the_second_segment(crf_pair, tmp_path):
    _, pchain = crf_pair
    sampler = MultiChainSampler(pchain, 2, device="cpu")
    one = tmp_path / "one"
    sampler.run(sampler.init(seeds=0), 3, segment_size=2, progress=False,
                profile_dir=str(one))
    assert not one.exists() or not any(one.iterdir())
    two = tmp_path / "two"
    sampler.run(sampler.init(seeds=0), 5, segment_size=2, progress=False,
                profile_dir=str(two))
    files = list(two.iterdir())
    assert [f.name for f in files] == ["segment1.pt.trace.json"]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_progress_line_matches_jax(request, capsys):
    """progress=True: one line a segment, the JAX sampler's fields
    (iterations, chain-it/s, mean loss, mean acceptance); the initial loss
    is the same in both, so a zero-step segment's line matches in value
    too.  fancy_progress=True: the per-chain block in both."""
    js, ps, beds = _farms(request, "crf")
    out = {}
    for name, s in (("jax", js), ("port", ps)):
        capsys.readouterr()
        s.run(s.init(initial_beds=beds, seeds=0), 5, segment_size=2)
        s.run(s.init(initial_beds=beds, seeds=0), 1)
        out[name] = capsys.readouterr().out.strip().splitlines()
    assert len(out["jax"]) == len(out["port"]) == 3
    for jl, pl in zip(out["jax"], out["port"]):
        jm, pm = LINE.match(jl), LINE.match(pl)
        assert jm and pm, (jl, pl)
        assert jm.group(1, 2) == pm.group(1, 2)
        assert 0.0 <= float(pm.group(5)) <= 1.0
    # n_iter = 1: no step yet, the initial state's loss (printed to 5
    # digits from float32 sums in another order) and acceptance
    jm, pm = LINE.match(out["jax"][-1]), LINE.match(out["port"][-1])
    assert float(pm.group(4)) == pytest.approx(float(jm.group(4)),
                                               rel=2e-4)
    assert jm.group(5) == pm.group(5) == "0.000"
    for s in (js, ps):
        capsys.readouterr()
        s.run(s.init(initial_beds=beds, seeds=0), 5, segment_size=2,
              fancy_progress=True)
        text = capsys.readouterr().out
        assert "Running 2 chains | iter 5/5" in text and "\033" in text
        assert "[sampler]" not in text


def test_randfield_wrapper_matches_jax(problem):
    """The wrapper's deterministic helpers against the JAX package's
    (block menu, edge masks, CRF weights in float32 to rtol 1e-6); its
    draws have the JAX shapes and are reproduced by the seed, by the
    spectral and the gstools-SRF method."""
    args = (3e3, 8e3, 3e3, 8e3, 20.0, 60.0, 5.0, "Matern", True, 1.3)
    rfs = []
    for cls, kw in ((JRandField, {}), (RandField, dict(device="cpu"))):
        rf = cls(*args, rng_seed=4, **kw)
        rf.set_block_sizes(12, 20, 12, 20, 3)
        rf.set_weight_param(2.0, 0.0, 6.0, 1.0, 5e3, 500.0)
        rfs.append(rf)
    j, t = rfs
    np.testing.assert_array_equal(t.pairs, j.pairs)
    np.testing.assert_array_equal(t.get_block_sizes(), j.get_block_sizes())
    for a, b in zip(t.get_edge_masks(), j.get_edge_masks()):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    p = problem
    for a, b in zip(t.get_crf_weight(p["xx"], p["yy"], p["data_mask"]),
                    j.get_crf_weight(p["xx"], p["yy"], p["data_mask"])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    dist = np.hypot(p["xx"] - 4e3, p["yy"] - 9e3)
    for a, b in zip(t.get_crf_weight_from_dist(p["xx"], p["yy"], dist),
                    j.get_crf_weight_from_dist(p["xx"], p["yy"], dist)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    x = np.arange(40) * 500.0
    y = np.arange(30) * 500.0
    for n in (1, 3):
        assert t.get_random_field(x, y, n).shape == np.shape(
            j.get_random_field(x, y, n))
    block = t.get_rfblock()
    assert block.shape in [tuple(hw) for hw in t.pairs[::-1].T]
    again = RandField(*args, rng_seed=4, device="cpu")
    np.testing.assert_array_equal(again.get_random_field(x, y),
                                  RandField(*args, rng_seed=4,
                                            device="cpu").get_random_field(
                                                x, y))
    with pytest.raises(ValueError, match="square cells"):
        t.get_random_field(x, y * 2)
    # the gstools-SRF method runs, with the JAX wrapper's shapes
    for rf in (t, j):
        rf.set_generation_method(False)
    for n in (1, 3):
        f = t.get_random_field(x, y, n)
        assert f.shape == np.shape(j.get_random_field(x, y, n))
        assert np.isfinite(f).all()
    block = t.get_rfblock()
    assert block.shape in [tuple(hw) for hw in t.pairs[::-1].T]
    t.set_generation_method(True)
