"""Per-chain seed lists in the PyTorch port, on the CPU.

A farm seeded with a list draws every value from Philox4x32-10 keyed by
its chain's own key (``utils/rng.PerChainStreams``, ``ops/chain_draws.py``,
the keyed entry of ``ops/noise_kernel.py``).  Here, with the plain
versions the CUDA kernels are held to on the card:

- the Philox words against an independent numpy Philox4x32-10, itself
  checked against Random123's known answers, and the uniform, index and
  normal conversions word for word and at their edges;
- ``resolve_seed`` and ``MultiChainSampler.init`` take a list by the JAX
  package's rules (``mcmc_tpu/parallel/sampler.py:367-372``: fewer than
  ``n_chains`` seeds raise, the first ``n_chains`` are used);
- chain i of a 3-chain list-seeded farm draws bitwise what the 1-chain
  farm seeded ``[seeds[i]]`` draws, for both families.  Its traces agree
  to rtol 1e-6: ``torch.fft.irfft2`` on the CPU is not batch-invariant
  (a batch of 3 and a batch of 1 round ~1e-8 apart), and the loss ledger
  carries that into its last bits;
- the masked square sums of the SGS step's loss delta
  (``ops/physics.masked_sq_sum``), the op that made chain 0's traces
  depend on the batch on the card, give each chain of a batch of 3 the
  bits it gets alone;
- a list-seeded checkpoint resumes bit for bit, and is refused by an
  int-seeded sampler and the other way round;
- the drivers and the CLI with a seed list give results of the JAX
  package's shape and format for the same config.
"""

import json

import numpy as np
import pytest
import torch

from mcmc_tpu_torch import MultiChainSampler, cli, drivers
from mcmc_tpu_torch.io.checkpoint import run_with_checkpointing
from mcmc_tpu_torch.models import chain_crf as crf
from mcmc_tpu_torch.models import chain_sgs as sgs
from mcmc_tpu_torch.models import randfield
from mcmc_tpu_torch.ops.chain_draws import (SLOTS, DrawPlan, chain_draws,
                                            chain_draws_reference, draw_plan,
                                            entry, index_from_words,
                                            uniform_from_words)
from mcmc_tpu_torch.ops.noise_kernel import (batched_normal_keyed,
                                             batched_normal_keyed_reference,
                                             box_muller, keyed_words)
from mcmc_tpu_torch.ops.spectral import field_params, sample_field_params
from mcmc_tpu_torch.utils.rng import (PER_CHAIN_KIND, PerChainStreams,
                                      chain_keys, generator_state,
                                      make_generator, resolve_seed,
                                      restore_generator, splitmix64)
from tests.conftest import make_synthetic_problem
from tests.test_torch_cli import _crf_config, _write_dataset
from tests.torch_helpers import small_chain, small_sgs_chain

SEEDS = [11, 22, 33]
SPECTRUM = SLOTS["spectrum"]  # the keyed noise's slot on the CRF path
M32 = 0xFFFFFFFF
# Random123 kat_vectors: philox4x32 10 (counter, key) -> output
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def numpy_philox(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11) on uint64 numpy arrays of
    32-bit words: an independent transcription of the generator."""
    c = [np.asarray(v, np.uint64) for v in ctr]
    k0, k1 = (np.asarray(v, np.uint64) for v in key)
    m = np.uint64(M32)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & m,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & m]
        k0 = (k0 + np.uint64(0x9E3779B9)) & m
        k1 = (k1 + np.uint64(0xBB67AE85)) & m
    return c


def _streams(seeds, step=0):
    s = PerChainStreams.from_seeds(seeds, "cpu")
    s.step.fill_(step)
    return s


@pytest.mark.parametrize("ctr,key,want", KNOWN_ANSWERS)
def test_numpy_philox_known_answers(ctr, key, want):
    got = numpy_philox(ctr, key)
    assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("step", [0, 5, (3 << 32) + 7])
def test_keyed_words_match_numpy_philox(step):
    """Chain c's call j at ``slot``: key keys[c], counter (step low word,
    slot, j, step high word)."""
    s = _streams(SEEDS, step)
    words = keyed_words(s.keys, s.step, SPECTRUM, 6)
    keys = chain_keys(SEEDS).astype(np.uint64)
    j = np.arange(6, dtype=np.uint64)[None, :]
    want = numpy_philox((step & M32, SPECTRUM, j, step >> 32),
                        (keys[:, :1], keys[:, 1:]))
    for w, ww in zip(words, want):
        np.testing.assert_array_equal(w.numpy(), np.broadcast_to(ww, (3, 6)))


def test_chain_keys_are_splitmix64_of_the_seeds():
    # SplitMix64's first output from state 0 (Vigna's reference code)
    assert splitmix64(0) == 0xE220A8397B1DCDAF
    keys = chain_keys([0, -1, 2 ** 64 + 5])
    z0, zm1 = splitmix64(0), splitmix64(2 ** 64 - 1)
    assert keys.dtype == np.uint32
    assert tuple(keys[0]) == (z0 & M32, z0 >> 32)
    assert tuple(keys[1]) == (zm1 & M32, zm1 >> 32)
    assert tuple(keys[2]) == tuple(chain_keys([5])[0])


PLAN = DrawPlan((entry("u", "uniform", 7), entry("cidx", "index", 5, n=1000,
                                                   lo=3),
                 entry("bsx", "index", 3, n=2 ** 32 - 1),
                 entry("noise", "normal", 9), entry("drop_u", "uniform", 1)))


def test_plan_values_word_for_word():
    """Every value of an odd plan from its own words: uniform element e
    from word e % 4 of call e // 4, index e from words (2(e % 2),
    2(e % 2) + 1) of call e // 2, normal 4c .. 4c + 3 from Box-Muller of
    words (0, 1) and (2, 3) of call c; at the entry's own slot."""
    s = _streams(SEEDS, 12)
    views = draw_plan(s, PLAN)
    keys = chain_keys(SEEDS).astype(np.uint64)
    for e in PLAN.entries:
        per = 2 if e.kind == "index" else 4
        calls = -(-e.count // per)
        w = numpy_philox((12, e.slot, np.arange(calls, dtype=np.uint64)[None],
                          0), (keys[:, :1], keys[:, 1:]))
        w = [np.broadcast_to(x, (3, calls)).astype(np.int64) for x in w]
        got = views[e.name]
        assert got.shape == (3, e.count)
        if e.kind == "uniform":
            bits = np.stack(w, -1).reshape(3, -1)[:, :e.count]
            want = (bits >> 8).astype(np.float32) * np.float32(2.0 ** -24)
            np.testing.assert_array_equal(got.numpy(), want)
        elif e.kind == "index":
            x = [(w[0] << 32 | w[1]), (w[2] << 32 | w[3])]
            want = [[e.lo + (int(v) * e.n >> 64) for v in row]
                    for row in np.stack(x, -1).reshape(3, -1).astype(
                        np.uint64)]
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want)[:, :e.count])
            assert got.dtype == torch.int64
        else:
            t = [torch.from_numpy(x) for x in w]
            zc0, zs0 = box_muller(t[0], t[1])
            zc1, zs1 = box_muller(t[2], t[3])
            want = torch.stack([zc0, zs0, zc1, zs1], -1).reshape(3, -1)
            assert torch.equal(got, want[:, :e.count])


def test_plan_layout_is_aligned_for_the_kernel():
    assert PLAN.floats % 4 == 0 and PLAN.ints % 2 == 0
    for e, row in zip(PLAN.entries, PLAN.table):
        assert row[5] % (2 if e.kind == "index" else 4) == 0
        assert row[0] == SLOTS[e.name]
    assert PLAN.calls == 2 + 3 + 2 + 3 + 1
    with pytest.raises(ValueError, match="differ"):
        DrawPlan((entry("u", "uniform"), entry("u", "normal")))
    with pytest.raises(ValueError, match="2\\^32"):
        entry("cidx", "index", n=0)
    with pytest.raises(ValueError, match="kind"):
        entry("u", "gamma")


def test_conversions_at_their_edges():
    w = torch.tensor([0, 0xFF, 0x100, 0xFFFFFFFF], dtype=torch.int64)
    u = uniform_from_words(w)
    assert u.tolist() == [0.0, 0.0, 2.0 ** -24, 1.0 - 2.0 ** -24]
    assert u.dtype == torch.float32 and float(u.max()) < 1.0
    # x = wa·2^32 + wb: 0, 2^64 - 1, 2^63, 2^64 - 2^32
    wa = torch.tensor([0, M32, 0x80000000, M32], dtype=torch.int64)
    wb = torch.tensor([0, M32, 0, 0], dtype=torch.int64)
    for n in (1, 6, 2 ** 31 + 1, 2 ** 32 - 1):
        idx = index_from_words(wa, wb, n, lo=-4).tolist()
        want = [-4 + ((int(a) << 32 | int(b)) * n >> 64)
                for a, b in zip(wa, wb)]
        assert idx == want
        assert idx[0] == -4 and idx[1] == -4 + n - 1
    # the normals' tail cap: the smallest u1 is 2^-25
    zc, zs = box_muller(torch.tensor([0, 0xFFFFFF]), torch.tensor([0, 0]))
    assert float(zc[0]) == pytest.approx(np.sqrt(50 * np.log(2)), rel=1e-6)
    assert float(zs[0]) == 0.0 and 0.0 <= float(zc[1]) < 1e-3


def test_draws_depend_on_the_chain_alone():
    """A chain's values do not depend on the other chains, the plan's
    other entries or their order; another step or seed changes them."""
    full = draw_plan(_streams(SEEDS, 4), PLAN)
    alone = draw_plan(_streams(SEEDS[1:2], 4),
                      DrawPlan(tuple(reversed(PLAN.entries))))
    for name, v in full.items():
        assert torch.equal(v[1:2], alone[name]), name
    later = draw_plan(_streams(SEEDS, 5), PLAN)
    assert not torch.equal(full["noise"], later["noise"])
    assert not torch.equal(full["noise"][0], full["noise"][1])


@pytest.mark.parametrize("entries,n_chains", [
    ((entry("u", "uniform", 2 ** 31),), 1),         # 2^31 floats a chain
    ((entry("cidx", "index", 2 ** 31, n=7),), 1),   # 2^31 ints a chain
    ((entry("noise", "normal", 4 * 2 ** 25),), 64),  # 2^31 calls a launch
])
def test_plans_past_the_kernel_limits_are_refused(entries, n_chains):
    """A plan whose chain holds 2^31 values of a type, or whose launch
    makes 2^31 calls, is refused before anything is drawn, on either
    device: the kernel indexes a chain's columns and a launch's calls in
    int32."""
    s = _streams(list(range(n_chains)))
    with pytest.raises(ValueError, match="the kernel takes at most"):
        chain_draws(s.keys, s.step, DrawPlan(entries))


def test_dispatchers_run_the_plain_versions_on_the_cpu():
    s = _streams(SEEDS, 3)
    before = (chain_draws.launches, batched_normal_keyed.launches)
    fo, io = chain_draws(s.keys, s.step, PLAN)
    fr, ir = chain_draws_reference(s.keys, s.step, PLAN)
    assert torch.equal(fo, fr) and torch.equal(io, ir)
    z = batched_normal_keyed(s.keys, s.step, SPECTRUM, 6, 5)
    assert torch.equal(z, batched_normal_keyed_reference(s.keys, s.step,
                                                         SPECTRUM, 6, 5))
    assert (chain_draws.launches, batched_normal_keyed.launches) == before
    with pytest.raises(TypeError, match="uint32"):
        chain_draws(s.keys.to(torch.int64), s.step, PLAN)
    with pytest.raises(TypeError, match="int64"):
        batched_normal_keyed(s.keys, s.step.to(torch.int32), SPECTRUM, 6, 5)
    with pytest.raises(ValueError, match="even"):
        batched_normal_keyed(s.keys, s.step, SPECTRUM, 5, 5)


def test_keyed_noise_layout_and_independence():
    """Pair q of chain c: call q // 2 at (step, slot), words (0, 1) or
    (2, 3); cos into row-half 0 at q, sin into half 1; chain c's normals
    are those of its own key."""
    s = _streams(SEEDS, 8)
    # 15 pairs
    z = batched_normal_keyed_reference(s.keys, s.step, SPECTRUM, 6, 5)
    words = keyed_words(s.keys, s.step, SPECTRUM, 8)
    for c, q in ((0, 0), (1, 5), (2, 14)):
        i = 0 if q % 2 == 0 else 2
        zc, zs = box_muller(words[i][c, q // 2], words[i + 1][c, q // 2])
        flat = z[c].reshape(-1)
        assert flat[q] == zc and flat[15 + q] == zs
    alone = batched_normal_keyed_reference(_streams([SEEDS[2]], 8).keys,
                                           s.step, SPECTRUM, 6, 5)
    assert torch.equal(alone[0], z[2])


def test_resolve_seed_takes_lists():
    assert resolve_seed(7) == 7
    assert isinstance(resolve_seed(None), int)
    assert resolve_seed([1, 2, 3]) == (1, 2, 3)
    assert resolve_seed(np.array([4, 5, 6]), n_chains=2) == (4, 5)
    with pytest.raises(ValueError, match="n_chains"):
        resolve_seed([1, 2], n_chains=3)
    with pytest.raises(TypeError, match="int"):
        resolve_seed([1, 2.5])
    with pytest.raises(TypeError, match="int"):
        resolve_seed(True)


def sgs_chain(p):
    """The spherical SGS chain with 16 neighbours (the plain given-Sigma
    CG stays quick on the CPU)."""
    chain = small_sgs_chain(p, vario=("Spherical", 6e3, 1.0, 0.0, None))
    chain.set_sgs_param(16, 10e3)
    return chain


FAMILIES = {"crf": small_chain, "sgs": sgs_chain}


@pytest.fixture(scope="module")
def problem():
    return make_synthetic_problem(H=64, W=64)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_takes_a_seed_list(problem, family):
    sampler = MultiChainSampler(FAMILIES[family](problem), 3, device="cpu")
    sampler.init(seeds=[9, 8, 7, 6])
    assert isinstance(sampler.generator, PerChainStreams)
    np.testing.assert_array_equal(sampler.generator.keys.numpy(),
                                  chain_keys([9, 8, 7]))
    assert sampler.rng_kind() == PER_CHAIN_KIND
    with pytest.raises(ValueError, match="n_chains"):
        sampler.init(seeds=[1, 2])
    # a chain's own seed list, as set_random_generator keeps it
    chain = FAMILIES[family](problem)
    chain.set_random_generator([4, 5, 6])
    sampler = MultiChainSampler(chain, 3, device="cpu")
    sampler.init()
    np.testing.assert_array_equal(sampler.generator.keys.numpy(),
                                  chain_keys([4, 5, 6]))


def _step_draws(family, static, consts, streams, n):
    if family == "crf":
        d = crf.draw(streams, static, consts, n)
        return {f: getattr(d, f) for f in ("noise", "size_idx", "scale",
                                             "range_x", "range_y", "cidx",
                                             "u")}
    d = sgs.draw(streams, static, consts, n)
    return {f: getattr(d, f) for f in ("cx", "cy", "bsx", "bsy", "noise",
                                         "u")}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chain_i_depends_on_its_own_seed_alone(problem, family):
    """Chain i of a 3-chain list-seeded farm against the 1-chain farm
    seeded ``[SEEDS[i]]``: each step's draws bitwise; the traces' steps and
    blocks equal, losses and probes to rtol 1e-6 (the CPU's batched
    irfft2, module docstring)."""
    chain = FAMILIES[family](problem)
    static, consts = chain.build("cpu")
    farm = PerChainStreams.from_seeds(SEEDS, "cpu")
    ones = [PerChainStreams.from_seeds([s], "cpu") for s in SEEDS]
    for _ in range(3):
        d3 = _step_draws(family, static, consts, farm, 3)
        for i, one in enumerate(ones):
            d1 = _step_draws(family, static, consts, one, 1)
            for k in d3:
                assert torch.equal(d3[k][i], d1[k][0]), (i, k)
            one.advance()
        farm.advance()

    n_iter = 9
    sampler = MultiChainSampler(chain, 3, device="cpu")
    _, tr3 = sampler.run(sampler.init(seeds=SEEDS), n_iter, progress=False)
    for i, seed in enumerate(SEEDS):
        one = MultiChainSampler(FAMILIES[family](problem), 1, device="cpu")
        _, tr1 = one.run(one.init(seeds=[seed]), n_iter, progress=False)
        for k in ("step", "block"):
            np.testing.assert_array_equal(tr3[k][i], tr1[k][0], err_msg=k)
        for k in ("loss_mc", "loss", "samples"):
            np.testing.assert_allclose(tr3[k][i], tr1[k][0], rtol=1e-6,
                                       err_msg=k)
    assert not np.array_equal(tr3["block"][0], tr3["block"][1])


@pytest.mark.parametrize("hw", [(36, 36), (45, 67), (70, 130)])
def test_masked_square_sums_are_batch_invariant(hw):
    """``masked_sq_sum`` of a batch of 3 against each chain alone,
    bitwise: each row summed in an order set by its length alone
    (``ops/physics.row_sum``), rows past 63 cells folded by 32 first.  On
    the card a one-pass ``sum`` over both axes orders a batch of 512 and a
    batch of 1 differently (chip_smoke.py's [independence]); here the
    batch-3 / batch-1 pair and the fold hold the form.  The SGS stage
    probe names the first stage where two batches' chain 0 differ."""
    from mcmc_tpu_torch.ops.physics import masked_sq_sum, row_sum
    from mcmc_tpu_torch.testing import first_batch_dependence

    gen = torch.Generator().manual_seed(hw[0])
    res = torch.randn((3,) + hw, generator=gen) * 50.0
    res[0, 0, 0] = float("nan")  # a NaN residual counts zero
    mask = torch.rand((3,) + hw, generator=gen) < 0.4
    many = masked_sq_sum(res, mask)
    for i in range(3):
        one = masked_sq_sum(res[i:i + 1], mask[i:i + 1])
        assert torch.equal(many[i:i + 1], one), i
    want = torch.where(mask & ~torch.isnan(res), res.double() ** 2,
                       0.0).sum(dim=(-2, -1))
    torch.testing.assert_close(many.double(), want, rtol=1e-6, atol=0.0)
    x = torch.arange(130, dtype=torch.float32).expand(2, 130)
    assert torch.equal(row_sum(x), torch.full((2,), 8385.0))
    stages = {"a": many, "b": many + 1.0}
    assert first_batch_dependence(stages, stages) is None
    assert first_batch_dependence(
        stages, {"a": many, "b": many + 2.0}) == "b"


def test_sgs_step_stages_follow_the_step(problem):
    """The SGS stage probe (``testing.sgs_step_stages``) takes the step
    apart without writing the state: its K-nearest selection is
    ``k_nearest_packed``'s, and its decision, loss and written windows
    those of the step it mirrors, bitwise, on a 3-chain list-seeded farm
    of the CPU."""
    from mcmc_tpu_torch.testing import sgs_step_stages

    static, consts = FAMILIES["sgs"](problem).build("cpu")
    sampler = MultiChainSampler(FAMILIES["sgs"](problem), 3, device="cpu")
    state = sampler.init(seeds=SEEDS)
    for _ in range(3):
        d = sgs.draw(sampler.generator, static, consts, 3)
        before = state.fields.clone()
        st = sgs_step_stages(static, consts, state, d)
        assert torch.equal(state.fields, before)
        state, tr = sgs.make_sgs_kernel(static)(
            consts, state, d.cx, d.cy, d.bsx, d.bsy, d.noise, d.drop_u, d.u)
        assert torch.equal(st["loss, decision"][:, 0], state.loss_mc)
        assert torch.equal(st["loss, decision"][:, 2],
                           tr["step"].to(torch.float32))
        written = st["loss, decision"][:, 3] > 0
        geo = sgs.window_start(static, d.cx, d.cy, d.bsx, d.bsy)
        after = sgs.window_extract_reference(
            consts.stacked, state.fields, geo.sx32, geo.sy32, static.SB)
        new_w = st["new window (residual patch)"]
        assert torch.equal(after[written, sgs.N_CONST:],
                           new_w[written])
        K = static.K
        assert torch.equal(st["packed idx, sel"][:, :K],
                           torch.clamp(st["searchsorted"],
                                       max=static.SB ** 2 - 1))
        sampler.generator.advance()
    assert int(state.accepted.sum()) > 0


def test_crf_block_params_come_from_the_plan(problem):
    """A list-seeded CRF step's size index and variogram parameters are
    its draw plan's values, mapped as a generator's uniforms are
    (``field_params``); chain 1 of three equals chain 0 of its own
    farm."""
    chain = small_chain(problem, nugget_max=25.0)
    static, consts = chain.build("cpu")
    arrays = consts.rf
    views = draw_plan(_streams(SEEDS, 2),
                      DrawPlan(randfield.block_param_entries(static.rf)))
    d3 = crf.draw(_streams(SEEDS, 2), static, consts, 3)
    d1 = crf.draw(_streams(SEEDS[1:2], 2), static, consts, 1)
    assert torch.equal(d3.size_idx, views["size_idx"][:, 0])

    def on(name, lo, hi):
        return lo + (hi - lo) * views[name][:, 0]

    assert torch.equal(d3.scale, on("scale", arrays.scale_min,
                                    arrays.scale_max) / 3.0)
    assert torch.equal(d3.nug, on("nugget", 0.0, arrays.nugget_max))
    assert torch.equal(d3.range_x, on("range_x", arrays.range_min_x,
                                      arrays.range_max_x))
    for f in ("size_idx", "scale", "nug", "range_x", "range_y"):
        assert torch.equal(getattr(d3, f)[1], getattr(d1, f)[0]), f
    # a generator's uniforms, in the order field_params asks for them
    gen = make_generator(4, "cpu")
    got = sample_field_params(
        gen, arrays.scale_min, arrays.scale_max, arrays.nugget_max,
        arrays.range_min_x, arrays.range_max_x, arrays.range_min_y,
        arrays.range_max_y, False, n=3, device="cpu")
    gen = make_generator(4, "cpu")
    u = {k: torch.rand((3,), generator=gen)
         for k in ("scale", "nugget", "range_x", "range_y")}
    want = field_params(u.__getitem__, arrays.scale_min, arrays.scale_max,
                        arrays.nugget_max, arrays.range_min_x,
                        arrays.range_max_x, arrays.range_min_y,
                        arrays.range_max_y, False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_list_seeded_resume_is_bitwise(problem, tmp_path, family):
    def run(n_iter, directory):
        sampler = MultiChainSampler(FAMILIES[family](problem), 3,
                                    device="cpu")
        return run_with_checkpointing(sampler, n_iter, directory,
                                      seeds=SEEDS, segment_size=4)

    run(6, tmp_path / "resumed")
    sr, hr, cr = run(12, tmp_path / "resumed")
    ss, hs, cs = run(12, tmp_path / "straight")
    assert cr == cs == 12
    for k in hs:
        np.testing.assert_array_equal(hr[k], hs[k], err_msg=k)
    for name in ("fields", "loss_mc", "loss_comp", "accepted"):
        assert torch.equal(getattr(sr, name), getattr(ss, name)), name


@pytest.mark.parametrize("written,resumed", [("list", "int"),
                                             ("int", "list")])
def test_stream_kinds_are_refused_across_seedings(problem, tmp_path,
                                                  written, resumed):
    seeds = {"list": SEEDS, "int": 5}

    def sampler():
        return MultiChainSampler(small_chain(problem), 3, device="cpu")

    run_with_checkpointing(sampler(), 4, tmp_path, seeds=seeds[written],
                           segment_size=4)
    with pytest.raises(ValueError, match="stream"):
        run_with_checkpointing(sampler(), 8, tmp_path,
                               seeds=seeds[resumed], segment_size=4)
    s = sampler()
    s.init(seeds=seeds[resumed])
    other = sampler()
    other.init(seeds=seeds[written])
    with pytest.raises(ValueError, match="kind"):
        s.restore_generator(*other.generator_state())


def test_per_chain_state_roundtrip():
    s = _streams(SEEDS, (2 << 32) + 9)
    kind, state = generator_state(s)
    assert kind == PER_CHAIN_KIND and state.dtype == np.uint8
    assert state.size == 8 + 8 * len(SEEDS)
    back = restore_generator(kind, state, "cpu", want=PER_CHAIN_KIND)
    assert torch.equal(back.keys, s.keys) and torch.equal(back.step, s.step)
    with pytest.raises(ValueError, match="kind"):
        restore_generator(kind, state, "cpu")
    sampler = MultiChainSampler(small_chain(make_synthetic_problem(
        H=48, W=48)), 2, device="cpu")
    with pytest.raises(ValueError, match="3 per-chain"):
        sampler.restore_generator(kind, state, seeds=[1, 2])


def _result_format(results):
    return [[(np.asarray(x).shape, np.asarray(x).dtype) for x in r]
            for r in results]


def test_large_scale_farm_with_a_seed_list_matches_jax(problem, tmp_path):
    """Both packages' ``large_scale_chain_farm(rng_seeds=[1, 2, 3])`` on
    the same config: per-chain result tuples of the same shapes and
    dtypes, finite, the chains exploring differently."""
    from mcmc_tpu import drivers as jdrivers
    from tests.test_torch_chain_crf import _jax_chain, _port_chain

    jchain = _jax_chain(problem, "crf_matern")
    kw = dict(n_chains=3, rng_seeds=[1, 2, 3], n_iter=6, segment_size=3,
              progress=False, quiet=True)
    want = jdrivers.large_scale_chain_farm(jchain,
                                           output_path=tmp_path / "jax", **kw)
    got = drivers.large_scale_chain_farm(_port_chain(problem, jchain),
                                         output_path=tmp_path / "port",
                                         device="cpu", **kw)
    assert _result_format(got) == _result_format(want)
    assert all(np.isfinite(r[3]).all() for r in got)
    assert not np.array_equal(got[0][6], got[1][6])
    # the port's chain 2 is the 1-chain farm seeded [3]
    one = drivers.large_scale_chain_farm(
        _port_chain(problem, jchain), n_chains=1, rng_seeds=[3], n_iter=6,
        segment_size=3, progress=False, quiet=True,
        output_path=tmp_path / "one", device="cpu")
    np.testing.assert_array_equal(got[2][6], one[0][6])


def test_cli_with_a_seed_list_matches_jax(tmp_path):
    """``"rng_seeds": [5, 6]`` through both packages' CLIs: the same
    result tuples' shapes and dtypes, and the same saved files."""
    from mcmc_tpu import cli as jcli

    cfg = _crf_config(n_iter=6, segment=3)
    cfg["farm"]["rng_seeds"] = [5, 6]
    outs = {}
    for name, run in (("jax", lambda c, d: jcli.run(c, config_dir=d,
                                                     quiet=True)),
                      ("port", lambda c, d: cli.run(c, config_dir=d,
                                                    quiet=True,
                                                    device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        _write_dataset(d)
        (d / "exp.json").write_text(json.dumps(cfg))
        results = run(cli.load_config(d / "exp.json"), d)
        with np.load(d / "hist.npz") as h:
            hist = {k: (h[k].shape, h[k].dtype) for k in h.files}
        beds = np.load(d / "beds.npy")
        outs[name] = (_result_format(results), hist, beds.shape, beds.dtype)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1]["loss"][0] == (2, 6)
