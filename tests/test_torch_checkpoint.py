"""The port's checkpoint / resume (``mcmc_tpu_torch/io/checkpoint.py``), its
share of tests/test_checkpoint.py at 64 x 64 and 4 chains on the CPU.

The JAX package's resume is bitwise because its per-chain keys are part
of the state; the port's because the checkpoint stores the sampler's
generator state beside the chain state.  Every resume check here is
``assert_array_equal``: an interrupted and resumed farm gives exactly the
traces and state of an uninterrupted one.
"""

import json

import numpy as np
import pytest
import torch

from mcmc_tpu_torch import MultiChainSampler
from mcmc_tpu_torch.io import checkpoint as ckpt_mod
from mcmc_tpu_torch.io.checkpoint import (CheckpointManager,
                                          run_with_checkpointing)
from mcmc_tpu_torch.utils.rng import generator_state
from tests.conftest import make_synthetic_problem
from tests.torch_helpers import small_chain, small_sgs_chain

N = 4
SPHERICAL = ("Spherical", 6e3, 1.0, 0.0, None)


@pytest.fixture(scope="module")
def problem():
    return make_synthetic_problem(H=64, W=64)


def crf_chain(p):
    return small_chain(p)


def sgs_chain(p):
    """The spherical SGS chain (the given-Sigma CG), with 16 neighbours
    so the plain CG stays quick on the CPU."""
    chain = small_sgs_chain(p, vario=SPHERICAL)
    chain.set_sgs_param(16, 10e3)
    return chain


FAMILIES = {"crf": crf_chain, "sgs": sgs_chain}


def sampler_of(p, family, n=N):
    return MultiChainSampler(FAMILIES[family](p), n, device="cpu")


def assert_same_run(a, b):
    (sa, ha, ca), (sb, hb, cb) = a, b
    assert ca == cb
    assert set(ha) == set(hb)
    for k in ha:
        np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
    for name in ("fields", "loss_mc", "loss_comp", "accepted"):
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name


@pytest.mark.parametrize("async_checkpoints", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_resume_is_bitwise_an_uninterrupted_run(problem, tmp_path, family,
                                                async_checkpoints):
    kw = dict(seeds=3, segment_size=5, async_checkpoints=async_checkpoints)
    straight = run_with_checkpointing(sampler_of(problem, family), 18,
                                      tmp_path / "straight", **kw)
    run_with_checkpointing(sampler_of(problem, family), 11,
                           tmp_path / "resumed", **kw)
    resumed = run_with_checkpointing(sampler_of(problem, family), 18,
                                     tmp_path / "resumed", **kw)
    assert_same_run(resumed, straight)
    assert straight[1]["loss"].shape == (N, 18)
    # the histories on disk are the returned ones
    loaded = CheckpointManager(tmp_path / "resumed").load(device="cpu")
    assert loaded[0] == 18
    for k, v in resumed[1].items():
        np.testing.assert_array_equal(loaded[2][k], v, err_msg=k)


def test_save_load_roundtrip_carries_the_generator(problem, tmp_path,
                                                   monkeypatch):
    sampler = sampler_of(problem, "crf")
    states = sampler.init(seeds=1)
    states, _ = sampler.run(states, 4, progress=False)
    kind, state = sampler.generator_state()
    assert kind == "cpu-mt19937" and state.dtype == np.uint8
    mgr = CheckpointManager(tmp_path)
    path = mgr.save(4, states, (kind, state), meta={"note": "x"})
    assert path.name == "checkpoint_4.npz" and mgr.latest_iter() == 4
    cum, loaded, hist, meta = mgr.load(device="cpu")
    assert cum == 4 and hist == {} and meta["note"] == "x"
    assert meta["rng_kind"] == kind
    np.testing.assert_array_equal(meta["rng_state"], state)
    for name in ("fields", "loss_mc", "loss_comp", "loss_data",
                 "loss_data_comp", "accepted"):
        assert torch.equal(getattr(loaded, name), getattr(states, name))
    # the restored generator continues the stream
    want = torch.rand(5, generator=sampler.generator)
    sampler.restore_generator(meta["rng_kind"], meta["rng_state"])
    assert torch.equal(torch.rand(5, generator=sampler.generator), want)
    # the saved state is a copy: later in-place steps do not reach it
    states.fields += 1.0
    assert not torch.equal(mgr.load(device="cpu")[1].fields, states.fields)
    # with no device named, the state goes to the card, so without one
    # loading raises rather than landing on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.load()


def test_keep_retains_the_newest_and_writes_atomically(problem, tmp_path,
                                                       monkeypatch):
    sampler = sampler_of(problem, "crf", n=2)
    states = sampler.init(seeds=0)
    gs = sampler.generator_state()
    mgr = CheckpointManager(tmp_path, keep=2)
    for it in (3, 6, 9):
        mgr.save(it, states, gs)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["checkpoint_6.npz", "checkpoint_9.npz"]
    one = CheckpointManager(tmp_path, keep=1)
    one.save(12, states, gs)
    assert [p.name for p in tmp_path.iterdir()] == ["checkpoint_12.npz"]
    with pytest.raises(FileNotFoundError):
        one.load(9)

    # a write that dies mid-file leaves no partial checkpoint and no tmp
    def boom(fh, **payload):
        fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        one.save(15, states, gs)
    monkeypatch.undo()
    assert [p.name for p in tmp_path.iterdir()] == ["checkpoint_12.npz"]


def test_stale_history_segment_is_pruned_on_resume(problem, tmp_path):
    """A crash between a history append and its state save leaves a
    segment ahead of the checkpoint; the resume drops it and the traces
    stay those of an uninterrupted run."""
    kw = dict(seeds=2, segment_size=4)
    straight = run_with_checkpointing(sampler_of(problem, "crf"), 13,
                                      tmp_path / "a", **kw)
    run_with_checkpointing(sampler_of(problem, "crf"), 9, tmp_path / "b",
                           **kw)
    mgr = CheckpointManager(tmp_path / "b")
    stale = mgr.load_history()
    mgr.append_history(9, 12, {k: v[:, :3] for k, v in stale.items()})
    assert (tmp_path / "b" / "hist_9_12.npz").exists()
    resumed = run_with_checkpointing(sampler_of(problem, "crf"), 13,
                                     tmp_path / "b", **kw)
    assert not (tmp_path / "b" / "hist_9_12.npz").exists()
    assert_same_run(resumed, straight)


def test_resume_is_a_no_op_when_complete(problem, tmp_path):
    first = run_with_checkpointing(sampler_of(problem, "crf"), 7, tmp_path,
                                   seeds=1, segment_size=3)
    again = run_with_checkpointing(sampler_of(problem, "crf"), 7, tmp_path,
                                   seeds=99, segment_size=3)
    assert_same_run(again, first)


def _rewrite_meta(path, **changes):
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["meta_json"]).decode())
    for k, v in changes.items():
        if v is None:
            meta.pop(k, None)
        else:
            meta[k] = v
    payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **payload)


@pytest.mark.parametrize("mismatch", ["family", "grid", "generator_kind",
                                      "no_generator"])
def test_mismatched_checkpoints_are_refused(problem, tmp_path, mismatch):
    run_with_checkpointing(sampler_of(problem, "crf"), 4, tmp_path, seeds=0,
                           segment_size=4)
    path = tmp_path / "checkpoint_4.npz"
    if mismatch == "family":
        sampler, match = sampler_of(problem, "sgs"), "family"
    elif mismatch == "grid":
        small = make_synthetic_problem(H=48, W=48)
        sampler, match = sampler_of(small, "crf"), "grid"
    elif mismatch == "generator_kind":
        _rewrite_meta(path, rng_kind="cuda-philox")
        sampler, match = sampler_of(problem, "crf"), "cuda-philox"
    else:  # a JAX package checkpoint: a key, no generator state
        with np.load(path) as z:
            payload = {k: z[k] for k in z.files if k != "rng_state"}
        payload["state_key_data"] = np.zeros((N, 2), np.uint32)
        np.savez(path, **payload)
        _rewrite_meta(path, rng_kind=None)
        sampler, match = sampler_of(problem, "crf"), "no generator state"
    with pytest.raises(ValueError, match=match):
        run_with_checkpointing(sampler, 8, tmp_path, seeds=0, segment_size=4)


def test_manifest_and_history_spans(problem, tmp_path):
    mgr = CheckpointManager(tmp_path)
    assert mgr.manifest() == {"checkpoints": [], "history_spans": []}
    assert mgr.load() is None and mgr.latest_iter() is None
    run_with_checkpointing(sampler_of(problem, "crf", n=2), 10, tmp_path,
                           seeds=0, segment_size=4)
    man = mgr.manifest()
    (c,) = man["checkpoints"]
    assert c["iter"] == 10 and c["layout"] == "single"
    assert c["files"] == ["checkpoint_10.npz"] and c["bytes"] > 0
    assert man["history_spans"] == [(0, 5), (5, 9), (9, 10)]
    assert mgr.load_history(upto=7)["loss"].shape == (2, 7)


def test_async_write_failure_raises_and_poisons_the_queue(problem, tmp_path,
                                                          monkeypatch):
    """A failed history write: the state save queued behind it never
    publishes, flush() raises the failure, and a later submit raises an
    already-finished failure at once."""
    import threading

    sampler = sampler_of(problem, "crf", n=2)
    states = sampler.init(seeds=0)
    gs = generator_state(sampler.generator)
    mgr = CheckpointManager(tmp_path, async_write=True)
    orig = ckpt_mod._atomic_npz
    gate = threading.Event()

    def failing(directory, target, payload):
        if target.name.startswith("hist_"):
            gate.wait(timeout=30)
            raise OSError("history write failed")
        return orig(directory, target, payload)

    monkeypatch.setattr(ckpt_mod, "_atomic_npz", failing)
    mgr.append_history(0, 2, {"loss": np.zeros((2, 2))})
    mgr.save(2, states, gs)             # queued behind the blocked write
    gate.set()
    with pytest.raises(OSError, match="history write failed"):
        mgr.flush()
    assert not (tmp_path / "checkpoint_2.npz").exists()
    mgr.append_history(2, 4, {"loss": np.zeros((2, 2))})
    mgr._pending[0].exception(timeout=30)  # the write has failed by now
    with pytest.raises(OSError, match="history write failed"):
        mgr.save(4, states, gs)
    monkeypatch.setattr(ckpt_mod, "_atomic_npz", orig)
    mgr.save(3, states, gs)
    mgr.close()
    assert mgr.latest_iter() == 3


def test_progress_block_copy(problem, capsys):
    """The port's copy of the reference's per-chain progress block, and
    the sampler drawing it after each segment when ``progress`` and
    ``fancy_progress`` are on (``progress`` alone prints one status line a
    segment, ``test_torch_run_api.py`` holds it against the JAX
    sampler's)."""
    from mcmc_tpu_torch.utils.progress import (MultiChainProgress,
                                               clear_line,
                                               format_chain_line,
                                               move_cursor_to_line)

    move_cursor_to_line(3)
    clear_line()
    assert capsys.readouterr().out == "\033[3;0H\033[2K"
    line = format_chain_line(1, 123456789, 0.5, 10.0, 100, 1.5, 0.25)
    assert line.startswith("Chain 1 (123456):  50%|")
    assert "loss: 1.500e+00 | acc: 0.2500" in line
    r = MultiChainProgress(5, 100, max_lines=2)
    r.update(50, np.ones(5), np.zeros(5))
    out = capsys.readouterr().out
    assert "Running 5 chains | iter 50/100" in out
    assert "... and 3 more chains" in out
    sampler = sampler_of(problem, "crf", n=2)
    sampler.run(sampler.init(seeds=0), 5, segment_size=2, progress=True,
                fancy_progress=True)
    out = capsys.readouterr().out
    assert "Running 2 chains | iter 3/5" in out
    assert "Running 2 chains | iter 5/5" in out and "Chain 1 (" in out
    sampler.run(sampler.init(seeds=0), 5, segment_size=2, progress=True)
    out = capsys.readouterr().out
    assert "\033" not in out and out.startswith("[sampler] iter 3/5 | ")
    sampler.run(sampler.init(seeds=0), 5, segment_size=2, progress=False,
                fancy_progress=True)
    assert capsys.readouterr().out == ""
