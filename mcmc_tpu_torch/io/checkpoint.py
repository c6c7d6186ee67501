"""Checkpoint / resume for chain farms on one device.

PyTorch counterpart of ``mcmc_tpu/io/checkpoint.py`` in its single-process
layout (the reference: largeScaleChain_multiprocessing.py:100-240): the
per-run artifacts ``bed_{N}k.npy`` + ``results_{N}k.npz`` +
``current_iter.txt`` + two RNG-state JSON files become ONE atomic
``checkpoint_{N}.npz`` holding the full batched chain state (beds, patched
residuals, Kahan loss accumulators, resample counters) and the sampler's
stream state with its kind (``utils/rng.generator_state``: a generator's
state, or a seed-listed farm's per-chain keys and step counter), so a
resumed farm continues the exact random stream.  Trace histories are
written once per row, as incremental ``hist_{a}_{b}.npz`` segments.

Write protocol as the reference's: new files are written (atomically via
tmp + fsync + rename) before superseded ones are deleted (:233-236).

Async writes (``CheckpointManager(..., async_write=True)``): the state is
copied to host memory synchronously (the sampler updates its fields in
place), then the atomic write, publication and the cleanup run on
one background worker thread, so the next segment overlaps the
IO.  Writes publish in submission order; readers flush the queue first;
``flush()`` re-raises the first write failure, and a failed write poisons
the queued writes behind it.

What a load refuses: a checkpoint of the other chain family or grid
(``run_with_checkpointing``), and one whose stream kind differs from the
loading sampler's (an int-seeded farm's generator on another device, or
per-chain streams where the sampler is int-seeded, and the other way
round), or that has none (a JAX package checkpoint, whose RNG state is a
per-chain JAX key), with that reason.

Multi-rank layout (a farm sharded over ``torch.distributed`` ranks,
``parallel/sampler.py``), as the JAX package's multi-process one: each
rank writes ``checkpoint_{N}.proc{k}of{P}.npz`` with its own chains'
state, the rows they hold and its stream's state (an int-seeded farm's
generator, alike on every rank, or its chains' per-chain keys and the
step); after a barrier, rank 0 publishes the empty ``checkpoint_{N}.ok``
marker.  A set is visible only with its marker and every file, so a
crash mid-save never yields a half-readable checkpoint; a re-save at the
same iteration retracts the old set first, marker first.  ``load``
reassembles the whole batch from a single file or from any complete set
(``utils/rng.join_stream_states``) and hands a rank its rows, so a
checkpoint written at one rank count resumes at another.  Trace
histories, which every rank holds alike, are written and pruned by rank
0.  Sharded saves are synchronous: their barriers sit at the same point
of every rank's program.  A filesystem that every rank sees is assumed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

import torch.distributed as dist

from ..models.chain_crf import ChainState
from ..models.chain_sgs import SGSState
from ..parallel.distributed import world
from ..utils.rng import generator_kind, join_stream_states, resolve_device

_CKPT_RE = re.compile(r"checkpoint_(\d+)\.npz$")
_HIST_RE = re.compile(r"hist_(\d+)_(\d+)\.npz$")
_SHARD_RE = re.compile(r"checkpoint_(\d+)\.proc(\d+)of(\d+)\.npz$")
_MARKER_RE = re.compile(r"checkpoint_(\d+)\.ok$")
_STATE_CLASSES = {"ChainState": ChainState, "SGSState": SGSState}


def _atomic_npz(directory: Path, target: Path, payload: dict):
    """Write ``payload`` as an npz at ``target`` atomically: tmp file in
    the same directory, fsync, rename (the published name never holds
    partial data, even across a crash).  Uncompressed, unlike the JAX
    package's: float32 state planes barely compress, and zlib's tens of
    MB/s would spend a minute on each save of a 2 GB farm state."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _state_to_arrays(states) -> dict:
    """Host copies of every state tensor (copies: the sampler keeps
    updating its fields in place)."""
    return {f.name: getattr(states, f.name).detach().cpu().numpy().copy()
            for f in dataclasses.fields(type(states))}


def _arrays_to_state(d: dict, cls_name: str, device):
    cls = _STATE_CLASSES[cls_name]
    return cls(**{k: torch.from_numpy(np.asarray(v)).to(device)
                  for k, v in d.items()})


class CheckpointManager:
    """Single-directory checkpoint store with resume (module docstring).

    ``keep``: how many of the newest checkpoints survive a save.
    ``async_write``: write on one background thread.
    """

    def __init__(self, directory, keep: int = 1, async_write: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = int(keep)
        self.async_write = bool(async_write)
        self._executor = None
        self._pending = []
        # once a queued write fails, later queued writes are skipped until
        # flush() surfaces the failure: a failed history segment followed
        # by a published state save would leave a silent hole in resumed
        # histories
        self._write_failed = None

    # -- async write machinery ----------------------------------------------

    def _submit(self, fn):
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mcmc_tpu_torch-ckpt")
        # a write that already failed surfaces at the next submit, not
        # only at the end of the run
        if any(f.done() and f.exception() is not None
               for f in self._pending):
            self.flush()
        self._pending = [f for f in self._pending if not f.done()]

        def _guarded():
            if self._write_failed is not None:
                return
            try:
                fn()
            except BaseException as e:
                self._write_failed = e
                raise

        # backpressure: one write in flight and one queued; each pins a
        # host snapshot of the state, so a slow disk must block the
        # sampler rather than grow the queue
        while len(self._pending) >= 2:
            if self._pending[0].exception() is not None:  # waits for it
                self.flush()
            else:
                self._pending.pop(0)
        self._pending.append(self._executor.submit(_guarded))

    def flush(self):
        """Block until queued writes are durable; re-raise the first
        failure.  The manager stays usable afterwards."""
        pending, self._pending = self._pending, []
        err = None
        for f in pending:
            try:
                f.result()
            except Exception as e:
                if err is None:
                    err = e
        self._write_failed = None
        if err is not None:
            raise err

    def close(self):
        """Flush, then stop the writer thread."""
        try:
            self.flush()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    # -- discovery ----------------------------------------------------------

    def _checkpoints(self):
        """Sorted [(iter, layout, paths)] of the COMPLETE checkpoints:
        single files, and sharded sets with their ``.ok`` marker and every
        shard file (a set beats a same-iteration single file; of two sets,
        the current rank count's, then the larger)."""
        singles, shards, markers = {}, {}, set()
        for p in self.dir.iterdir():
            if m := _CKPT_RE.search(p.name):
                singles[int(m.group(1))] = p
            elif m := _SHARD_RE.search(p.name):
                it, k, nproc = (int(g) for g in m.groups())
                shards.setdefault(it, {}).setdefault(nproc, {})[k] = p
            elif m := _MARKER_RE.search(p.name):
                markers.add(int(m.group(1)))
        out = {it: ("single", [p]) for it, p in singles.items()}
        size = world()[1]
        for it in markers:
            layouts = shards.get(it, {})
            for nproc in sorted(layouts, key=lambda n: (n != size, -n)):
                files = layouts[nproc]
                if len(files) == nproc:
                    out[it] = ("sharded", [files[k] for k in sorted(files)])
                    break
        return sorted((it, kind, paths) for it, (kind, paths) in out.items())

    def latest_iter(self) -> Optional[int]:
        """Cumulative iteration of the newest checkpoint, or None."""
        self.flush()
        cps = self._checkpoints()
        return cps[-1][0] if cps else None

    def manifest(self) -> dict:
        """The run directory without loading any state::

            {"checkpoints": [{"iter", "layout", "files", "bytes",
                              "mtime"}, ...],          # oldest -> newest
             "history_spans": [(start_row, end_row), ...]}

        Only complete checkpoints are listed (``_checkpoints``)."""
        self.flush()
        cps = [{"iter": it, "layout": kind, "files": [p.name for p in paths],
                "bytes": sum(p.stat().st_size for p in paths),
                "mtime": max(p.stat().st_mtime for p in paths)}
               for it, kind, paths in self._checkpoints()]
        spans = []
        for p in self.dir.iterdir():
            m = _HIST_RE.search(p.name)
            if m:
                spans.append((int(m.group(1)), int(m.group(2))))
        return {"checkpoints": cps, "history_spans": sorted(spans)}

    def _delete_iter_files(self, it: int, keep_nproc: Optional[int] = None):
        """Remove checkpoint ``it``'s files, the marker first so that a
        reader never sees a complete-looking set go partial; with
        ``keep_nproc``, the shard files of that rank count stay."""
        (self.dir / f"checkpoint_{it}.ok").unlink(missing_ok=True)
        for p in list(self.dir.iterdir()):
            m = _CKPT_RE.search(p.name)
            if m is None:
                m = _SHARD_RE.search(p.name)
                if m is not None and int(m.group(3)) == keep_nproc:
                    continue
            if m and int(m.group(1)) == it:
                p.unlink(missing_ok=True)

    # -- save / load --------------------------------------------------------

    def save(self, cumulative_iter: int, states, generator_state,
             histories: Optional[dict] = None, meta: Optional[dict] = None,
             *, sharded: Optional[bool] = None, rows=None):
        """Write ``checkpoint_{cumulative_iter}.npz``: the state, the
        generator state ``(kind, uint8 array)``, optional inline
        histories and meta.  ``sharded`` (default: whether the run has
        more than one rank) writes the multi-rank layout instead, every
        rank calling with its own chains (module docstring); ``rows``
        (lo, n_total) places them in the farm's batch (default: rank k
        holds the k-th equal block).  Returns the target path; in async
        mode it exists (or the failure raises) only after ``flush()``."""
        kind, rng_state = generator_state
        payload = {f"state_{k}": v
                   for k, v in _state_to_arrays(states).items()}
        payload["rng_state"] = np.asarray(rng_state, np.uint8)
        for k, v in (histories or {}).items():
            payload[f"hist_{k}"] = np.asarray(v)
        it = int(cumulative_iter)
        rank, size = world()
        if sharded is None:
            sharded = size > 1
        n = payload["state_fields"].shape[0]
        lo, n_total = (rank * n, size * n) if rows is None else rows
        if not sharded and (lo, n_total) != (0, n):
            raise ValueError(f"a single-file checkpoint holds the whole "
                             f"batch; these are chains [{lo}, {lo + n}) of "
                             f"{n_total}")
        payload["meta_json"] = np.frombuffer(json.dumps({
            "cumulative_iter": it, "state_class": type(states).__name__,
            "rng_kind": kind, "rows": [int(lo), int(lo) + n],
            "n_chains": int(n_total), **(meta or {})}).encode(),
            dtype=np.uint8)
        if sharded:
            self.flush()  # queued single-file writes land first
            return self._save_sharded(it, payload, rank, size)
        target = self.dir / f"checkpoint_{it}.npz"

        def _write():
            old = self._checkpoints()
            # a same-iteration set goes before the new file is visible: a
            # set beats a single file in discovery
            self._delete_iter_files(it)
            _atomic_npz(self.dir, target, payload)
            # superseded checkpoints go only once the new one is durable
            for old_it, _, _ in old[: max(0, len(old) - (self.keep - 1))]:
                if old_it != it:
                    self._delete_iter_files(old_it)

        if self.async_write:
            self._submit(_write)
        else:
            _write()
        return target

    def _save_sharded(self, it: int, payload: dict, rank: int, size: int):
        """Rank ``rank``'s file of the set, between barriers: rank 0
        retracts any older same-iteration checkpoint (marker first), every
        rank writes its file, rank 0 publishes the marker, then deletes
        the superseded checkpoints."""
        old = self._checkpoints()
        if rank == 0:
            self._delete_iter_files(it, keep_nproc=size)
        dist.barrier()
        target = _atomic_npz(
            self.dir, self.dir / f"checkpoint_{it}.proc{rank}of{size}.npz",
            payload)
        dist.barrier()  # every file durable before the marker
        if rank == 0:
            marker_tmp = self.dir / f".ok_{it}.tmp"
            marker_tmp.touch()
            os.replace(marker_tmp, self.dir / f"checkpoint_{it}.ok")
            for old_it, _, _ in old[: max(0, len(old) - (self.keep - 1))]:
                if old_it != it:
                    self._delete_iter_files(old_it)
        dist.barrier()  # the set is visible to every rank on return
        return target

    def append_history(self, start_row: int, end_row: int, rows: dict):
        """Write one incremental ``hist_{a}_{b}.npz`` trace segment (the
        reference's concat-with-previous results protocol without
        rewriting the full history each save)."""
        if end_row <= start_row or world()[0] != 0:
            return None  # every rank holds the same rows: rank 0 writes
        rows_np = {k: np.asarray(v) for k, v in rows.items()}
        target = self.dir / f"hist_{int(start_row)}_{int(end_row)}.npz"

        def _write():
            _atomic_npz(self.dir, target, rows_np)

        if self.async_write:
            self._submit(_write)
        else:
            _write()
        return target

    def prune_history(self, from_row: int):
        """Delete history segments starting at or after ``from_row``.
        Called on resume: a crash between a history append and its state
        save leaves a stale segment ahead of the checkpoint, which the
        resumed run records again.  Rank 0's job, as the writes are."""
        self.flush()
        if world()[0] != 0:
            return
        for p in list(self.dir.iterdir()):
            m = _HIST_RE.search(p.name)
            if m and int(m.group(1)) >= int(from_row):
                p.unlink(missing_ok=True)

    def load_history(self, upto: Optional[int] = None) -> dict:
        """The history segments concatenated (chain-major, axis 1),
        truncated to ``upto`` rows."""
        self.flush()
        segs = []
        for p in self.dir.iterdir():
            m = _HIST_RE.search(p.name)
            if m:
                segs.append((int(m.group(1)), int(m.group(2)), p))
        parts = []
        for start, _end, p in sorted(segs):
            if upto is not None and start >= upto:
                continue
            with np.load(p) as z:
                parts.append({k: z[k] for k in z.files})
        if not parts:
            return {}
        out = {k: np.concatenate([s[k] for s in parts], axis=1)
               for k in parts[0]}
        if upto is not None:
            out = {k: v[:, :upto] for k, v in out.items()}
        return out

    @staticmethod
    def _read(paths):
        """(state arrays, rng state, meta) of a single file, or of a
        sharded set reassembled in row order (a block that several ranks
        hold alike is read once)."""
        parts = []
        for path in paths:
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta_json"]).decode())
                parts.append((meta, {k[len("state_"):]: z[k]
                                     for k in z.files
                                     if k.startswith("state_")},
                              z["rng_state"] if "rng_state" in z.files
                              else None, path))
        parts.sort(key=lambda part: tuple(part[0].get("rows", (0, 0))))
        blocks, end = [], 0
        for part in parts:
            lo, hi = part[0].get("rows", (0, None))
            if blocks and lo == blocks[-1][0]["rows"][0]:
                continue  # the same block from another rank
            if lo != end:
                raise ValueError(f"{part[3].name} holds chains from {lo}, "
                                 f"the set's files before it end at {end}")
            blocks.append(part)
            end = hi
        meta = blocks[0][0]
        total = meta.get("n_chains")
        if total is not None and end != total:
            raise ValueError(f"the files hold chains [0, {end}) of {total}")
        arrays = {k: np.concatenate([b[1][k] for b in blocks])
                  for k in blocks[0][1]}
        states = [b[2] for b in blocks]
        rng_state = (None if any(st is None for st in states) else
                     join_stream_states(meta.get("rng_kind"), states))
        return arrays, rng_state, dict(meta)

    def load(self, cumulative_iter: Optional[int] = None, device=None,
             rng_kind: Optional[str] = None, rows=None):
        """``(cumulative_iter, states, histories, meta)`` of the newest (or
        the named) checkpoint, single file or sharded set alike, with the
        state on ``device`` (the card unless the caller asks for the CPU,
        ``utils/rng.resolve_device``), or None when there is none.
        ``rows`` (lo, hi) keeps those chains of the batch (a rank's);
        ``meta["n_chains"]`` is the whole batch's count.
        ``meta["rng_kind"]`` and ``meta["rng_state"]`` hold the whole
        farm's stream state; a checkpoint without one, or of another kind
        than ``rng_kind`` (default: ``device``'s generator kind, that of
        an int-seeded sampler), raises."""
        self.flush()
        cps = self._checkpoints()
        if not cps:
            return None
        if cumulative_iter is None:
            _, _, paths = cps[-1]
        else:
            match = [p for it, _, p in cps if it == int(cumulative_iter)]
            if not match:
                raise FileNotFoundError(
                    f"no checkpoint at iter {cumulative_iter} in {self.dir}")
            paths = match[0]
        name = paths[0].name
        arrays, rng_state, meta = self._read(paths)
        with np.load(paths[0]) as z:
            histories = {k[len("hist_"):]: z[k] for k in z.files
                         if k.startswith("hist_")}
        kind = meta.get("rng_kind")
        if kind is None or rng_state is None:
            raise ValueError(
                f"{name} holds no generator state (a JAX package "
                "checkpoint keeps its RNG state as per-chain keys, which "
                "no torch generator can continue): it cannot be resumed "
                "here; start a fresh run directory")
        device = resolve_device(device)
        want = generator_kind(device) if rng_kind is None else rng_kind
        if kind != want:
            raise ValueError(
                f"{name} holds a {kind!r} stream state, but the "
                f"sampler on {device} owns a {want!r} stream: resume it "
                "with the seeding it was written with (an int master seed "
                "on the device it was written on, or a per-chain seed "
                "list)")
        meta["n_chains"] = arrays["fields"].shape[0]
        meta.pop("rows", None)
        if rows is not None:
            lo, hi = rows
            if not 0 <= lo <= hi <= meta["n_chains"]:
                raise ValueError(f"chains [{lo}, {hi}) of a checkpoint "
                                 f"holding {meta['n_chains']}")
            arrays = {k: v[lo:hi] for k, v in arrays.items()}
        states = _arrays_to_state(arrays, meta.pop("state_class"), device)
        cum = meta.pop("cumulative_iter")
        meta["rng_state"] = rng_state
        if not histories:
            histories = self.load_history(upto=cum)
        return cum, states, histories, meta


def run_with_checkpointing(sampler, n_iter: int, directory,
                           seeds=None, initial_beds=None,
                           segment_size: int = 2000, progress: bool = False,
                           checkpoint_every: Optional[int] = None,
                           async_checkpoints: bool = False):
    """Segment-batched run with resume (the reference's lsc_run_wrapper
    protocol).

    If ``directory`` holds a checkpoint, the run resumes from it and only
    the remaining iterations execute, the sampler's generator continuing
    the stored stream; the resumed run's duplicated boundary row is
    dropped, so an interrupted and resumed run yields exactly the traces
    of an uninterrupted one.  Returns (states, histories,
    cumulative_iter).  Every write is flushed, and any write failure
    raised, before return.
    """
    mgr = CheckpointManager(directory, async_write=async_checkpoints)
    try:
        out = _run(mgr, sampler, n_iter, seeds, initial_beds, segment_size,
                   progress, checkpoint_every)
    except BaseException:
        # drain the queued writes so recorded rows are durable, but never
        # mask the primary error with a secondary write failure
        try:
            mgr.close()
        except Exception:
            pass
        raise
    mgr.close()
    return out


def _run(mgr, sampler, n_iter, seeds, initial_beds, segment_size, progress,
         checkpoint_every):
    ck = mgr.load(device=sampler.device, rng_kind=sampler.rng_kind(seeds),
                  rows=sampler.rows)
    if ck is not None:
        done, states, histories, meta = ck
        expected_cls = "SGSState" if sampler.is_sgs else "ChainState"
        if type(states).__name__ != expected_cls:
            raise ValueError(
                f"checkpoint holds a {type(states).__name__} but the "
                f"sampler's chain family needs a {expected_cls}: this "
                "directory belongs to a run of the other chain family "
                "(CRF vs SGS). Point the sampler at its own run directory.")
        exp = (int(sampler.static.H), int(sampler.static.W))
        got = tuple(states.bed.shape[-2:])
        if got != exp:
            raise ValueError(
                f"checkpoint state grid {got} != sampler grid {exp}: the "
                "directory belongs to a run on another domain")
        if meta["n_chains"] != sampler.n_chains:
            raise ValueError(
                f"checkpoint holds {meta['n_chains']} chains, the "
                f"sampler runs {sampler.n_chains}")
        # a crash between a history append and its state save leaves a
        # stale segment ahead of the checkpoint
        mgr.prune_history(done)
        sampler.restore_generator(meta["rng_kind"], meta["rng_state"], seeds)
        histories = {k: np.asarray(v) for k, v in histories.items()}
    else:
        done = 0
        states = sampler.init(initial_beds=initial_beds, seeds=seeds)
        histories = {}

    # ``done`` counts trace rows already recorded (row 0 = the initial
    # state, reference n_iter semantics)
    remaining = int(n_iter) - done
    if remaining <= 0:
        return states, histories, done

    checkpoint_every = checkpoint_every or segment_size
    resuming = ck is not None
    box = {"segments": [], "rows": done, "saved_rows": done, "first": True}

    def _flush(states_):
        """Write only the new rows as a history segment, then the
        state-only checkpoint (each row reaches the disk once)."""
        if box["segments"]:
            seg = {k: np.concatenate([s[k] for s in box["segments"]], axis=1)
                   for k in box["segments"][0]}
            mgr.append_history(box["saved_rows"], box["rows"], seg)
            for k, v in seg.items():
                histories[k] = (np.concatenate([histories[k], v], axis=1)
                                if k in histories else v)
            box["segments"] = []
        mgr.save(box["rows"], states_, sampler.generator_state(), meta={
            "grid_hw": [int(sampler.static.H), int(sampler.static.W)]},
            rows=(sampler.rows[0], sampler.n_chains))
        box["saved_rows"] = box["rows"]

    def cb(_local, states_, traces_np):
        seg = {k: np.moveaxis(v, 0, 1) for k, v in traces_np.items()}
        if box["first"]:
            if resuming:  # drop the duplicated boundary row
                seg = {k: v[:, 1:] for k, v in seg.items()}
            box["first"] = False
        box["segments"].append(seg)
        box["rows"] += seg["loss"].shape[1]
        if box["rows"] - box["saved_rows"] >= checkpoint_every:
            _flush(states_)

    run_len = remaining + (1 if resuming else 0)
    states, _ = sampler.run(states, run_len, segment_size=segment_size,
                            progress=progress, segment_callback=cb)
    if box["rows"] > box["saved_rows"]:
        _flush(states)
    mgr.flush()
    return states, histories, done + remaining
