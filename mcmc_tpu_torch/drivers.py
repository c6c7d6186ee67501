"""Chain-farm drivers: the reference's orchestration layer on one GPU.

PyTorch counterpart of ``mcmc_tpu/drivers.py``, with workflow parity with
the reference driver scripts (largeScaleChain_multiprocessing.py:19-240
``largeScaleChain_mp`` + ``lsc_run_wrapper``; smallScaleChain_
multiprocessing.py ``smallScaleChain_mp`` + ``msc_run_wrapper``): a farm
of chains with a master seed and initial beds, per-run checkpoint/resume,
segment batching and per-chain result tuples, but as one batched sampler
on one device instead of a multiprocessing pool, and one atomic
checkpoint instead of the per-seed file zoo.

The reference's nested output layout
(``LargeScaleChain/<lsc_seed>/SmallScaleChain/<ssc_seed>/``) maps to the
``<output_path>/LargeScaleChain`` and
``<output_path>/LargeScaleChain/<tag>/SmallScaleChain`` run directories,
as in the JAX package.  ``device`` is the card unless the caller asks for
the CPU.  Under ``torchrun`` (one process a card) the farm is sharded over
the ranks (``parallel/sampler.py``): every rank returns the same global
results, and only rank 0 prints (``_pod_one_writer``).
"""

from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import Optional

from .io.checkpoint import run_with_checkpointing
from .parallel.distributed import world
from .parallel.sampler import MultiChainSampler


def _pod_one_writer(quiet: bool, progress: bool):
    """Silence the completion banner and summary on every rank but 0.

    Every rank returns the same results, so an ungated banner would print
    one copy a rank into a combined log.  ``progress`` is left as it is:
    the sampler's per-segment gathers run on every rank whatever it says,
    and the sampler prints its progress from rank 0 only."""
    if world()[0] != 0:
        return True, progress
    return quiet, progress

_DONE_ART = r"""
           _
      o   (_)   GPU chain farm complete
   ~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~
"""


def _unpack_per_chain(states, hist, sampler):
    """Per-chain result tuples in the reference's ordering
    (beds, loss_mc, loss_data, loss, steps, resampled_times, blocks_used);
    an SGS chain's beds with the trend restored.  The whole farm's, on
    every rank of a sharded one (``sampler.gather``)."""
    beds = sampler.gather(sampler.full_bed(states))
    resampled = sampler.gather(states.resampled)
    return [(beds[i], hist["loss_mc"][i], hist["loss_data"][i],
             hist["loss"][i], hist["step"][i], resampled[i],
             hist["block"][i]) for i in range(sampler.n_chains)]


def _farm(chain, n_chains, ckpt_dir, seeds, initial_beds, n_iter,
          segment_size, checkpoint_every, progress, quiet,
          async_checkpoints, device):
    tic = time.time()
    quiet, progress = _pod_one_writer(quiet, progress)
    sampler = MultiChainSampler(chain, n_chains=n_chains, device=device)
    states, hist, cum = run_with_checkpointing(
        sampler, n_iter, ckpt_dir, seeds=seeds, initial_beds=initial_beds,
        segment_size=segment_size, progress=progress,
        checkpoint_every=checkpoint_every,
        async_checkpoints=async_checkpoints)
    if not quiet:
        print(_DONE_ART)
        print(f"Completed {cum} iterations x {n_chains} chains "
              f"in {time.time() - tic:.2f} seconds")
    return _unpack_per_chain(states, hist, sampler)


def large_scale_chain_farm(chain, n_chains: int, initial_beds=None,
                           rng_seeds=None,
                           n_iter: int = 5000,
                           output_path="./Data/output",
                           segment_size: int = 2000,
                           checkpoint_every: Optional[int] = None,
                           progress: bool = True, quiet: bool = False,
                           async_checkpoints: bool = False,
                           device="cuda"):
    """Run (or resume) a farm of large-scale chains.

    chain: a configured ChainCRF prototype.  initial_beds: one bed per
    chain / one to broadcast / None.  rng_seeds: an int master seed, None,
    or a list of per-chain seeds, as the JAX package takes (at least
    ``n_chains``, the first ``n_chains`` used): one stream a chain, chain
    i's draws depending on ``rng_seeds[i]`` alone
    (``utils/rng.PerChainStreams``).  A resume keeps the seeding the run
    was started with.  Returns a list of per-chain result tuples
    (reference return layout).
    """
    return _farm(chain, n_chains, Path(output_path) / "LargeScaleChain",
                 rng_seeds, initial_beds, n_iter, segment_size,
                 checkpoint_every, progress, quiet, async_checkpoints,
                 device)


def small_scale_chain_farm(chain, n_chains: int, initial_beds=None,
                           ssc_rng_seeds=None,
                           lsc_rng_seed: Optional[int] = None,
                           n_iter: int = 1000,
                           output_path="./Data/output",
                           segment_size: int = 500,
                           checkpoint_every: Optional[int] = None,
                           progress: bool = True, quiet: bool = False,
                           async_checkpoints: bool = False,
                           device="cuda"):
    """Run (or resume) a farm of small-scale (SGS) chains.

    Mirrors smallScaleChain_mp: ``initial_beds`` typically come from
    large-scale chain checkpoints; the run directory is nested under the
    parent large-scale chain's full seed (a truncated one could collide
    and silently continue another parent's chains).  ``ssc_rng_seeds``
    as ``large_scale_chain_farm``'s ``rng_seeds``: an int, None, or a list
    of per-chain seeds.
    """
    tag = str(lsc_rng_seed) if lsc_rng_seed is not None else "root"
    return _farm(chain, n_chains,
                 Path(output_path) / "LargeScaleChain" / tag
                 / "SmallScaleChain", ssc_rng_seeds, initial_beds, n_iter,
                 segment_size, checkpoint_every, progress, quiet,
                 async_checkpoints, device)


def iteration_batches(n_iter: int, batch: int = 10_000,
                      tail_batches: int = 9):
    """The reference's segment pattern ``[n - 90k] + [10k]*9`` for n >= 100k
    (largeScaleChain_multiprocessing.py:637-641)."""
    if n_iter < 10 * batch:
        return [n_iter]
    return [n_iter - tail_batches * batch] + [batch] * tail_batches


# reference-name aliases
largeScaleChain_mp = large_scale_chain_farm
smallScaleChain_mp = small_scale_chain_farm


def chain_snapshot(chain) -> dict:
    """Parameter snapshot of a configured chain builder: the role of the
    reference's ``__dict__`` pickling for pool workers
    (largeScaleChain_multiprocessing.py:44-70) and its rebuild helpers
    (MCMC.py:359-430).  Everything in it is plain numpy / Python, so it
    pickles cleanly."""
    out = {"__class__": type(chain).__name__}
    for k, v in vars(chain).items():
        out[k] = copy.deepcopy(v)
    return out


def chain_from_snapshot(snap: dict):
    """Rebuild a chain builder from ``chain_snapshot`` output."""
    from .models.chain_crf import ChainCRF
    from .models.chain_sgs import ChainSGS

    cls = {"ChainCRF": ChainCRF, "ChainSGS": ChainSGS}[snap["__class__"]]
    obj = cls.__new__(cls)
    for k, v in snap.items():
        if k != "__class__":
            setattr(obj, k, v)
    return obj
