"""Multi-chain sampler: the chain farm on one device.

PyTorch counterpart of ``mcmc_tpu/parallel/sampler.py`` (the reference's
``multiprocessing.Pool`` farm, largeScaleChain_multiprocessing.py:19-98).
Chains are the leading batch axis of one state; they exchange nothing
while sampling.  ``run`` loops over segments of steps; inside a segment
every trace stays on the device in preallocated ``(n_steps, N, ...)``
tensors and nothing waits for the host, and each segment's traces are
copied to the host once, at its end.

Not carried over from the JAX package: the device mesh, chunked launches
(``scan_chunked``) and grid auto-padding, which were TPU workarounds; the
SGS chain family, per-chain seed lists and multi-GPU sharding wait for
later slices (ROADMAP Queue 1).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models.chain_crf import ChainState, IMPLS, init_state, make_step
from ..utils.rng import make_generator


class MultiChainSampler:
    """Farm of ``n_chains`` CRF chains built from one prototype chain.

    ``impl``: "auto" runs the CUDA window kernel for CUDA tensors and the
    plain version for CPU ones; "eager" always runs the plain version;
    "fused" demands the kernel and raises on a CPU device.
    """

    def __init__(self, chain, n_chains: int, device=None,
                 impl: str = "auto"):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
        self.device = torch.device(
            device if device is not None
            else ("cuda" if torch.cuda.is_available() else "cpu"))
        if impl == "fused" and self.device.type != "cuda":
            raise ValueError("impl='fused' runs the CUDA window kernel and "
                             f"needs a CUDA device, not {self.device}")
        self.chain = chain
        self.n_chains = int(n_chains)
        self.impl = impl
        self.static, self.consts = chain.build(self.device)
        self._step = make_step(self.static, impl)
        self.generator = None

    # -- state ---------------------------------------------------------------

    def init(self, initial_beds=None, seeds=None) -> ChainState:
        """Batched initial states, and the sampler's generator.

        initial_beds: (n_chains, H, W), one (H, W) bed shared by every
        chain, or None for the prototype chain's initial bed.
        seeds: int master seed or None (fresh entropy); a None falls back
        to the chain's ``set_random_generator`` seed when it has one.
        """
        if seeds is None:
            seeds = self.chain.seed
        self.generator = make_generator(seeds, self.device)
        beds = (self.chain.initial_bed if initial_beds is None
                else np.asarray(initial_beds, np.float32))
        if beds.ndim == 3 and beds.shape[0] != self.n_chains:
            raise ValueError("initial_beds leading dim must equal n_chains")
        return init_state(beds, self.consts, self.n_chains)

    # -- execution -----------------------------------------------------------

    def _trace_buffers(self, n_steps: int):
        N, P = self.n_chains, self.static.P
        kw = dict(device=self.device)
        return {
            "loss_mc": torch.empty((n_steps, N), dtype=torch.float32, **kw),
            "loss_data": torch.empty((n_steps, N), dtype=torch.float32, **kw),
            "loss": torch.empty((n_steps, N), dtype=torch.float32, **kw),
            "step": torch.empty((n_steps, N), dtype=torch.bool, **kw),
            "block": torch.empty((n_steps, N, 4), dtype=torch.float32, **kw),
            "samples": torch.empty((n_steps, N, P), dtype=torch.float32,
                                   **kw),
        }

    def run_segment(self, states: ChainState, n_steps: int):
        """``n_steps`` MH steps; returns (states, traces) with time-major
        device traces of shape (n_steps, n_chains, ...)."""
        if self.generator is None:
            raise RuntimeError("call init() before running the sampler")
        bufs = self._trace_buffers(int(n_steps))
        for t in range(int(n_steps)):
            states, tr = self._step(self.consts, states, self.generator)
            for k, buf in bufs.items():
                buf[t] = tr[k]
        return states, bufs

    def _init_row(self, states: ChainState):
        N = self.n_chains
        sij = self.consts.sample_ij
        samples = (states.bed[:, sij[:, 0], sij[:, 1]] if sij.shape[0]
                   else states.bed.new_zeros((N, 0)))
        row = {
            "loss_mc": states.loss_mc,
            "loss_data": states.loss_data,
            "loss": states.loss_mc + states.loss_data,
            "step": torch.zeros(N, dtype=torch.bool, device=self.device),
            "block": torch.full((N, 4), float("nan"), device=self.device),
            "samples": samples,
        }
        return {k: v.cpu().numpy()[None] for k, v in row.items()}

    def run(self, states: ChainState, n_iter: int, segment_size: int = 2000,
            progress: bool = True,
            segment_callback: Optional[Callable] = None):
        """Run ``n_iter`` iterations in segments of ``segment_size`` steps.

        Iteration 0 records the initial state (reference loop semantics);
        ``segment_callback(cumulative_iter, states, traces_np)`` fires after
        each segment.  Returns (states, traces) with chain-major numpy
        traces of length n_iter.
        """
        n_iter = int(n_iter)
        if n_iter < 1:
            raise ValueError("n_iter must be >= 1 (trace row 0 records "
                             "the initial state)")
        collected = [self._init_row(states)]
        remaining = n_iter - 1
        done = 1
        t0 = time.time()
        while remaining > 0:
            n = min(int(segment_size), remaining)
            states, traces = self.run_segment(states, n)
            traces_np = {k: v.cpu().numpy() for k, v in traces.items()}
            if done == 1:
                traces_np = {k: np.concatenate([collected[0][k], v])
                             for k, v in traces_np.items()}
                collected[0] = traces_np
            else:
                collected.append(traces_np)
            remaining -= n
            done += n
            if progress:
                dt = time.time() - t0
                loss_np = states.loss_mc.cpu().numpy()
                acc_np = states.accepted.cpu().numpy() / max(done - 1, 1)
                print(f"[sampler] iter {done}/{n_iter} | "
                      f"{(done - 1) * self.n_chains / max(dt, 1e-9):,.0f} "
                      f"chain-it/s | loss mean {loss_np.mean():.4e} | "
                      f"acc {acc_np.mean():.3f}", flush=True)
            if segment_callback is not None:
                segment_callback(done, states, traces_np)
        return states, {k: np.moveaxis(np.concatenate([c[k] for c in
                                                       collected]), 0, 1)
                        for k in collected[0]}

    # -- diagnostics ---------------------------------------------------------

    def diagnostics(self, traces, elapsed_seconds=None):
        """Convergence summary: acceptance, split R-hat and ESS of the loss
        and the probes (+ chain-it/s and ESS/s when ``elapsed_seconds`` is
        given)."""
        from . import diagnostics as diag

        out = {"acceptance_rate": diag.acceptance_rate(traces["step"])}
        if traces["samples"].shape[-1] > 0:
            samp = traces["samples"]
            out["rhat"] = diag.split_rhat(samp)
            out["ess"] = diag.ess(samp)
            out["rhat_rank"] = diag.rank_normalized_rhat(samp)
            out["ess_bulk"] = diag.ess_bulk(samp)
            out["ess_tail"] = diag.ess_tail(samp)
        loss_tr = traces["loss"]
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
