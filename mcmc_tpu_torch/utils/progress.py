"""Multi-chain terminal progress rendering.

A copy of ``mcmc_tpu/utils/progress.py`` (framework-free host code; the
port imports nothing of the JAX package).  Equivalent of the reference's
fixed-line ANSI renderer (reference: MCMC.py:31-39 move_cursor_to_line/
clear_line and the per-chain progress block at MCMC.py:1379-1408): one
status line per chain updated in place, with percent bar, it/s, ETA,
loss, and acceptance.  The batched sampler draws it per segment instead
of per iteration (``MultiChainSampler.run(progress=True,
fancy_progress=True)``; without ``fancy_progress`` the sampler prints one
status line a segment, as the JAX package's does).
"""

from __future__ import annotations

import sys
import time

import numpy as np


def move_cursor_to_line(line_number: int):
    sys.stdout.write(f"\033[{line_number};0H")
    sys.stdout.flush()


def clear_line():
    sys.stdout.write("\033[2K")
    sys.stdout.flush()


def format_chain_line(chain_id, seed, progress, it_per_sec, n_iter, loss,
                      acc, bar_length=10):
    pct = progress * 100.0
    filled = int(bar_length * progress)
    bar = ("█" * filled + ("▍" if filled < bar_length and progress > 0 else "")
           ).ljust(bar_length)
    if it_per_sec > 0:
        eta = (1 - progress) * n_iter / it_per_sec
        eta_str = (f"{int(eta // 3600):02d}:{int(eta % 3600 // 60):02d}:"
                   f"{int(eta % 60):02d}")
    else:
        eta_str = "--:--:--"
    return (f"Chain {chain_id} ({str(seed)[:6]}): {pct:3.0f}%|{bar}| "
            f"ETA: {eta_str} | it/s: {it_per_sec:8.1f} | n: {n_iter:d} | "
            f"loss: {loss:.3e} | acc: {acc:.4f}")


class MultiChainProgress:
    """In-place per-chain progress block (plus an aggregate line)."""

    def __init__(self, n_chains: int, n_iter: int, seeds=None,
                 max_lines: int = 16, stream=None):
        self.n_chains = int(n_chains)
        self.n_iter = int(n_iter)
        self.seeds = seeds if seeds is not None else ["?"] * n_chains
        self.shown = min(self.n_chains, max_lines)
        self.stream = stream or sys.stdout
        self.t0 = time.time()
        self._primed = False

    def update(self, done_iter: int, losses, accepts):
        """Redraw the per-chain block from current losses/accept flags."""
        losses = np.asarray(losses)
        accepts = np.asarray(accepts, float)
        elapsed = max(time.time() - self.t0, 1e-9)
        rate = (done_iter - 1) / elapsed
        lines = [
            f"Running {self.n_chains} chains | iter {done_iter}/{self.n_iter}"
            f" | {rate * self.n_chains:,.0f} chain-it/s aggregate"
        ]
        for i in range(self.shown):
            lines.append(format_chain_line(
                i, self.seeds[i] if i < len(self.seeds) else "?",
                done_iter / self.n_iter, rate, self.n_iter,
                float(losses[i]), float(accepts[i])))
        if self.n_chains > self.shown:
            lines.append(f"... and {self.n_chains - self.shown} more chains")
        block = "\n".join(lines)
        if self._primed:
            # move back up and redraw in place
            self.stream.write(f"\033[{len(lines)}F")
        self.stream.write("\033[0J" + block + "\n")
        self.stream.flush()
        self._primed = True
