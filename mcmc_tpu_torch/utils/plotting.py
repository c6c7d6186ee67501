"""Diagnostic figures: loader quick-looks, QC panels, live chain plots.

A copy of ``mcmc_tpu/utils/plotting.py`` (matplotlib host code; the port
imports nothing of the JAX package).  matplotlib is imported inside the
functions that draw (``_plt``), so importing the port never needs it.
Mirrors the reference's observed plotting behavior: every loader returns a
two-panel interpolation-vs-data figure (reference Topography.py:74-88 and
siblings), filter_data_by_std draws a 3-panel exclusion diagnostic
(Topography.py:648-668), and the chains render a live loss + acceptance
figure during runs (MCMC.py:1202-1223, 1414-1432).  All figures are
created closed (plt.close, like the reference) so they are headless-safe
and notebook-displayable.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib.pyplot as plt

    return plt


def quicklook(xx, yy, grid, ix=None, iy=None, iz=None, title="interpolated",
              units=""):
    """Two-panel regridded-field vs source-data figure (the reference's
    loader return figure, Topography.py:74-88)."""
    plt = _plt()
    have_pts = ix is not None and iz is not None and np.size(iz) > 0
    vmax = np.nanmax(grid) if not have_pts else max(np.nanmax(grid), np.nanmax(iz))
    vmin = np.nanmin(grid) if not have_pts else min(np.nanmin(grid), np.nanmin(iz))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4),
                                   gridspec_kw={"wspace": -0.1})
    im = ax1.pcolormesh(xx, yy, grid, vmin=vmin, vmax=vmax)
    ax1.axis("scaled")
    ax1.set_title(title)
    fig.colorbar(im, ax=ax1, pad=0.03, aspect=40, label=units)
    if have_pts:
        im2 = ax2.scatter(np.asarray(ix).ravel(), np.asarray(iy).ravel(),
                          c=np.asarray(iz).ravel(), s=20, vmin=vmin, vmax=vmax)
        fig.colorbar(im2, ax=ax2, pad=0.03, aspect=40)
    ax2.axis("scaled")
    ax2.set_title("source data")
    ax2.set_yticks([])
    plt.close(fig)
    return fig


def qc_panels(xx, yy, diff, std, num_of_std):
    """3-panel radar-QC exclusion diagnostic (reference
    Topography.py:629-668): the rf-vs-conditioning difference field and the
    two one-sided exclusion masks."""
    plt = _plt()
    fig, (ax0, ax1, ax2) = plt.subplots(1, 3, figsize=(15, 4))
    im = ax0.pcolormesh(xx / 1000, yy / 1000, diff, cmap="RdBu")
    ax0.set_title("rf bed - conditioning bed")
    ax0.set_xlabel("X [km]")
    ax0.set_ylabel("Y [km]")
    ax0.axis("scaled")
    fig.colorbar(im, ax=ax0)
    ax1.pcolormesh(xx / 1000, yy / 1000, diff < std * num_of_std, cmap="RdPu")
    ax1.set_title("if only exclude positive radardiff (bed>rf)")
    ax1.set_xlabel("X [km]")
    ax1.axis("scaled")
    ax2.pcolormesh(xx / 1000, yy / 1000, diff > -std * num_of_std, cmap="RdPu")
    ax2.set_title("if only exclude negative radardiff (bed<rf)")
    ax2.set_xlabel("X [km]")
    ax2.axis("scaled")
    plt.close(fig)
    return fig


class LiveChainPlot:
    """Live loss + acceptance-rate figure, updated during a run (reference
    MCMC.py:1202-1223, 1414-1432, updated per info interval).

    Designed as a MultiChainSampler ``segment_callback`` (``ChainCRF.run``
    and ``ChainSGS.run`` drive it with ``plot=True``):

        plot = LiveChainPlot()
        sampler.run(states, n_iter, segment_callback=plot)

    Works headless (updates the figure object; display only when a GUI /
    notebook backend is active).  ``fig`` stays accessible afterwards.
    """

    def __init__(self, show=None):
        plt = _plt()
        self.plt = plt
        self.fig, (self.ax_loss, self.ax_acc) = plt.subplots(
            1, 2, figsize=(12, 5))
        (self.line_loss,) = self.ax_loss.plot([], [], color="tab:blue",
                                              label="Loss (chain mean)")
        (self.line_acc,) = self.ax_acc.plot([], [], color="tab:green",
                                            label="Acceptance Rate")
        self.ax_loss.set_xlabel("Iteration")
        self.ax_loss.set_ylabel("Loss")
        self.ax_loss.set_title("MCMC Loss")
        self.ax_acc.set_xlabel("Iteration")
        self.ax_acc.set_ylabel("Acceptance Rate (%)")
        self.ax_acc.set_ylim(0, 100)
        self.ax_acc.set_title("MCMC Acceptance Rate")
        self.ax_loss.legend()
        self.ax_acc.legend()
        self._iters = []
        self._losses = []
        self._accs = []
        if show is None:
            show = self.plt.get_backend().lower() not in ("agg", "pdf", "svg")
        self._show = show

    def __call__(self, cumulative_iter, states, traces_np):
        # sampler segment callbacks hand TIME-major traces (t, chains, ...)
        loss = np.asarray(traces_np["loss"], np.float64)
        step = np.asarray(traces_np["step"], np.float64)
        self._iters.append(int(cumulative_iter))
        self._losses.append(float(np.nanmean(loss[-1])))
        self._accs.append(100.0 * float(step.mean()))
        self.line_loss.set_data(self._iters, self._losses)
        self.ax_loss.relim()
        self.ax_loss.autoscale_view()
        self.line_acc.set_data(self._iters, self._accs)
        self.ax_acc.relim()
        self.ax_acc.autoscale_view()
        self.ax_acc.set_ylim(0, 100)
        if self._show:  # pragma: no cover - needs GUI backend
            self.fig.canvas.draw_idle()
            self.plt.pause(0.001)
