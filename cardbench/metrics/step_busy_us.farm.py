"""step_busy_us.farm: the card's busy time an MH step, in a farm cell.
Layer: the chain step (the CRF step: ``models/chain_crf.py``,
``ops/spectral.py``, ``ops/noise_kernel.py``, ``ops/window_kernel.py``;
the SGS step: ``models/chain_sgs.py`` and its kernels).  Read from the
device trace: the union of the intervals in which an operation ran on the
card over the profiled window, over the MH steps in it, in us."""


def read(view):
    if view.steps <= 0 or view.busy_s <= 0:
        return None
    return 1e6 * view.busy_s / view.steps
