"""window_kernel_roofline: the CRF window update's least time over its
device time, a launch, in the CRF farm cell.  Layer: kernel
(``ops/window_kernel.py`` -> ``csrc/window_kernel.cu``).  Read from the
device trace (the kernel ``fused_window_kernel``: its launches and time)
and the profiled segments' traces: each step's blocks and decisions give
the bytes the launch must move (``roofline.window_bytes``, each input byte
once), bound by the card's memory bandwidth; the mean bound over the
profiled steps (every k-th, at most ``STEPS_COUNTED`` of them: the count
paints the grid a step), times the launches, over the kernel's time, in
%."""

import numpy as np

from cardbench import roofline

KERNELS = ("fused_window_kernel",)
STEPS_COUNTED = 400


def read(view):
    launches, seconds = view.kernel(*KERNELS)
    if launches == 0 or seconds <= 0 or not view.segments:
        return None
    H, W = view.info["H"], view.info["W"]
    steps = [(seg, t) for seg in view.segments
             for t in range(seg["step"].shape[0])]
    every = -(-len(steps) // STEPS_COUNTED)
    moved = [roofline.window_bytes(seg["block"][t], seg["step"][t], H, W,
                                   view.info["n_const"])
             for seg, t in steps[::every]]
    least, _ = roofline.bound_s(float(np.mean(moved)))
    return 100.0 * launches * least / seconds
