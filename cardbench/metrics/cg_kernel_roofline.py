"""cg_kernel_roofline: the SGS mixture-system CG's least time over its
device time, a launch, in the SGS farm cell.  Layer: kernel
(``ops/cg_kernel.py`` -> ``csrc/cg_kernel.cu``, the mixture CG).  Read from
the device trace (the kernel ``mix_cg_kernel``: its launches and time);
the work from the shapes (``roofline.mixture_cg_work``: the chains'
K x K systems built from the covariance mixture and iterated a fixed
number of times), bound by float32 operations; in %."""

from cardbench import roofline

KERNELS = ("mix_cg_kernel",)


def read(view):
    launches, seconds = view.kernel(*KERNELS)
    info = view.info
    if launches == 0 or seconds <= 0 or not info.get("mix_terms"):
        return None
    least, _ = roofline.bound_s(*roofline.mixture_cg_work(
        info["chains"], info["K"], info["cg_iters"], info["mix_terms"]))
    return 100.0 * launches * least / seconds
