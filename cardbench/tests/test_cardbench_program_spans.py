"""The program's own spans (``mcmc.*``, ``mcmc_tpu_torch/utils/spans.py``)
in a profile that ``trace.reduce_profile`` reduces: the device-side copies
the profiler makes of them stay out of the card's busy time (they carry
the user-annotation flag), so the window, the busy time, the kernels and
the segment-end gaps are those of the same profile without them; on the
host they name the idle gaps they hold, where the harness's spans alone
left "outside any op"."""

from types import SimpleNamespace

import pytest

from cardbench import trace

MS = 1_000_000  # ns


class Event:
    """What ``reduce_profile`` reads of a kineto event."""

    def __init__(self, name, start, end, device="CPU", annotation=False):
        self._name, self._start, self._end = name, start, end
        self._device, self._annotation = device, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return "DeviceType." + self._device

    def is_user_annotation(self):
        return self._annotation


def _profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


# two segments of a farm, or two chunks of a bed: kernels at 1-2, 4-5 and
# 7-8 ms (the second segment's first at 7); the host launching, copying
# and drawing between them
HARNESS = [Event("cardbench.segment", 0, 5 * MS),
           Event("cardbench.copy", 5 * MS, int(5.5 * MS)),
           Event("cardbench.segment", int(5.5 * MS), 9 * MS),
           Event("cardbench.copy", 9 * MS, 10 * MS)]
WORK = [Event("kernel_a", 1 * MS, 2 * MS, "CUDA"),
        Event("kernel_b", 4 * MS, 5 * MS, "CUDA"),
        Event("kernel_a", 7 * MS, 8 * MS, "CUDA"),
        Event("cudaGraphLaunch", int(0.9 * MS), int(1.1 * MS)),
        Event("aten::copy_", int(9.1 * MS), int(9.9 * MS))]
PROGRAM = [Event("mcmc.run_chains", int(0.1 * MS), int(4.9 * MS)),
           Event("mcmc.run_chains.replay", int(0.8 * MS), int(1.2 * MS)),
           Event("mcmc.sgs.draw", int(2.2 * MS), int(3.8 * MS)),
           Event("mcmc.run_chains", int(5.6 * MS), int(8.9 * MS)),
           Event("mcmc.host_copy", int(9.05 * MS), int(9.95 * MS)),
           # the profiler's device-side copies of host spans
           Event("mcmc.run_chains", 1 * MS, 5 * MS, "CUDA", True),
           Event("mcmc.run_chains.replay", 1 * MS, 2 * MS, "CUDA", True)]


def test_program_spans_add_no_busy_time():
    """Window, busy time, kernels and segment-end gaps as without the
    program's spans."""
    want = trace.reduce_profile(_profile(HARNESS + WORK))
    got = trace.reduce_profile(_profile(HARNESS + WORK + PROGRAM))
    assert got.window_s == want.window_s == pytest.approx(10e-3)
    assert got.busy_s == want.busy_s == pytest.approx(3e-3)
    assert got.kernels == want.kernels
    assert got.boundary_gaps_s == want.boundary_gaps_s == [
        pytest.approx(2e-3)]


def test_program_spans_name_the_idle_gaps():
    """The gaps at 0-1 and 5-7 ms lie in a segment's ``mcmc.run_chains``,
    the one at 2-4 ms in a draw span; without the program's spans the
    harness's segment span names all three.  The copy's gap is the
    harness's either way."""
    plain = dict(trace.reduce_profile(_profile(HARNESS + WORK)).idle_gaps)
    named = dict(trace.reduce_profile(
        _profile(HARNESS + WORK + PROGRAM)).idle_gaps)
    assert plain == pytest.approx({"cardbench.segment": 5e-3,
                                   "cardbench.copy": 2e-3})
    assert named == pytest.approx({"mcmc.run_chains": 3e-3,
                                   "mcmc.sgs.draw": 2e-3,
                                   "cardbench.copy": 2e-3})
