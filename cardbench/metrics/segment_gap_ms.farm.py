"""segment_gap_ms.farm: the card's idle time at a segment's end, in a farm
cell.  Layer: host segment loop (``parallel/sampler.py``: ``run_segment``,
then the traces' copy to the host).  Read from the device trace and the
harness's spans: at each end of a ``cardbench.copy`` span but the last
(the segment's traces are on the host, so the card has finished it), the
gap from the card's last operation before it to its first after it; the
mean over the profiled segments, in ms."""


def read(view):
    gaps = view.boundary_gaps_s
    if not gaps:
        return None
    return 1e3 * sum(gaps) / len(gaps)
