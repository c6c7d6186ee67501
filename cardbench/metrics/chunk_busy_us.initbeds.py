"""chunk_busy_us.initbeds: the card's busy time a chunk of 64 cells of an
initial bed.  Layer: geostatistics (``geostats/sgs.py``'s captured chunk:
the window gather, ``ops/neighbors.py``'s octant search, ``ops/kriging.py``'s
batched LU).  Read from the device trace: the union of the intervals in
which an operation ran on the card over the profiled beds, over their
chunks, in us."""


def read(view):
    if view.steps <= 0 or view.busy_s <= 0:
        return None
    return 1e6 * view.busy_s / view.steps
