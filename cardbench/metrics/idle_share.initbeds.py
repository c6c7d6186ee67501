"""idle_share.initbeds: the share of the profiled beds' window in which no
operation ran on the card, in the initial-beds cell.  Layer: device.  Read
from the device trace: 100 (1 - busy / window), the window being the
harness's ``cardbench.bed`` spans."""


def read(view):
    if view.window_s <= 0 or view.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
