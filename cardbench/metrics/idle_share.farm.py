"""idle_share.farm: the share of the profiled window in which no operation
ran on the card, in a farm cell.  Layer: device.  Read from the device
trace: 100 (1 - busy / window), the window running from the first
``run_segment`` span's start to the last segment's copy's end."""


def read(view):
    if view.window_s <= 0 or view.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
