"""The share of the traced window in which no operation ran on the card:
1 - (union of device activity) / window."""

UNIT = "share"
LAYER = "Device"
MOVES = "frames_per_s"


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
