"""Frames completed in the window over the window's seconds, by the host's
clock, the last unit ended synchronised. A frame is a pair of a batch or a
posed view added; every unit's own work (a keyframe's seed and solve) is
inside the window too."""

UNIT = "frames/s"
LAYER = None
MOVES = None


def read(run):
    return run.frames / run.window_s
