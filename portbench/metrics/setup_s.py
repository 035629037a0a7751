"""Seconds from the start of the run's process to its first timed frame:
importing, making the inputs and the program's objects, building the
kernels where the checkout has none yet, and warming up every shape of the
cell's traffic."""

UNIT = "s"
LAYER = None
MOVES = None


def read(run):
    return run.setup_s
