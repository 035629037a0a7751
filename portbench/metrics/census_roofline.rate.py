"""The census transform's share of its roofline by the program's own
spans: the least time of one call's work over the device time between the
CUDA events of a ``kernel`` span of ``kt_census``, summed over the traced
calls, in percent. A program that launches no such kernel (the plain
PyTorch version) records no such span and reads nothing; nor does a CPU
run.

The work is counted once from the cell's shapes, whatever implements it: a
call is one side of a batch (the batched frame makes one a side, the single
frame one an image); each frame's image read once (uint8, 1 byte a pixel,
as the cell's pairs are) and its K census words written once at 4 bytes
each (the bits they hold; the program stores them in int64). Its 63-128
comparisons a pixel are not counted. At a batch of 8 KITTI pairs (1242x375,
the 16x16 window: K = 4) a side moves 63.3 MB, both 126.7 MB: 0.0378 ms at
3.35 TB/s.
"""
from portbench import peaks, program_spans
from portbench.reference import sgm as reference

UNIT = "%"
LAYER = "Kernels (csrc/census.cu)"
MOVES = "frames_per_s"
ENTRY = "kt_census"
IMAGE_BYTES = 1


def words(window: str) -> int:
    """32-bit census words a pixel: the window's comparisons, from the
    reference's table of windows."""
    rows, cols, _ = reference.WINDOWS[window]
    return -(-len(rows) * len(cols) // 32)


def bound_s(config: dict, traffic: dict) -> float:
    """Least seconds of one call: one side of a batch."""
    pixels = traffic["batch"] * config["height"] * config["width"]
    return peaks.least_seconds(pixels * (IMAGE_BYTES + 4 * words(config["sgm"]["census_window"])),
                               0)


def read(run):
    spans = program_spans.spans(run)
    dev = [s.device_ms for s in spans or () if s.layer == "kernel" and s.name == ENTRY]
    dev = [ms for ms in dev if ms is not None]
    if not dev or not sum(dev):
        return None
    return 100.0 * len(dev) * bound_s(run.config, run.traffic) / (sum(dev) * 1e-3)
