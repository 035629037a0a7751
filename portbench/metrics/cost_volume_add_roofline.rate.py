"""The running-mean view update's share of its roofline by the program's own
spans: the least time of one view's work over the device time between the
CUDA events of a ``kernel`` span of ``kt_cost_volume_add``, summed over
the traced views, in percent. A program that launches no such kernel (the
plain PyTorch version) records no such span and reads nothing; nor does a
CPU run.

The work is counted once from the cell's shapes, whatever implements it:
the bytes of n and s (float32) read once and written once and of the two
float32 images read once; and per (d, v, u) cell, with T = (2 rad + 1)^2
taps, 28 + 20 T float32 operations: P 4 (two products, two divisions), the
three rows of the projection 18 (each two products summed onto a third and
the translation added, a multiply-add counted two), pu and pv 2, each tap
15 (its two coordinates, their floors and fractions, three lerps), the mean
of the view's taps T + 1, the SAD 4 T + 1, n and s 2 (the clamps and the
gathers' row offsets are addressing, not counted). At 640x480, 128
disparities and rad 1: 631.6 MB, 0.1885 ms at 3.35 TB/s; the 8.18 GFLOP
(0.122 ms at 67 TFLOP/s) do not bind.
"""
from portbench import peaks, program_spans

UNIT = "%"
LAYER = "Kernels (csrc/cost_volume_add.cu)"
MOVES = "frames_per_s"
ENTRY = "kt_cost_volume_add"


def bound_s(config: dict) -> float:
    """Least seconds of one view's update of the cell's volume."""
    H, W, D = config["height"], config["width"], config["stereo"]["max_disp"]
    taps = (2 * config["rad"] + 1) ** 2
    return peaks.least_seconds(4 * (4 * D * H * W + 2 * H * W), D * H * W * (28 + 20 * taps))


def read(run):
    spans = program_spans.spans(run)
    dev = [s.device_ms for s in spans or () if s.layer == "kernel" and s.name == ENTRY]
    dev = [ms for ms in dev if ms is not None]
    if not dev or not sum(dev):
        return None
    return 100.0 * len(dev) * bound_s(run.config) / (sum(dev) * 1e-3)
