"""The Hamming cost volume's share of its roofline by the program's own
spans: the least time of one volume's work over the device time between
the CUDA events of a ``kernel`` span of ``kt_census_volume``, summed over
the traced volumes, in percent. A program that launches no such kernel (the
plain PyTorch version) records no such span and reads nothing; nor does a
CPU run.

The work is counted once from the cell's shapes, whatever implements it: a
volume over a batch's stacked rows; the two census images read once at
4 K bytes a pixel (their 32-bit words) and the volume written once in the
frame's type (bfloat16 unfiltered, as the frame stores it, every window's
bit capacity being a power of two; float32 filtered). At a batch
of 8 KITTI pairs (1242x375, 128 disparities, the 16x16 window: K = 4,
bfloat16) that is 1,073.1 MB, 0.3203 ms at 3.35 TB/s. The card's peaks
(``peaks.py``) have no integer instruction rate, so the K popcounts of each cell
(4 at 16x16: 1.91 G a batch), with their xors, are not counted, and may
bind before the bytes do.
"""
from pathlib import Path

from portbench import peaks, program_spans, spec

UNIT = "%"
LAYER = "Kernels (csrc/census.cu)"
MOVES = "frames_per_s"
ENTRY = "kt_census_volume"
census = spec.load_module(Path(__file__).with_name("census_roofline.rate.py"),
                          "census_roofline.rate")


def bound_s(config: dict, traffic: dict) -> float:
    """Least seconds of one volume of the cell."""
    sgm = config["sgm"]
    pixels = traffic["batch"] * config["height"] * config["width"]
    vol_bytes = 4 if sgm.get("guided_filter") or sgm.get("bilateral_filter") else 2
    return peaks.least_seconds(
        pixels * (2 * 4 * census.words(sgm["census_window"]) + sgm["max_disp"] * vol_bytes), 0)


def read(run):
    spans = program_spans.spans(run)
    dev = [s.device_ms for s in spans or () if s.layer == "kernel" and s.name == ENTRY]
    dev = [ms for ms in dev if ms is not None]
    if not dev or not sum(dev):
        return None
    return 100.0 * len(dev) * bound_s(run.config, run.traffic) / (sum(dev) * 1e-3)
