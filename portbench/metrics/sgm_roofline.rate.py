"""The SGM aggregation's share of its roofline: the least time its work
needs on the card over the device time of the operations launched inside
``stereo.dispatch.semi_global_matching``, in percent.

The work is counted once from the cell's shapes, whatever kernel does it:
the cost volume read once (bfloat16 for the census windows whose bit
capacity is a power of two, as the frame stores it; float32 otherwise), the
intensity read once, the float32 aggregate written once, and 36 float32
operations an element (9 a path step, 4 paths). At a batch of 8 KITTI pairs
(1242x375, 128 disparities) that is 2.876 GB, 0.859 ms at 3.35 TB/s; the
operations' 0.26 ms does not bind.
"""
from portbench import peaks

UNIT = "%"
LAYER = "Kernels (csrc/sgm_path.cu)"
MOVES = "frames_per_s"
LABEL = "stereo.dispatch.semi_global_matching"
RANGES = {LABEL: "stereo.dispatch:semi_global_matching"}
OPS_PER_ELEMENT = 36
POW2_WINDOWS = ("16x16", "9x7", "11x11")  # bit capacities 256, 64, 128


def bound_s(config: dict, traffic: dict) -> float:
    """Least seconds of one aggregation call of the cell."""
    sgm = config["sgm"]
    B, H, W, D = traffic["batch"], config["height"], config["width"], sgm["max_disp"]
    filtered = sgm.get("guided_filter") or sgm.get("bilateral_filter")
    vol_bytes = 2 if sgm["census_window"] in POW2_WINDOWS and not filtered else 4
    pixels = B * H * W
    return peaks.least_seconds(pixels * (D * vol_bytes + 4 + D * 4),
                               pixels * D * OPS_PER_ELEMENT)


def read(run):
    t = run.trace
    calls = t.calls.get(LABEL) if t is not None else None
    dev = t.device_s({LABEL}) if calls else 0.0
    if not dev:
        return None
    return 100.0 * calls * bound_s(run.config, run.traffic) / dev
