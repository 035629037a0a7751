"""The DTAM solve's share of its roofline: the least time its work needs on
the card over the device time of the operations launched inside
``stereo.dtam_cuda.dtam_run``, in percent.

The work is counted once from the cell's shapes: per iteration 7 float32
operations a (pixel, disparity) in the search and 48 a pixel in the dual and
primal steps (7.62 GFLOP at 640x480, 64 disparities and 50 iterations), and the bytes of the float32 volume read once and the planes
(g read, d, a and the two q planes read and written) once. At 640x480, 128
disparities and 80 iterations: 23.2 GFLOP, 0.346 ms at 67 TFLOP/s; the 168 MB
(0.050 ms) do not bind.
"""
from portbench import peaks

UNIT = "%"
LAYER = "Kernels (csrc/dtam.cu, wta_sq.cuh)"
MOVES = "frames_per_s"
LABEL = "stereo.dtam_cuda.dtam_run"
RANGES = {LABEL: "stereo.dtam_cuda:dtam_run"}


def bound_s(config: dict) -> float:
    """Least seconds of one solve of the cell."""
    st = config["stereo"]
    H, W, D, its = config["height"], config["width"], st["max_disp"], st["dtam_iterations"]
    return peaks.least_seconds(H * W * (D * 4 + 36), its * H * W * (7 * D + 48))


def read(run):
    t = run.trace
    calls = t.calls.get(LABEL) if t is not None else None
    dev = t.device_s({LABEL}) if calls else 0.0
    if not dev:
        return None
    return 100.0 * calls * bound_s(run.config) / dev
