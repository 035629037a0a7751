"""The DTAM solve's share of its roofline by the program's own spans: the
least time of a solve's work (``dtam_roofline.rate``'s ``bound_s``, so that
the work counted is the same whatever implements it) times the calls, over
the device time between the CUDA events of the ``kernel`` spans of
``kt_dtam_run`` (the C entry alone, without the wrapper's copies), in
percent. Nothing to read on the CPU."""
from pathlib import Path

from portbench import program_spans, spec

UNIT = "%"
LAYER = "Kernels (csrc/dtam.cu, wta_sq.cuh)"
MOVES = "frames_per_s"
ENTRY = "kt_dtam_run"


def read(run):
    spans = program_spans.spans(run)
    dev = [s.device_ms for s in spans or () if s.layer == "kernel" and s.name == ENTRY]
    dev = [ms for ms in dev if ms is not None]
    if not dev or not sum(dev):
        return None
    roofline = spec.load_module(Path(__file__).with_name("dtam_roofline.rate.py"),
                                "dtam_roofline.rate")
    return 100.0 * len(dev) * roofline.bound_s(run.config) / (sum(dev) * 1e-3)
