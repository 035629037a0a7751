"""Host milliseconds a frame inside the program: the durations of the root
``entry`` spans (the apps' entry points called from outside the program,
``MultiViewStereo.reset``/``add``/``solve``, ``sgm_pipeline_batched``, ...)
of the traced units over their frames. Read under the profiler, which adds
its own cost to every operation: it compares a parent with its change."""
from portbench import program_spans

UNIT = "ms/frame"
LAYER = "Entry points (apps/stereo.py, apps/stereo_sgm.py)"
MOVES = "frames_per_s"


def read(run):
    spans = program_spans.spans(run)
    roots = [s.host_ms for s in spans or () if s.layer == "entry" and s.parent is None]
    if not roots:
        return None
    return sum(roots) / run.trace.frames
