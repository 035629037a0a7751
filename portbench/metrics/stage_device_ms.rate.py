"""Device milliseconds a frame of the plain stages, by the program's own
spans: the time between the CUDA events that each outermost ``stage`` span
records on its stream at entry and at exit, over the traced units' frames.
The in-program twin of ``cost_volume_ms.rate``; it also holds the stream's
short gaps inside a stage and the edge weight. Nothing to read on the
CPU."""
from portbench import program_spans

UNIT = "ms/frame"
LAYER = "Plain stages (stereo/census.py, stereo/costvolume.py)"
MOVES = "frames_per_s"


def read(run):
    spans = program_spans.spans(run)
    dev = [s.device_ms for s in program_spans.outermost(spans or [], "stage")]
    dev = [ms for ms in dev if ms is not None]
    if not dev:
        return None
    return sum(dev) / run.trace.frames
