"""Host milliseconds a frame of the plain stages' own work: the self time
(duration less what the child spans cover) of the ``stage`` spans (census,
the Hamming volume, the seed volume, the running mean, the edge weight) of
the traced units over their frames, the cost of enqueueing their PyTorch
operations. Read under the profiler, as ``program_host_ms.rate``."""
from portbench import program_spans

UNIT = "ms/frame"
LAYER = "Plain stages (stereo/census.py, stereo/costvolume.py)"
MOVES = "frames_per_s"


def read(run):
    spans = program_spans.spans(run)
    own = [s.self_ms for s in spans or () if s.layer == "stage"]
    if not own:
        return None
    return sum(own) / run.trace.frames
