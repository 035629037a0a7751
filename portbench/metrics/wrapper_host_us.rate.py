"""Host microseconds a call of the hand-written kernels' wrappers beyond the
launch itself: the self time of the ``dispatch`` spans (``_KernelOp`` and
the wrappers that launch without it: checks, allocations, the scalars, any
wait for the stream) less their ``kernel`` children, over their number, in
the traced units. Nothing to read on the CPU, where no wrapper runs."""
from portbench import program_spans

UNIT = "us/call"
LAYER = "Dispatch and kernel wrappers, host (stereo/dispatch.py, *_cuda.py)"
MOVES = "frames_per_s"


def read(run):
    spans = program_spans.spans(run)
    own = [s.self_ms for s in spans or () if s.layer == "dispatch"]
    if not own:
        return None
    return 1e3 * sum(own) / len(own)
