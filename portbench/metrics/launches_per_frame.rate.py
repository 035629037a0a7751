"""CUDA kernel launches in the traced window over its frames: the host's
work per frame in the dispatch and the kernel wrappers."""

UNIT = "launches/frame"
LAYER = "Dispatch and kernel wrappers, host (stereo/dispatch.py, *_cuda.py)"
MOVES = "frames_per_s"


def read(run):
    t = run.trace
    if t is None or not t.frames or not t.kernels:
        return None
    return t.kernels / t.frames
