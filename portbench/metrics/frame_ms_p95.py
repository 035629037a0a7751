"""The 95th percentile of the latencies of all the window's frames: each
call from its first work on the idle card to its synchronised end, by CUDA
events (a batch's frames share the batch's latency)."""
import numpy as np

UNIT = "ms"
LAYER = None
MOVES = None


def read(run):
    if not run.latencies_ms:
        return None
    return float(np.percentile(np.asarray(run.latencies_ms, np.float64), 95))
