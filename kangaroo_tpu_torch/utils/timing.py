"""Device timing with CUDA events (``kangaroo_tpu/utils/timing.py``).

Each run is bracketed by two events on the current stream and read after a
synchronise, so the time is the device's, not the host's enqueue. There is
no CPU fallback: timing a device metric needs the device.
"""
from __future__ import annotations

import statistics

import torch


def time_fn(fn, *args, warmup: int = 3, runs: int = 20) -> dict:
    """Milliseconds per call of ``fn(*args)`` on the current CUDA device:
    ``warmup`` untimed calls, then ``runs`` timed ones. Returns
    ``{"median_ms", "min_ms", "max_ms"}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_fn measures CUDA device time and needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(runs)]
    for start, end in events:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    ms = sorted(start.elapsed_time(end) for start, end in events)
    return {"median_ms": statistics.median(ms), "min_ms": ms[0], "max_ms": ms[-1]}
