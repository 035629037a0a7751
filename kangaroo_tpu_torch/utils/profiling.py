"""Profiling helpers (``kangaroo_tpu/utils/profiling.py``).

The equivalent of the reference's CudaTimer-based instrumentation and
memory prints: a ``torch.profiler`` trace written as a Chrome trace, and a
device-memory report in place of the apps' cudaMemGetInfo prints
(stereo/main.cpp:30-31,189-190).
"""
from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when a
    card is present) and write its Chrome trace (Perfetto,
    chrome://tracing) as ``<host>.<pid>.<ns>.pt.trace.json`` into
    ``logdir`` (default: ``kangaroo_trace`` in the temporary directory),
    even when the block raises. Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "kangaroo_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(logdir, name))


def device_memory_report() -> str:
    """One line per CUDA device: the bytes PyTorch's allocator holds for
    tensors and the card's total, or "memory stats unavailable" (and one
    line for the CPU when there is no card)."""
    if not torch.cuda.is_available():
        return "cpu: memory stats unavailable"
    lines = []
    for i in range(torch.cuda.device_count()):
        dev = f"cuda:{i} ({torch.cuda.get_device_name(i)})"
        try:
            used = torch.cuda.memory_allocated(i) / 2**20
            total = torch.cuda.mem_get_info(i)[1] / 2**20
        except RuntimeError:
            lines.append(f"{dev}: memory stats unavailable")
            continue
        lines.append(f"{dev}: {used:.1f} MiB in use / {total:.1f} MiB")
    return "\n".join(lines)
