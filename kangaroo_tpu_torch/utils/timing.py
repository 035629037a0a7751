"""Timing (``kangaroo_tpu/utils/timing.py``).

``time_fn`` and ``time_fn_stats`` bracket runs with CUDA events on the
current stream and read them after a synchronise, so the time is the
device's, not the host's enqueue; ``time_fn_stats`` times CPU tensors with
the host clock. ``Timer`` is the reference's CudaTimer (running
average, min and max of host-clock intervals that end in a synchronise).
"""
from __future__ import annotations

import statistics
import time

import torch


def time_fn(fn, *args, warmup: int = 3, runs: int = 20) -> dict:
    """Milliseconds per call of ``fn(*args)`` on the current CUDA device:
    ``warmup`` untimed calls, then ``runs`` timed ones. Returns
    ``{"median_ms", "min_ms", "max_ms"}`` (unlike the JAX package's
    ``time_fn``, which returns one number of seconds). There is no CPU
    fallback: timing a device metric needs the device."""
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


def _tensors(value):
    """The tensors in ``value``: a tensor, or a tuple, list or dict of them
    (nested)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensors(v)]
    return []


def _cuda_devices(value):
    return sorted({t.device.index or 0 for t in _tensors(value) if t.is_cuda})


def _sync(value) -> None:
    for index in _cuda_devices(value):
        torch.cuda.synchronize(index)


def time_fn_stats(fn, *args, iters: int = 16, k: int = 3, reduce_outputs: bool = False) -> dict:
    """``k`` measurements of ``fn(*args)``, each over ``iters`` calls back
    to back after one untimed call: ``{"median", "min", "max"}`` seconds a
    call, as the JAX package's. On CUDA tensors (among ``args``) each is
    a pair of CUDA events around the calls; otherwise the host clock.

    ``reduce_outputs`` is kept for the JAX package's signature and does
    nothing: there it sums every output inside the jitted repeat loop so
    that XLA cannot eliminate an independent branch as dead code; eager
    PyTorch runs every call in full, so there is nothing to keep alive."""
    del reduce_outputs
    devices = _cuda_devices(args)
    fn(*args)
    ts = []
    for _ in range(k):
        if devices:
            _sync(args)
            with torch.cuda.device(devices[0]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(*args)
                end.record()
                end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            ts.append((time.perf_counter() - t0) / iters)
    ts.sort()
    return {"median": ts[len(ts) // 2], "min": ts[0], "max": ts[-1]}


class Timer:
    """Running avg/min/max timer (CudaTimer.h Start/Stop/PrintSummary), in
    seconds of the host clock."""

    def __init__(self, name: str = ""):
        self.name = name
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None):
        """End the interval; first synchronise the devices of the CUDA
        tensors in ``sync_value`` (a tensor, or a tuple, list or dict of
        them), so that the work that made them is inside it."""
        if sync_value is not None:
            _sync(sync_value)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def avg(self):
        return sum(self.times) / max(len(self.times), 1)

    @property
    def min(self):
        return min(self.times) if self.times else 0.0

    @property
    def max(self):
        return max(self.times) if self.times else 0.0

    def print_summary(self):
        print(
            f"{self.name}: avg {1e3 * self.avg:.3f} ms, "
            f"min {1e3 * self.min:.3f} ms, max {1e3 * self.max:.3f} ms "
            f"({len(self.times)} samples)"
        )
