"""Profiling helpers (``kangaroo_tpu/utils/profiling.py``).

The equivalent of the reference's CudaTimer-based instrumentation and
memory prints: a ``torch.profiler`` trace written as a Chrome trace, and a
device-memory report in place of the apps' cudaMemGetInfo prints
(stereo/main.cpp:30-31,189-190).

The program's own spans: ``span`` (a context manager) and ``spanned`` (the
decorator form) mark the layer boundaries of the stereo paths, from the
entry points down to the kernels' C entries (``LAYERS``). A span is on
exactly while a ``torch.profiler`` records: off, it costs one flag test and
records nothing. On, it opens a ``record_function`` range named
``roo:<name>``, so that every profile (``trace``'s Chrome trace among them)
names the program's stages, and keeps the span in memory (``spans``) with
its host start and end on the profiler's clock (``time.time_ns``) and, where
CUDA is initialised, a pair of timing events on the current stream, resolved
to device milliseconds only when the spans are read.

The kernels' launch counters stay the module attributes that the wrappers
increment; ``counts`` and ``reset_counts`` read and zero them by name.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import itertools
import os
import socket
import tempfile
import threading
import time

import torch

PACKAGE = "kangaroo_tpu_torch"
PREFIX = "roo:"
# the layers a span marks, from the entry points down (PERF.md section 3):
# the apps' entry points, the plain stages, the dispatch and kernel wrappers,
# and a kernel's C entry
LAYERS = ("entry", "stage", "dispatch", "kernel")
# spans kept until they are cleared; later ones are dropped and counted
MAX_SPANS = 1 << 16
# kernel -> (module under the package, attribute) of its launch counter
COUNTERS = {
    "sgm": ("stereo.sgm_cuda", "launches"),
    "sgm_8path": ("stereo.sgm_cuda", "diagonal_launches"),
    "sgm_segment": ("stereo.sgm_cuda", "segment_launches"),
    "sgm_diag_segment": ("stereo.sgm_cuda", "diag_segment_launches"),
    "wta": ("stereo.wta_cuda", "launches"),
    "median": ("ops.median_cuda", "launches"),
    "lr_check": ("stereo.lr_cuda", "launches"),
    "rof": ("variational.solvers_cuda", "rof_launches"),
    "tgv": ("variational.solvers_cuda", "tgv_launches"),
    "wta_sq": ("stereo.wta_cuda", "sq_launches"),
    "dtam": ("stereo.dtam_cuda", "launches"),
    "separable_fuse": ("fusion.separable_cuda", "launches"),
    "cost_volume_add": ("stereo.costvolume_cuda", "launches"),
    "census": ("stereo.census_cuda", "launches"),
    "census_volume": ("stereo.census_cuda", "volume_launches"),
}

# true while a torch.profiler records (torch's own flag, a C call)
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when a
    card is present) and write its Chrome trace (Perfetto,
    chrome://tracing) as ``<host>.<pid>.<ns>.pt.trace.json`` into
    ``logdir`` (default: ``kangaroo_trace`` in the temporary directory),
    even when the block raises. Yields ``logdir``. The spans kept before
    are cleared; ``spans()`` afterwards returns the block's."""
    from torch.profiler import ProfilerActivity, profile

    clear_spans()
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


class Span:
    """A finished span: ``name`` and ``layer``; its ``id``, its parent's
    (None for a root) and its ``request`` (the root's id, shared by every
    span under it); host start and end in ns on the profiler's clock, and
    ``child_ns``, the host time its direct children cover."""

    __slots__ = ("name", "layer", "id", "parent", "request", "start_ns", "end_ns", "child_ns",
                 "_events", "_device_ms")

    def __init__(self, name, layer, id, parent, request, events):
        self.name, self.layer, self.id, self.parent, self.request = (name, layer, id, parent,
                                                                    request)
        self.start_ns = self.end_ns = None
        self.child_ns = 0
        self._events, self._device_ms = events, None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def self_ms(self) -> float:
        """Host time not covered by a child span."""
        return (self.end_ns - self.start_ns - self.child_ns) * 1e-6

    @property
    def device_ms(self) -> float | None:
        """Milliseconds between the span's events on its stream (None where
        it recorded none: CUDA not initialised). Waits for the end event
        the first time it is read."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms, self._events = start.elapsed_time(end), None
        return self._device_ms

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.layer!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, host_ms={self.host_ms:.4f})")


_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_store: list[Span] = []
_dropped = 0


def _stack() -> list[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _layer(layer: str) -> str:
    if layer not in LAYERS:
        raise ValueError(f"span layer must be one of {LAYERS}, got {layer!r}")
    return layer


def _path(fn) -> str:
    """``fn``'s module path under the package, e.g.
    ``stereo.costvolume.cost_volume_add``."""
    module = fn.__module__.removeprefix(PACKAGE + ".")
    return f"{module}.{fn.__qualname__}"


class _Open:
    """The context of a span that records."""

    __slots__ = ("name", "layer", "span", "_range")

    def __init__(self, name: str, layer: str):
        self.name, self.layer = name, _layer(layer)

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        sid = next(_ids)
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        span = self.span = Span(self.name, self.layer, sid, parent.id if parent else None,
                                parent.request if parent else sid, events)
        self._range = torch.autograd.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        # the host stamps follow the range's own, which the profiler takes
        # inside the C++ calls: each lies a return path from its boundary
        span.start_ns = time.time_ns()
        if events is not None:
            events[0].record()
        stack.append(span)
        return span

    def __exit__(self, *exc):
        global _dropped
        span = self.span
        if span._events is not None:
            span._events[1].record()
        self._range.__exit__(*exc)
        span.end_ns = time.time_ns()
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += span.end_ns - span.start_ns
        with _lock:
            if len(_store) < MAX_SPANS:
                _store.append(span)
            else:
                _dropped += 1
        return False


def span(name, layer: str):
    """A context manager marking one layer boundary: ``name`` (a string, or
    a function named by its module path) in ``layer`` (one of ``LAYERS``).
    Without a profiler recording it is a shared no-op context."""
    if not _recording():
        return _OFF
    return _Open(name if isinstance(name, str) else _path(name), layer)


def spanned(layer: str):
    """Decorator: each call of the function inside a span of ``layer``
    named by the function's module path."""
    _layer(layer)

    def wrap(fn):
        name = _path(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _Open(name, layer):
                return fn(*args, **kwargs)
        return call
    return wrap


def spans() -> list[Span]:
    """The finished spans, in the order they ended (not cleared)."""
    with _lock:
        return list(_store)


def spans_dropped() -> int:
    """Spans dropped since the last ``clear_spans`` because the store held
    ``MAX_SPANS``."""
    return _dropped


def clear_spans() -> None:
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0


def counts() -> dict[str, int]:
    """Each kernel's launch counter (``COUNTERS``) by its name."""
    return {k: getattr(importlib.import_module(f"{PACKAGE}.{mod}"), attr)
            for k, (mod, attr) in COUNTERS.items()}


def reset_counts() -> None:
    """Zero every launch counter."""
    for mod, attr in COUNTERS.values():
        setattr(importlib.import_module(f"{PACKAGE}.{mod}"), attr, 0)


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
