"""The traced run: ranges around the program's layers, ``torch.profiler``
over the traced units, and the reduction of its events to what the
per-layer readers read.

The ranges are opened by this benchmark, not by the program: for the run's
length the module attributes that the readers name (``RANGES`` of each
metric file, label -> ``"module:attribute"`` under the program's package)
are replaced by wrappers that open a ``record_function`` range named
``portbench:<label>`` around the call, and put back afterwards. The program
looks the attributes up at call time, so every call inside the window goes
through the wrapper; the program's files are not touched.

Each device operation (kernel, copy, fill) is put in the range that was
open on the host when it was launched, found through the CUDA runtime call
that launched it. An idle stretch of the device is put in the range the host
was in at its middle.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
from dataclasses import dataclass, field

import torch

PACKAGE = "kangaroo_tpu_torch"
PREFIX = "portbench:"
HARNESS = "harness"  # the host outside every range: the loop, synchronising


@contextlib.contextmanager
def ranges(targets: dict[str, str]):
    """Wrap each ``"module:attribute"`` of ``targets`` (label -> target) in a
    range named after its label, for the length of the block."""
    saved = []
    try:
        for label, target in sorted(targets.items()):
            mod_name, attr = target.split(":")
            mod = importlib.import_module(f"{PACKAGE}.{mod_name}")
            orig = getattr(mod, attr)

            @functools.wraps(orig)
            def wrapper(*args, __orig=orig, __name=PREFIX + label, **kwargs):
                with torch.profiler.record_function(__name):
                    return __orig(*args, **kwargs)

            setattr(mod, attr, wrapper)
            saved.append((mod, attr, orig))
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def profiler():
    """``torch.profiler`` over the host and the card, nothing written out."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False,
                                  profile_memory=False)


@dataclass
class Trace:
    """The traced units, reduced. Times in seconds."""

    window_s: float  # the traced units, from their range on the profiler's clock
    frames: int  # frames completed in them
    busy_s: float = 0.0  # union of device activity inside the window
    ops: list = field(default_factory=list)  # (name, seconds, range label or None, is kernel)
    calls: dict = field(default_factory=dict)  # range label -> calls
    idle: dict = field(default_factory=dict)  # what the host was doing -> idle seconds

    def device_s(self, labels) -> float:
        """Device seconds of the operations launched inside ``labels``."""
        return sum(sec for _, sec, rng, _ in self.ops if rng in labels)

    @property
    def kernels(self) -> int:
        return sum(1 for *_, is_kernel in self.ops if is_kernel)

    def breakdown(self, n: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for name, sec, _, _ in self.ops:
            by_name[name] = by_name.get(name, 0.0) + sec
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _kind(ev) -> str:
    """The event's activity type where this PyTorch reports one."""
    get = getattr(ev, "activity_type", None)
    return (get() or "").lower() if get else ""


def _is_device(ev) -> bool:
    """Of the card's events, a kernel, copy or fill (not the card's copy of
    a range)."""
    return (not ev.is_user_annotation() and "annotation" not in _kind(ev)
            and not ev.name().startswith(PREFIX))


def _is_kernel(ev) -> bool:
    kind = _kind(ev)
    if kind:
        return "kernel" in kind
    return not ev.name().startswith(("Memcpy", "Memset"))


def reduce(prof, window_label: str, trace: Trace) -> Trace:
    """Fill ``trace`` from the profiler's events. ``window_label`` is the
    range around the traced units; only device work inside it counts."""
    events = prof.profiler.kineto_results.events()
    spans = []  # (start, end, label) of this benchmark's ranges
    window = None
    launch = {}  # CUPTI correlation id -> host time of the runtime call
    device = []
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if _is_device(ev):
                device.append(ev)
            continue
        name = ev.name()
        if name.startswith(PREFIX):
            label = name[len(PREFIX):]
            if label == window_label:
                window = (ev.start_ns(), ev.end_ns())
            else:
                spans.append((ev.start_ns(), ev.end_ns(), label))
        elif name.startswith("cu"):  # cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync ...
            launch[ev.correlation_id()] = ev.start_ns()
    if window is None:
        raise RuntimeError(f"the profile holds no {PREFIX}{window_label} range")
    w0, w1 = window
    trace.window_s = (w1 - w0) * 1e-9
    spans.sort()
    # ranges nest: put each span on the first level where it overlaps none,
    # so that a level's spans are disjoint and sorted, the outer ones first
    levels: list[list] = []
    for span in spans:
        for lvl in levels:
            if lvl[-1][1] <= span[0]:
                lvl.append(span)
                break
        else:
            levels.append([span])
    starts = [[s for s, _, _ in lvl] for lvl in levels]

    def range_at(t):
        """The innermost range open on the host at time t."""
        for lvl, st in zip(reversed(levels), reversed(starts)):
            i = bisect.bisect_right(st, t) - 1
            if i >= 0 and lvl[i][1] >= t:
                return lvl[i][2]
        return None

    for s, e, label in spans:
        if w0 <= s <= w1:
            trace.calls[label] = trace.calls.get(label, 0) + 1
    intervals = []
    for ev in device:
        s, e = ev.start_ns(), ev.end_ns()
        if e <= w0 or s >= w1:
            continue
        host = launch.get(ev.correlation_id())
        rng = range_at(host) if host is not None else None
        trace.ops.append((ev.name(), (e - s) * 1e-9, rng, _is_kernel(ev)))
        intervals.append((max(s, w0), min(e, w1)))
    intervals.sort()
    busy = 0
    cur_s = cur_e = None
    gaps = []
    last = w0
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last:
                gaps.append((last, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last = max(last, cur_e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last:
        gaps.append((last, w1))
    trace.busy_s = busy * 1e-9
    for s, e in gaps:
        who = range_at((s + e) // 2) or HARNESS
        trace.idle[who] = trace.idle.get(who, 0.0) + (e - s) * 1e-9
    return trace
