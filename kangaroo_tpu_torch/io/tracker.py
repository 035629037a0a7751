"""Streaming tracker-pose input (``kangaroo_tpu/io/tracker.py``).

Capability-equivalent of extra/Tracking.h (:9-125 — base class with pose
callbacks, workspace bounds, history, offset), extra/ViconFileTracking.h
(file playback on a background thread) and the live-SDK role of
extra/ViconTracker.h. No mocap SDK exists here, so the live source is any
Python callable/iterable feeding :meth:`Tracking.tracking_event` — a TCP
reader, a ROS subscriber, or the bundled file player. A host stream:
poses are float32 NumPy (3, 4) and never touch the card; the offset is
composed in float32 in ``core.se3.compose``'s order.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, List, Optional

import numpy as np

# callback(T_wf (3,4), system_time_s, device_time_s)
TrackingDataCallback = Callable[[np.ndarray, float, float], None]


def cart2t(vec) -> np.ndarray:
    """(x, y, z, roll, pitch, yaw) -> (3, 4) [R|t] (SceneGraph GLCart2T
    convention used by ViconFileTracking.h:54)."""
    x, y, z, r, p, q = [float(v) for v in vec]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cq, sq = np.cos(q), np.sin(q)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cq, -sq, 0], [sq, cq, 0], [0, 0, 1]])
    R = Rz @ Ry @ Rx
    return np.concatenate([R, [[x], [y], [z]]], axis=1).astype(np.float32)


def _compose(T_cb: np.ndarray, T_ba: np.ndarray) -> np.ndarray:
    """T_ca = T_cb * T_ba in float32 (``core.se3.compose`` on the host)."""
    R = T_cb[:, :3] @ T_ba[:, :3]
    t = T_cb[:, :3] @ T_ba[:, 3:] + T_cb[:, 3:]
    return np.concatenate([R, t], axis=1)


class Tracking:
    """Pose-stream base class (Tracking.h:9-125): latest pose, new-data
    flag, registered callback, workspace AABB of visited positions, optional
    history recording, and a rigid offset applied to every sample."""

    def __init__(self):
        self.connected = False
        self._newdata = False
        self.record_history = False
        self.history: List[np.ndarray] = []
        self._T_offset = np.eye(3, 4, dtype=np.float32)
        self._T_wf = np.eye(3, 4, dtype=np.float32)
        self._callback: Optional[TrackingDataCallback] = None
        self._lock = threading.Lock()
        self.workspace_reset()

    # --- Tracking.h public surface --------------------------------------
    def T_wf(self) -> np.ndarray:
        """Latest pose; clears the new-data flag (Tracking.h:19-23)."""
        with self._lock:
            self._newdata = False
            return self._T_wf.copy()

    def register_tracking_callback(self, cb: TrackingDataCallback) -> None:
        self._callback = cb

    def workspace_reset(self) -> None:
        self.workspace_min = np.full(3, +1e6)
        self.workspace_max = np.full(3, -1e6)

    def workspace_size(self) -> np.ndarray:
        return self.workspace_max - self.workspace_min

    def is_connected(self) -> bool:
        return self.connected

    def is_new_data(self) -> bool:
        return self._newdata

    def toggle_record_history(self) -> None:
        self.record_history = not self.record_history

    def clear_history(self) -> None:
        self.history = []

    def set_offset(self, T_offset) -> None:
        self._T_offset = np.asarray(T_offset, np.float32)

    # --- feed point (TrackingEvent, Tracking.h:83-101) -------------------
    def tracking_event(self, T_wf, system_time_s: float = 0.0,
                       dev_time_s: float = 0.0) -> None:
        T = _compose(self._T_offset, np.asarray(T_wf, np.float32))
        with self._lock:
            self._T_wf = T
            self.connected = True
            self._newdata = True
            t = T[:, 3]
            self.workspace_min = np.minimum(self.workspace_min, t)
            self.workspace_max = np.maximum(self.workspace_max, t)
            if self.record_history:
                self.history.append(T)
        if self._callback is not None:
            self._callback(T, system_time_s, dev_time_s)


class StreamTracking(Tracking):
    """Live tracker: consumes any iterable of (T_wf, sys_time, dev_time)
    tuples (or bare (3,4) poses) on a background thread — the SDK-agnostic
    replacement for ViconTracker.h's event loop."""

    def __init__(self, source: Optional[Iterable] = None):
        super().__init__()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if source is not None:
            self.start(source)

    def start(self, source: Iterable) -> None:
        self._stop.clear()

        def loop():
            for item in source:
                if self._stop.is_set():
                    break
                if isinstance(item, tuple) and len(item) == 3:
                    T, ts, td = item
                else:
                    T, ts, td = item, time.time(), 0.0
                self.tracking_event(T, ts, td)
            self.connected = False

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Abort the stream (ViconTracking::~: stop + join)."""
        self._stop.set()
        self.join()

    def join(self) -> None:
        """Wait for the source to drain without aborting it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class FileTracking(StreamTracking):
    """Vicon file playback (ViconFileTracking.h:1-100): reads
    ``<dir>/vicon.txt`` lines of ``sys_time, dev_time, x, y, z, r, p, q``
    (comma separated) and replays them through the Tracking interface, in
    real time (device-timestamp pacing) or as fast as possible."""

    def __init__(self, base_dir: str = None, path: str = None,
                 realtime: bool = False, autostart: bool = True):
        self.samples = []
        p = path or (base_dir.rstrip("/") + "/vicon.txt")
        self._read_file(p)
        self._realtime = realtime
        source = self._replay()
        super().__init__(source if autostart else None)
        if not autostart:
            self._pending = source

    def _read_file(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                vals = [float(v) for v in line.replace(",", " ").split()]
                if len(vals) >= 8:
                    ts, td = vals[0], vals[1]
                    self.samples.append((cart2t(vals[2:8]), ts, td))

    def _replay(self):
        prev_td = None
        for T, ts, td in self.samples:
            if self._realtime and prev_td is not None and td > prev_td:
                time.sleep(min(td - prev_td, 1.0))
            prev_td = td
            yield T, ts, td
