"""Threaded native frame loader for PXM image sequences
(``kangaroo_tpu/io/frame_loader.py``).

Python front end of ``native/frame_loader.cpp``, the runtime equivalent of
the reference's HAL camera input (extra/RpgCameraOpen.h; the apps'
per-frame video.Capture + CopyFrom, kinectfusion/main.cpp:196-208). Disk IO
and decoding run in C++ worker threads feeding a bounded ring buffer, so
the device pipeline does not wait on input. The core is built with g++ at
first use (``_build.host_library``); a failed build raises with g++'s
output. Nothing falls back to NumPy on its own: ``use_native=False`` asks
for the NumPy reader (``io/pxm.py``).
"""
from __future__ import annotations

import ctypes
from typing import Iterator, Sequence

import numpy as np

from .. import _build
from . import pxm

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)


def native_library() -> ctypes.CDLL:
    """The loader's core, built on first call; raises if g++ fails."""
    lib = _build.host_library("frame_loader")
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int64]
    lib.fl_next.restype = ctypes.c_int
    lib.fl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_U8P), _I64P, _I64P, _I64P, _I64P,
                            _I64P]
    lib.fl_free.restype = None
    lib.fl_free.argtypes = [_U8P]
    lib.fl_close.restype = None
    lib.fl_close.argtypes = [ctypes.c_void_p]
    return lib


class FrameLoader:
    """Iterate ``(index, frame)`` over a PXM sequence: uint8 (H, W) or
    (H, W, 3) frames, 16-bit files as native-endian uint16. A file that
    cannot be read or decoded is skipped, on either reader.

    With one worker (the default) frames arrive in sequence order, still
    decoded ahead of the caller; more workers trade order for throughput
    (each frame carries its index). ``capacity`` bounds the decoded frames
    held ahead. ``use_native`` None or True builds the C++ core or raises;
    False reads with NumPy on the calling thread, in order.
    """

    def __init__(self, paths: Sequence[str], n_threads: int = 1, capacity: int = 4,
                 use_native: bool | None = None):
        if n_threads < 1 or capacity < 1:
            raise ValueError(f"n_threads and capacity must be >= 1, got {n_threads}, {capacity}")
        self.paths = [str(p) for p in paths]
        self.n_threads = n_threads
        self.capacity = capacity
        self._lib = native_library() if use_native in (None, True) else None

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        if self._lib is None:
            for i, p in enumerate(self.paths):
                try:
                    img = pxm.load_pxm(p)
                except (OSError, ValueError):  # unreadable or truncated: skip, as the core does
                    continue
                yield i, img
            return

        lib = self._lib
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        handle = lib.fl_open(arr, len(self.paths), self.n_threads, self.capacity)
        try:
            sentinels = 0
            while sentinels < self.n_threads:
                data = _U8P()
                w, h, c, bps, idx = (ctypes.c_int64() for _ in range(5))
                rc = lib.fl_next(handle, ctypes.byref(data), ctypes.byref(w), ctypes.byref(h),
                                 ctypes.byref(c), ctypes.byref(bps), ctypes.byref(idx))
                if rc == 0:  # a worker's end of stream
                    sentinels += 1
                    continue
                if rc < 0:  # unreadable file: skip
                    lib.fl_free(data)
                    continue
                n = w.value * h.value * c.value * bps.value
                buf = np.ctypeslib.as_array(data, shape=(n,)).copy()
                lib.fl_free(data)
                img = buf.view(">u2").astype(np.uint16) if bps.value == 2 else buf
                shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
                yield idx.value, img.reshape(shape)
        finally:
            lib.fl_close(handle)
