"""The plane-sweep TSDF fuse kernel (``csrc/separable_fuse.cu``) and its wrapper.

Counterpart of ``kangaroo_tpu/fusion/separable_pallas.py``
(``_make_fuse_kernel``, ``fuse_planes_pallas``): one launch updates every
voxel of the plane window in place on the current stream, reading the
20 params, the enable gate and the window from device tensors, so the
fuse adds no host round trip. A block takes a tile of a plane (or 32
planes on the x sweep) with the plane geometry in shared-memory tables
(``kt_separable_fuse``). The plain version is
``separable.fuse_planes_plain``. The kernel has no gradient of its own, so
this wrapper refuses an input that requires grad rather than cut it from
the graph; ``separable.sdf_fuse_separable`` differentiates the fuse with an
autograd op whose forward launches this kernel on copies of the volume and
whose backward is the plain loop's (``separable.fuse_planes_plain_grad``).
"""
from __future__ import annotations

import torch

from .. import _build, backend
from ..utils import profiling
from .separable import N_PARAMS, sweep_shape

# fuse kernel launches since the last reset (one per fuse)
launches = 0


def _fuse(entry: str, val: torch.Tensor, weight: torch.Tensor, gmd: torch.Tensor,
          gct: torch.Tensor, params: torch.Tensor, window: torch.Tensor, axis: int, Wi: int,
          Hi: int):
    for name, t, ndim in (("val", val, 3), ("weight", weight, 3), ("gmd", gmd, 2),
                          ("gct", gct, 2), ("params", params, 1)):
        backend.require_kernels(t, "separable_fuse")
        backend.check_tensor(t, name, (torch.float32,), ndim)
        if t.requires_grad:
            raise RuntimeError(f"separable_fuse: the kernel has no gradient; {name} "
                               "requires grad")
    backend.check_tensor(window, "window", (torch.int32,), 1)
    if weight.shape != val.shape or gct.shape != gmd.shape:
        raise ValueError(f"weight {tuple(weight.shape)} / gct {tuple(gct.shape)} do not match "
                         f"val {tuple(val.shape)} / gmd {tuple(gmd.shape)}")
    if params.numel() != N_PARAMS or window.numel() != 2:
        raise ValueError(f"params must hold {N_PARAMS} floats and window 2 ints, got "
                         f"{params.numel()} and {window.numel()}")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    if any(t.device != val.device for t in (weight, gmd, gct, params, window)):
        raise ValueError("separable_fuse: every tensor must be on val's device")
    if min(sweep_shape(val.shape, axis)) < 1 or min(gmd.shape) < 2:
        raise ValueError(f"separable_fuse: empty volume {tuple(val.shape)} or grid "
                         f"{tuple(gmd.shape)}")
    D, H, W = val.shape
    gh, gw = gmd.shape
    lib = _build.library()
    with torch.cuda.device(val.device):
        backend.launch(getattr(lib, entry), val.data_ptr(), weight.data_ptr(), gmd.data_ptr(),
                       gct.data_ptr(), params.data_ptr(), window.data_ptr(), D, H, W, int(axis),
                       gh, gw, int(Wi), int(Hi), backend.stream_handle(val),
                       op="separable_fuse")
    return val, weight


@profiling.spanned("dispatch")
def fuse_planes(val: torch.Tensor, weight: torch.Tensor, gmd: torch.Tensor, gct: torch.Tensor,
                params: torch.Tensor, window: torch.Tensor, axis: int, Wi: int, Hi: int):
    """Fuse in place on the card: val, weight (D, H, W) float32 [z, y, x];
    gmd, gct (gh, gw) float32 warped grids; params (20,) float32; window (2,)
    int32 planes [k_lo, k_hi) of the sweep along ``axis`` (0 z, 1 y, 2 x)."""
    global launches
    out = _fuse("kt_separable_fuse", val, weight, gmd, gct, params, window, axis, Wi, Hi)
    launches += 1
    return out


def _fuse_planes_voxel(val, weight, gmd, gct, params, window, axis: int, Wi: int, Hi: int):
    """``fuse_planes`` through ``kt_separable_fuse_voxel`` (the design it
    replaced: one thread a voxel over the whole volume): the yardstick that
    the card checks hold ``kt_separable_fuse`` against. No path calls it and
    no count records it."""
    return _fuse("kt_separable_fuse_voxel", val, weight, gmd, gct, params, window, axis, Wi, Hi)
