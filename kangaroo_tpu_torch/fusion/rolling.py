"""The moving workspace (``kangaroo_tpu/fusion/rolling.py``): one dense
volume that rolls by whole voxels when the camera strays from its centre.

A roll shifts the data along each axis (``torch.roll``), resets the vacated
slabs and translates the box by the shift times the voxel size, computed in
float32 on the device. The TSDF and its colour volume roll through the same
code, so the two stay in step. ``recenter_shift`` is a host helper: one
host read of the pose and the box a frame.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..backend import constant
from ..containers.bbox import BoundingBox
from ..containers.volume import BoundedVolume, TsdfVolume


def _roll_plane(data: torch.Tensor, shift_xyz, reset_val) -> torch.Tensor:
    """Roll one [z, y, x] voxel grid by whole voxels along world (x, y, z),
    resetting the vacated slabs to ``reset_val``: shifting the window by +s
    moves the content by -s inside the array."""
    for axis, s in ((2, int(shift_xyz[0])), (1, int(shift_xyz[1])), (0, int(shift_xyz[2]))):
        if s == 0:
            continue
        n = data.shape[axis]
        data = torch.roll(data, -s, dims=axis)
        idx = torch.arange(n, device=data.device)
        vacated = (idx >= n - s) if s > 0 else (idx < -s)
        shape = [1, 1, 1]
        shape[axis] = n
        data = torch.where(vacated.reshape(shape), reset_val, data)
    return data


def _rolled_bbox(bbox: BoundingBox, shift_xyz, step: torch.Tensor) -> BoundingBox:
    offset = step * constant(tuple(float(int(s)) for s in shift_xyz), device=step.device)
    return BoundingBox(bbox.lo + offset, bbox.hi + offset)


def roll_volume(vol: TsdfVolume, shift_xyz, reset_val=float("nan")) -> TsdfVolume:
    """Shift the volume ``shift_xyz`` voxels along world (x, y, z): geometry
    stays put in world space (the box translates), the freshly exposed slabs
    reset to (reset_val, weight 0)."""
    return TsdfVolume(_roll_plane(vol.val, shift_xyz, reset_val),
                      _roll_plane(vol.weight, shift_xyz, 0.0),
                      _rolled_bbox(vol.bbox, shift_xyz, vol.voxel_size_units()))


def roll_bounded_volume(bv: BoundedVolume, shift_xyz, reset_val=0.5) -> BoundedVolume:
    """Roll a BoundedVolume (the colour volume) by the same shift as its
    TSDF; the vacated slabs reset to ``reset_val`` (SdfReset fills the
    colour volume with 0.5)."""
    return BoundedVolume(_roll_plane(bv.data, shift_xyz, reset_val),
                         _rolled_bbox(bv.bbox, shift_xyz, bv.voxel_size_units()))


def recenter_shift(vol: TsdfVolume, T_wc, lead: float = 0.5,
                   threshold_voxels: int = 8) -> Tuple[int, int, int]:
    """Whole-voxel shift that re-centres the volume on the point ``lead``
    metres in front of the camera; zero on an axis until the drift there
    reaches ``threshold_voxels`` (hysteresis). Returns plain ints. ``T_wc``
    must be a (3, 4) pose. ``vol`` may be any volume with a box and a voxel
    size (a ``parallel.sharding.ZSlabs`` too)."""
    T_wc = torch.as_tensor(T_wc, dtype=torch.float32, device=vol.bbox.device)
    if tuple(T_wc.shape) != (3, 4):
        raise ValueError(f"recenter_shift: T_wc must be a (3, 4) pose, not {tuple(T_wc.shape)}")
    host = torch.cat([T_wc.reshape(-1), vol.bbox.lo + vol.bbox.hi,
                      vol.voxel_size_units()]).cpu().numpy()  # the one host read
    T, lo_hi, step = host[:12].reshape(3, 4), host[12:15], host[15:18]
    target = T[:, 3] + T[:, 2] * np.float32(lead)  # camera centre + lead * view direction
    centre = lo_hi / np.float32(2.0)
    drift = np.round((target - centre) / step).astype(int)
    drift[np.abs(drift) < threshold_voxels] = 0
    return int(drift[0]), int(drift[1]), int(drift[2])


def follow_camera(vol: TsdfVolume, T_wc, lead: float = 0.5, threshold_voxels: int = 8,
                  reset_val=float("nan")) -> TsdfVolume:
    """Keep the working volume around the camera: roll by the recentring
    shift, if any (``vol`` itself when there is none)."""
    shift = recenter_shift(vol, T_wc, lead, threshold_voxels)
    if shift == (0, 0, 0):
        return vol
    return roll_volume(vol, shift, reset_val)
