"""TSDF volumes (``kangaroo_tpu/containers/volume.py``, ``TsdfVolume``).

Voxel data is a ``(D, H, W)`` float32 tensor indexed ``[z, y, x]``; the
signed distance and the weight are two planar tensors, with the world-space
box beside them. Ported: ``create``, ``reset``, ``voxel_size_units``,
``voxel_positions``, ``sample_trilinear_world`` and ``grad_backward_world``.
``BoundedVolume`` (the colour volume), ``sub_volume`` and
``with_sub_volume`` wait for the colour and rolling-workspace paths.
"""
from __future__ import annotations

import dataclasses

import torch

from ..backend import constant
from .bbox import BoundingBox


def _counts(shape, device) -> torch.Tensor:
    """(W - 1, H - 1, D - 1) as float32: voxel steps along (x, y, z)."""
    D, H, W = shape[:3]
    return constant((W - 1, H - 1, D - 1), device=device)


def _index(f: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """floor(f) clamped to [lo, hi] as an index; a NaN converts to 0, as
    XLA's float-to-int does."""
    return torch.clamp(torch.floor(f), lo, hi).nan_to_num(0.0).long()


def _trilinear_gather(data: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """Trilinear sample at voxel coordinates ``pf`` (..., 3) ordered (x, y, z):
    base indices clamped to [0, n - 2], fractions relative to the clamped
    base (Volume::GetFractionalTrilinearClamped)."""
    D, H, W = data.shape[:3]
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]
    ix, iy, iz = (_index(f, lo, n - 2) for f, lo, n in ((fx, 0, W), (fy, 0, H), (fz, 0, D)))
    gx, gy, gz = fx - ix, fy - iy, fz - iz

    def at(dz, dy, dx):
        return data[iz + dz, iy + dy, ix + dx].to(torch.float32)

    c00 = at(0, 0, 0) * (1 - gx) + at(0, 0, 1) * gx
    c01 = at(0, 1, 0) * (1 - gx) + at(0, 1, 1) * gx
    c10 = at(1, 0, 0) * (1 - gx) + at(1, 0, 1) * gx
    c11 = at(1, 1, 0) * (1 - gx) + at(1, 1, 1) * gx
    c0 = c00 * (1 - gy) + c01 * gy
    c1 = c10 * (1 - gy) + c11 * gy
    return c0 * (1 - gz) + c1 * gz


@dataclasses.dataclass
class TsdfVolume:
    """Truncated signed-distance volume: planar (val, weight) + bounds."""

    val: torch.Tensor  # (D, H, W) float32 signed distance
    weight: torch.Tensor  # (D, H, W) float32 accumulation weight
    bbox: BoundingBox

    @classmethod
    def create(cls, w: int, h: int, d: int, bbox: BoundingBox | None = None,
               trunc_dist=1.0, device=None) -> "TsdfVolume":
        """Allocates in the SdfReset state: val = trunc_dist, weight = 0, on
        ``device`` (default: the box's, the card for a default box)."""
        if bbox is None:
            bbox = BoundingBox.create(device=device or "cuda")
        device = device or bbox.device
        return cls(torch.full((d, h, w), float(trunc_dist), dtype=torch.float32, device=device),
                   torch.zeros((d, h, w), dtype=torch.float32, device=device), bbox)

    def reset(self, trunc_dist) -> "TsdfVolume":
        return TsdfVolume(torch.full_like(self.val, float(trunc_dist)),
                          torch.zeros_like(self.weight), self.bbox)

    def voxel_size_units(self) -> torch.Tensor:
        return self.bbox.size() / _counts(self.val.shape, self.val.device)

    def _world_to_voxel(self, pos_w: torch.Tensor) -> torch.Tensor:
        frac = (pos_w - self.bbox.lo) / self.bbox.size()
        return frac * _counts(self.val.shape, self.val.device)

    def voxel_positions(self) -> torch.Tensor:
        """World position of every voxel centre -> (D, H, W, 3)."""
        dev = self.val.device
        z, y, x = torch.meshgrid(*(torch.arange(n, dtype=torch.float32, device=dev)
                                   for n in self.val.shape), indexing="ij")
        frac = torch.stack([x, y, z], dim=-1) / _counts(self.val.shape, dev)
        return self.bbox.lo + frac * self.bbox.size()

    def sample_trilinear_world(self, pos_w: torch.Tensor) -> torch.Tensor:
        """GetUnitsTrilinearClamped."""
        return _trilinear_gather(self.val, self._world_to_voxel(pos_w))

    def grad_backward_world(self, pos_w: torch.Tensor) -> torch.Tensor:
        """Trilinearly interpolated backward differences, base index clamped
        to [1, n - 2], over the voxel size (GetUnitsBackwardDiffDxDyDz)."""
        data = self.val.to(torch.float32)
        pf = self._world_to_voxel(pos_w)
        D, H, W = data.shape
        fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]
        ix, iy, iz = (_index(f, 1, n - 2) for f, n in ((fx, W), (fy, H), (fz, D)))
        gx, gy, gz = ((fx - ix)[..., None], (fy - iy)[..., None], (fz - iz)[..., None])

        def bdiff(dz, dy, dx):
            z, y, x = iz + dz, iy + dy, ix + dx
            v0 = data[z, y, x]
            return torch.stack([v0 - data[z, y, x - 1], v0 - data[z, y - 1, x],
                                v0 - data[z - 1, y, x]], dim=-1)

        c00 = bdiff(0, 0, 0) * (1 - gx) + bdiff(0, 0, 1) * gx
        c01 = bdiff(0, 1, 0) * (1 - gx) + bdiff(0, 1, 1) * gx
        c10 = bdiff(1, 0, 0) * (1 - gx) + bdiff(1, 0, 1) * gx
        c11 = bdiff(1, 1, 0) * (1 - gx) + bdiff(1, 1, 1) * gx
        c0 = c00 * (1 - gy) + c01 * gy
        c1 = c10 * (1 - gy) + c11 * gy
        return (c0 * (1 - gz) + c1 * gz) / self.voxel_size_units()
