"""Bounded volumes (``kangaroo_tpu/containers/volume.py``): ``BoundedVolume``
(a scalar grid, e.g. the colour volume) and ``TsdfVolume``.

Voxel data is a ``(D, H, W)`` tensor indexed ``[z, y, x]``; the TSDF keeps
the signed distance and the weight as two planar float32 tensors. The
world-space box rides beside the data. ``sub_volume`` cuts a voxel-aligned
block out (a copy, where the reference returns an aliasing view) and
``with_sub_volume`` writes a processed block back into a copy of the
parent; both read the box on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
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


def voxel_positions(shape, bbox: BoundingBox, z0: int = 0, z1: int | None = None) -> torch.Tensor:
    """World position of every voxel centre of planes [z0, z1) of a volume of
    ``shape`` (D, H, W) -> (z1 - z0, H, W, 3), on the box's device; each
    position is the same float32 arithmetic whatever the plane range."""
    D, H, W = shape[:3]
    dev = bbox.device
    z1 = D if z1 is None else z1
    z, y, x = torch.meshgrid(torch.arange(z0, z1, dtype=torch.float32, device=dev),
                             torch.arange(H, dtype=torch.float32, device=dev),
                             torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    frac = torch.stack([x, y, z], dim=-1) / _counts(shape, dev)
    return bbox.lo + frac * bbox.size()


def _sub_index_box(bbox: BoundingBox, w: int, h: int, d: int, roi: BoundingBox):
    """Voxel index box (inclusive lo and hi per axis, xyz order) covering
    ``roi`` and the bounds' intersection, voxel-aligned outward, and its
    world box; host-side float64, as BoundedVolume::SubBoundingVolume."""
    n = np.array([w - 1, h - 1, d - 1], np.float64)
    blo = bbox.lo.cpu().numpy().astype(np.float64)
    bhi = bbox.hi.cpu().numpy().astype(np.float64)
    step = (bhi - blo) / n
    lo_w = np.maximum(roi.lo.cpu().numpy().astype(np.float64), blo)
    hi_w = np.minimum(roi.hi.cpu().numpy().astype(np.float64), bhi)
    if np.any(hi_w < lo_w):
        raise ValueError("roi does not intersect the volume bounds")
    ilo = np.clip(np.floor((lo_w - blo) / step).astype(np.int64), 0, n.astype(np.int64))
    ihi = np.clip(np.ceil((hi_w - blo) / step).astype(np.int64), 0, n.astype(np.int64))
    ihi = np.maximum(ihi, ilo + 1)  # at least two planes so trilinear works
    return ilo, ihi, BoundingBox.create(blo + ilo * step, blo + ihi * step, device=bbox.device)


def _update_slice(data: torch.Tensor, sub: torch.Tensor, origin) -> torch.Tensor:
    """A copy of ``data`` with ``sub`` written at ``origin`` (z, y, x), the
    start clamped so that the block fits (lax.dynamic_update_slice)."""
    out = data.clone()
    start = [min(max(int(o), 0), n - m) for o, n, m in zip(origin, data.shape, sub.shape)]
    out[tuple(slice(s, s + m) for s, m in zip(start, sub.shape))] = sub
    return out


@dataclasses.dataclass
class BoundedVolume:
    """A scalar voxel grid with world-space bounds."""

    data: torch.Tensor  # (D, H, W), indexed [z, y, x]
    bbox: BoundingBox

    @classmethod
    def create(cls, w: int, h: int, d: int, bbox: BoundingBox | None = None,
               dtype=torch.float32, fill=0.0, device=None) -> "BoundedVolume":
        """A grid filled with ``fill`` on ``device`` (default: the box's, the
        card for a default box)."""
        if bbox is None:
            bbox = BoundingBox.create(device=device or "cuda")
        return cls(torch.full((d, h, w), fill, dtype=dtype, device=device or bbox.device), bbox)

    @property
    def w(self) -> int:
        return self.data.shape[2]

    @property
    def h(self) -> int:
        return self.data.shape[1]

    @property
    def d(self) -> int:
        return self.data.shape[0]

    def size_units(self) -> torch.Tensor:
        return self.bbox.size()

    def voxel_size_units(self) -> torch.Tensor:
        return self.bbox.size() / _counts(self.data.shape, self.data.device)

    def _world_to_voxel(self, pos_w: torch.Tensor) -> torch.Tensor:
        frac = (pos_w - self.bbox.lo) / self.bbox.size()
        return frac * _counts(self.data.shape, self.data.device)

    def voxel_positions(self) -> torch.Tensor:
        """World position of every voxel centre -> (D, H, W, 3)."""
        return voxel_positions(self.data.shape, self.bbox)

    def sample_trilinear_world(self, pos_w: torch.Tensor) -> torch.Tensor:
        """GetUnitsTrilinearClamped."""
        return _trilinear_gather(self.data, self._world_to_voxel(pos_w))

    def grad_backward_world(self, pos_w: torch.Tensor) -> torch.Tensor:
        """Trilinearly interpolated backward differences, base index clamped
        to [1, n - 2], over the voxel size (GetUnitsBackwardDiffDxDyDz)."""
        data = self.data.to(torch.float32)
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

    def image_xy(self, z: int) -> torch.Tensor:
        """z-slice (Volume::ImageXY)."""
        return self.data[z]

    def image_xz(self, y: int) -> torch.Tensor:
        """y-slice (Volume::ImageXZ)."""
        return self.data[:, y, :]

    def sub_volume(self, roi: BoundingBox):
        """The voxel-aligned block covering ``roi`` within the bounds, and its
        (z, y, x) index origin in the parent."""
        (x0, y0, z0), (x1, y1, z1), sub_bbox = _sub_index_box(self.bbox, self.w, self.h, self.d,
                                                              roi)
        return (BoundedVolume(self.data[z0:z1 + 1, y0:y1 + 1, x0:x1 + 1].clone(), sub_bbox),
                (int(z0), int(y0), int(x0)))

    def with_sub_volume(self, sub: "BoundedVolume", origin) -> "BoundedVolume":
        """A copy with ``sub``'s data written back at ``origin``."""
        return BoundedVolume(_update_slice(self.data, sub.data, origin), self.bbox)


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

    @property
    def w(self) -> int:
        return self.val.shape[2]

    @property
    def h(self) -> int:
        return self.val.shape[1]

    @property
    def d(self) -> int:
        return self.val.shape[0]

    def as_bounded(self) -> BoundedVolume:
        return BoundedVolume(self.val, self.bbox)

    def reset(self, trunc_dist) -> "TsdfVolume":
        return TsdfVolume(torch.full_like(self.val, float(trunc_dist)),
                          torch.zeros_like(self.weight), self.bbox)

    def voxel_size_units(self) -> torch.Tensor:
        return self.as_bounded().voxel_size_units()

    def _world_to_voxel(self, pos_w: torch.Tensor) -> torch.Tensor:
        return self.as_bounded()._world_to_voxel(pos_w)

    def voxel_positions(self) -> torch.Tensor:
        return self.as_bounded().voxel_positions()

    def sample_trilinear_world(self, pos_w: torch.Tensor) -> torch.Tensor:
        return self.as_bounded().sample_trilinear_world(pos_w)

    def grad_backward_world(self, pos_w: torch.Tensor) -> torch.Tensor:
        return self.as_bounded().grad_backward_world(pos_w)

    def sub_volume(self, roi: BoundingBox):
        """The voxel-aligned TSDF block covering ``roi`` within the bounds,
        and its (z, y, x) origin; pair with :meth:`with_sub_volume`."""
        (x0, y0, z0), (x1, y1, z1), sub_bbox = _sub_index_box(self.bbox, self.w, self.h, self.d,
                                                              roi)
        sl = (slice(z0, z1 + 1), slice(y0, y1 + 1), slice(x0, x1 + 1))
        return (TsdfVolume(self.val[sl].clone(), self.weight[sl].clone(), sub_bbox),
                (int(z0), int(y0), int(x0)))

    def with_sub_volume(self, sub: "TsdfVolume", origin) -> "TsdfVolume":
        return TsdfVolume(_update_slice(self.val, sub.val, origin),
                          _update_slice(self.weight, sub.weight, origin), self.bbox)
