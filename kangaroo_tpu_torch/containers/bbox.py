"""Axis-aligned bounding boxes in world units (``kangaroo_tpu/containers/bbox.py``).

``lo``/``hi`` are (3,) float32 tensors ordered (x, y, z), on the device of
the volume they bound; every box a method or :func:`fit_to_frustum` makes
lies on its inputs' device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the corners of BoundingBox.empty(): an inverted box that insert() grows from
_BIG = 3.4e38


def _f32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(v, np.float32), device=device)


@dataclasses.dataclass
class BoundingBox:
    lo: torch.Tensor  # (3,) min corner
    hi: torch.Tensor  # (3,) max corner

    @classmethod
    def create(cls, lo=(-1.0, -1.0, -1.0), hi=(1.0, 1.0, 1.0), device="cuda") -> "BoundingBox":
        return cls(_f32(lo, device), _f32(hi, device))

    @classmethod
    def empty(cls, device="cuda") -> "BoundingBox":
        """Inverted box that :meth:`insert` grows from."""
        return cls(torch.full((3,), _BIG, dtype=torch.float32, device=device),
                   torch.full((3,), -_BIG, dtype=torch.float32, device=device))

    @property
    def device(self) -> torch.device:
        return self.lo.device

    def size(self) -> torch.Tensor:
        return self.hi - self.lo

    def half_size(self) -> torch.Tensor:
        return 0.5 * self.size()

    def center(self) -> torch.Tensor:
        return 0.5 * (self.lo + self.hi)

    def insert(self, p) -> "BoundingBox":
        """Grow to include the point(s) p of shape (..., 3)."""
        p = _f32(p, self.device).reshape(-1, 3)
        return BoundingBox(torch.minimum(self.lo, p.amin(0)), torch.maximum(self.hi, p.amax(0)))

    def intersect(self, o: "BoundingBox") -> "BoundingBox":
        return BoundingBox(torch.maximum(self.lo, o.lo), torch.minimum(self.hi, o.hi))

    def enlarge(self, factor) -> "BoundingBox":
        c, h = self.center(), self.half_size()
        return BoundingBox(c - factor * h, c + factor * h)

    def contains(self, p) -> torch.Tensor:
        p = torch.as_tensor(p, device=self.device)
        return ((p >= self.lo) & (p <= self.hi)).all(-1)


def fit_to_frustum(K, w: int, h: int, T_wc: torch.Tensor, near, far) -> BoundingBox:
    """AABB of the camera frustum: the camera centre and the 4 image-corner
    rays at ``near`` and ``far``, in the world frame (on ``T_wc``'s device)."""
    from ..core import se3

    corners = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [0.0, h - 1.0], [w - 1.0, h - 1.0]],
                           dtype=torch.float32, device=T_wc.device)
    rays_c = K.unproject(corners[:, 0], corners[:, 1])  # (4, 3)
    pts_w = se3.transform(T_wc, torch.cat([near * rays_c, far * rays_c], dim=0))
    allpts = torch.cat([pts_w, se3.translation(T_wc)[None]], dim=0)
    return BoundingBox(allpts.amin(0), allpts.amax(0))
