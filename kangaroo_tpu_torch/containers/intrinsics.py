"""Pinhole camera intrinsics (``kangaroo_tpu/containers/intrinsics.py``).

The four parameters are Python floats holding float32 values, as the JAX
package's are float32 scalars: ``create`` rounds them, and ``level``
scales them with float32 arithmetic. Tensors they produce (``matrix``,
``unproject_grid``, ``inverse_matrix``) are made on the device the caller
names, or that of the points they are given. Points are (..., 3) ordered
(x, y, z); pixels (u, v).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..backend import constant, f32_scalars as _f32


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """fu, fv focal lengths; u0, v0 principal point (pixels)."""

    fu: float
    fv: float
    u0: float
    v0: float

    @classmethod
    def create(cls, fu, fv=None, u0=0.0, v0=0.0) -> "Intrinsics":
        if fv is None:
            fv = fu
        return cls(*(float(np.float32(v)) for v in (fu, fv, u0, v0)))

    @classmethod
    def centered(cls, f, w: int, h: int) -> "Intrinsics":
        """Focal f with the principal point at the image centre."""
        return cls.create(f, f, w / 2.0 - 0.5, h / 2.0 - 0.5)

    def level(self, l: int) -> "Intrinsics":
        """Intrinsics of power-of-two pyramid level ``l``, in float32."""
        s, half = np.float32(1.0 / (1 << l)), np.float32(0.5)
        fu, fv, u0, v0 = (np.float32(v) for v in (self.fu, self.fv, self.u0, self.v0))
        return Intrinsics(float(s * fu), float(s * fv), float(s * (u0 + half) - half),
                          float(s * (v0 + half) - half))

    def scale(self, s) -> "Intrinsics":
        """Focal lengths scaled by ``s`` (float32), the principal point kept."""
        s = np.float32(s)
        return Intrinsics(float(np.float32(self.fu) * s), float(np.float32(self.fv) * s),
                          self.u0, self.v0)

    def project(self, P: torch.Tensor) -> torch.Tensor:
        """(..., 3) camera-frame points -> (..., 2) pixels (u, v)."""
        fu, fv = _f32(P.device, self.fu, self.fv)
        z = P[..., 2]
        return torch.stack([self.u0 + fu * P[..., 0] / z, self.v0 + fv * P[..., 1] / z], dim=-1)

    def unproject(self, u, v, z=None) -> torch.Tensor:
        """Pixels (u, v) -> camera rays (x, y, 1), scaled by ``z`` if given."""
        u = torch.as_tensor(u, dtype=torch.float32)
        v = torch.as_tensor(v, dtype=torch.float32, device=u.device)
        fu, fv = _f32(u.device, self.fu, self.fv)
        ray = torch.stack([(u - self.u0) / fu, (v - self.v0) / fv, torch.ones_like(u)], dim=-1)
        if z is None:
            return ray
        return ray * torch.as_tensor(z, dtype=torch.float32, device=u.device)[..., None]

    def matrix(self, device="cuda") -> torch.Tensor:
        """The 3x3 K matrix, float32 (a shared constant: do not write to it)."""
        return constant(((self.fu, 0.0, self.u0), (0.0, self.fv, self.v0), (0.0, 0.0, 1.0)),
                        device=device)

    def inverse_matrix(self, device="cuda") -> torch.Tensor:
        """K^-1, entries rounded in float32 (a shared constant: do not write
        to it)."""
        fu, fv, u0, v0 = (np.float32(v) for v in (self.fu, self.fv, self.u0, self.v0))
        one = np.float32(1.0)
        return constant(((float(one / fu), 0.0, float(-u0 / fu)),
                         (0.0, float(one / fv), float(-v0 / fv)), (0.0, 0.0, 1.0)), device=device)

    def unproject_grid(self, w: int, h: int, z=None, device="cuda") -> torch.Tensor:
        """Rays (x, y, 1) of every pixel of an (h, w) image -> (h, w, 3),
        scaled by the depth image ``z`` if given (on ``z``'s device)."""
        if z is not None:
            device = z.device
        v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                              torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
        ray = torch.stack([(u - self.u0) / self.fu, (v - self.v0) / self.fv, torch.ones_like(u)],
                          dim=-1)
        return ray if z is None else ray * z.to(torch.float32)[..., None]


def level_from_max_pixels(w: int, h: int, maxpixels: int) -> int:
    """The smallest pyramid level whose image has at most ``maxpixels``."""
    level = 0
    while (w >> level) * (h >> level) > maxpixels:
        level += 1
    return level
