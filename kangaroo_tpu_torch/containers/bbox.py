"""Axis-aligned bounding boxes in world units (``kangaroo_tpu/containers/bbox.py``).

``lo``/``hi`` are (3,) float32 tensors ordered (x, y, z), on the device of
the volume they bound. Ported: ``create`` and ``size``; ``half_size``,
``center``, ``empty``, ``insert``, ``intersect``, ``enlarge``, ``contains``
and ``fit_to_frustum`` have no caller on the ported paths yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class BoundingBox:
    lo: torch.Tensor  # (3,) min corner
    hi: torch.Tensor  # (3,) max corner

    @classmethod
    def create(cls, lo=(-1.0, -1.0, -1.0), hi=(1.0, 1.0, 1.0), device="cuda") -> "BoundingBox":
        def f32(v):
            if isinstance(v, torch.Tensor):
                return v.to(device=device, dtype=torch.float32)
            return torch.tensor(np.asarray(v, np.float32), device=device)

        return cls(f32(lo), f32(hi))

    @property
    def device(self) -> torch.device:
        return self.lo.device

    def size(self) -> torch.Tensor:
        return self.hi - self.lo
