"""Bilateral filtering (``kangaroo_tpu/ops/bilateral.py``): the plain
spatial + range filter and the min-value-masked form that KinectFusion runs
on depth. A brute-force window of shifted copies with clamped borders;
``bilateral_cross`` and ``bilateral_volume`` (the stereo volume filter) are
not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..backend import f32_scalars


def _offsets(size: int):
    return [(r, c) for r in range(-size, size + 1) for c in range(-size, size + 1)]


def _padded(f: torch.Tensor, size: int) -> torch.Tensor:
    return F.pad(f[None, None], (size,) * 4, mode="replicate")[0, 0]


def _weights_scale(f: torch.Tensor, gs, gr):
    """-1 / (2 g^2) for the spatial and range sigmas, as float32 scalars on
    ``f``'s device (the JAX package's traced float32 arguments)."""
    gs, gr = f32_scalars(f.device, gs, gr)
    return -1.0 / (2.0 * gs * gs), -1.0 / (2.0 * gr * gr)


def bilateral(img: torch.Tensor, gs, gr, size: int = 5) -> torch.Tensor:
    """Plain bilateral filter."""
    f = img.to(torch.float32)
    H, W = f.shape
    padded = _padded(f, size)
    inv2gs2, inv2gr2 = _weights_scale(f, gs, gr)
    s, sw = torch.zeros_like(f), torch.zeros_like(f)
    for r, c in _offsets(size):
        q = padded[size + r:size + r + H, size + c:size + c + W]
        w = torch.exp((r * r + c * c) * inv2gs2) * torch.exp((f - q) ** 2 * inv2gr2)
        s = s + w * q
        sw = sw + w
    return s / sw


def bilateral_above_min(img: torch.Tensor, gs, gr, size: int, minval) -> torch.Tensor:
    """Bilateral filter that ignores samples below ``minval``; a pixel whose
    centre is below it (or NaN) comes out NaN, which is how KinectFusion
    turns too-close or missing depth into invalid depth."""
    f = img.to(torch.float32)
    H, W = f.shape
    padded = _padded(f, size)
    inv2gs2, inv2gr2 = _weights_scale(f, gs, gr)
    minval, = f32_scalars(f.device, minval)
    s, sw = torch.zeros_like(f), torch.zeros_like(f)
    for r, c in _offsets(size):
        q = padded[size + r:size + r + H, size + c:size + c + W]
        ok = q >= minval
        w = torch.where(ok, torch.exp((r * r + c * c) * inv2gs2)
                        * torch.exp((f - q) ** 2 * inv2gr2), 0.0)
        s = s + w * torch.where(ok, q, 0.0)
        sw = sw + w
    return torch.where(f >= minval, s / sw, float("nan"))
