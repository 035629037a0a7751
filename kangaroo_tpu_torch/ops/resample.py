"""Resampling (``kangaroo_tpu/ops/resample.py``): generic resample with the
nearest-neighbour, bilinear, cubic B-spline and Catmull-Rom samplers, the
2x2 box-mean downsample and its NaN-aware form, which feeds depth
pyramids.
"""
from __future__ import annotations

import torch

from ..core import invalid, sampling

NEAREST = 0
BILINEAR = 1
BICUBIC = 2
CATMULL_ROM = 3

_SAMPLERS = {NEAREST: sampling.nearest, BILINEAR: sampling.bilinear,
             BICUBIC: sampling.bicubic, CATMULL_ROM: sampling.catmull_rom,
             "nearest": sampling.nearest, "bilinear": sampling.bilinear,
             "bicubic": sampling.bicubic, "catmull_rom": sampling.catmull_rom}


def resample(img: torch.Tensor, out_w: int, out_h: int, method="bilinear") -> torch.Tensor:
    """Resample img to (out_h, out_w)."""
    sampler = _SAMPLERS[method]
    in_h, in_w = img.shape[:2]
    y, x = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=img.device),
                          torch.arange(out_w, dtype=torch.float32, device=img.device),
                          indexing="ij")
    return sampler(img, x * (in_w / out_w), y * (in_h / out_h))


def _pool2_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over 2x2 blocks (an odd last row or column is dropped), in the
    window's row-major order."""
    h, w = x.shape[0] // 2 * 2, x.shape[1] // 2 * 2
    x = x[:h, :w]
    return ((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2]) + x[1::2, 1::2]


def box_half(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean downsample (BoxHalf)."""
    out = _pool2_sum(img.to(torch.float32)) / 4.0
    return out if img.dtype.is_floating_point else out.to(img.dtype)


def box_half_ignore_invalid(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean over the valid entries only (BoxHalfIgnoreInvalid); a block
    with none comes out invalid."""
    ok = invalid.is_valid(img)
    s = _pool2_sum(torch.where(ok, img.to(torch.float32), 0.0))
    n = _pool2_sum(ok.to(torch.float32))
    out = s / torch.clamp(n, min=1.0)
    bad = n == 0
    if img.dtype.is_floating_point:
        return torch.where(bad, float("nan"), out)
    return torch.where(bad, invalid.invalid_value(img.dtype), out.to(img.dtype))
