"""Rectification lookup tables and image warping (``kangaroo_tpu/ops/warp.py``):
the MATLAB-convention radial distortion (k1, k2) lookup, optionally
composed with a homography, and the bilinear warp through it.
"""
from __future__ import annotations

import torch

from ..backend import f32_scalars
from ..core import sampling


def create_matlab_lookup_table(w: int, h: int, fu, fv, u0, v0, k1, k2, H_on=None,
                               device="cuda") -> torch.Tensor:
    """(h, w, 2) float32 lookup of the distorted source coordinates (x, y)
    of each rectified pixel, made on ``device``. With ``H_on`` (3x3, new to
    original image coordinates) the homography maps each pixel first and
    the result is clamped to [1, dim - 2], as in the reference."""
    fu, fv, u0, v0, k1, k2 = f32_scalars(device, fu, fv, u0, v0, k1, k2)
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    if H_on is not None:
        Hm = torch.as_tensor(H_on, dtype=torch.float32).to(device).reshape(3, 3)
        hdiv = Hm[2, 0] * x + Hm[2, 1] * y + Hm[2, 2]
        u = (Hm[0, 0] * x + Hm[0, 1] * y + Hm[0, 2]) / hdiv
        v = (Hm[1, 0] * x + Hm[1, 1] * y + Hm[1, 2]) / hdiv
    else:
        u, v = x, y
    pnu = (u - u0) / fu
    pnv = (v - v0) / fv
    rr = pnu * pnu + pnv * pnv
    rf = 1.0 + k1 * rr + k2 * rr * rr
    lx = pnu * rf * fu + u0
    ly = pnv * rf * fv + v0
    if H_on is not None:
        lx = torch.clamp(lx, 1.0, w - 2.0)
        ly = torch.clamp(ly, 1.0, h - 2.0)
    return torch.stack([lx, ly], dim=-1)


def warp(img: torch.Tensor, lookup: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img`` at the lookup's (x, y) of each output
    pixel; an integer image comes back in its dtype, truncated."""
    out = sampling.bilinear(img, lookup[..., 0], lookup[..., 1])
    return out if img.dtype.is_floating_point else out.to(img.dtype)
