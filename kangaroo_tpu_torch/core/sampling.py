"""Image sampling primitives (``kangaroo_tpu/core/sampling.py``).

Images are (H, W) or (H, W, C) tensors; the pixel at column x, row y is
``img[y, x]``. The samplers gather with clamped indices, so out-of-bounds
coordinates return edge values; callers that need masking combine them
with :func:`in_bounds`. The JAX package's ``take_f32`` (a gather over the
16-bit halves of each word, and its fenced variant) is TPU layout work:
here it is plain indexing, which gives the same bits as all its routes.
``central_diff*``, ``bicubic`` and ``catmull_rom`` are not ported yet.
"""
from __future__ import annotations

import torch


def _clip_xy(img, x, y):
    return torch.clamp(x, 0, img.shape[1] - 1), torch.clamp(y, 0, img.shape[0] - 1)


def get_clamped(img: torch.Tensor, x, y) -> torch.Tensor:
    """Clamped integer access."""
    xi, yi = _clip_xy(img, torch.as_tensor(x, device=img.device).long(),
                      torch.as_tensor(y, device=img.device).long())
    return img[yi, xi]


def in_bounds(img: torch.Tensor, x, y, border=0) -> torch.Tensor:
    return (x >= border) & (x < img.shape[1] - border) & (y >= border) & (y < img.shape[0] - border)


def bilinear(img: torch.Tensor, x, y) -> torch.Tensor:
    """Bilinear sample at float coordinates (indices clamped)."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    if img.dim() == 3:
        fx, fy = fx[..., None], fy[..., None]
    ix0, iy0 = _clip_xy(img, x0.long(), y0.long())
    ix1, iy1 = _clip_xy(img, x0.long() + 1, y0.long() + 1)
    f = img.to(torch.float32)
    tl, tr, bl, br = f[iy0, ix0], f[iy0, ix1], f[iy1, ix0], f[iy1, ix1]
    top = tl + (tr - tl) * fx
    bot = bl + (br - bl) * fx
    return top + (bot - top) * fy


def nearest(img: torch.Tensor, x, y) -> torch.Tensor:
    """Nearest-neighbour sample (round half up, indices clamped)."""
    return get_clamped(img, torch.floor(x + 0.5), torch.floor(y + 0.5))
