"""Image sampling primitives (``kangaroo_tpu/core/sampling.py``).

Images are (H, W) or (H, W, C) tensors; the pixel at column x, row y is
``img[y, x]``. The samplers gather with clamped indices, so out-of-bounds
coordinates return edge values; callers that need masking combine them
with :func:`in_bounds`. The JAX package's ``take_f32`` (a gather over the
16-bit halves of each word, and its fenced variant) is TPU layout work:
here it is plain indexing, which gives the same bits as all its routes.
"""
from __future__ import annotations

import torch

from ..backend import f32_scalars


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
    # each lerp one fused multiply-add, as XLA computes it on the CPU
    top = torch.addcmul(tl, tr - tl, fx)
    bot = torch.addcmul(bl, br - bl, fx)
    return torch.addcmul(top, bot - top, fy)


def nearest(img: torch.Tensor, x, y) -> torch.Tensor:
    """Nearest-neighbour sample (round half up, indices clamped)."""
    return get_clamped(img, torch.floor(x + 0.5), torch.floor(y + 0.5))


def central_diff(img: torch.Tensor, x, y):
    """Central difference (dI/dx, dI/dy) at integer coordinates, float32."""
    xi = torch.as_tensor(x, device=img.device).long()
    yi = torch.as_tensor(y, device=img.device).long()
    dx = (get_clamped(img, xi + 1, yi).to(torch.float32) - get_clamped(img, xi - 1, yi)) / 2.0
    dy = (get_clamped(img, xi, yi + 1).to(torch.float32) - get_clamped(img, xi, yi - 1)) / 2.0
    return dx, dy


def central_diff_bilinear(img: torch.Tensor, x, y):
    """Central difference at float coordinates: the bilinear blend of the
    four integer central differences around them."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    ix, iy = torch.floor(x).long(), torch.floor(y).long()
    fx, fy = x - torch.floor(x), y - torch.floor(y)
    bldx, bldy = central_diff(img, ix, iy)
    brdx, brdy = central_diff(img, ix + 1, iy)
    tldx, tldy = central_diff(img, ix, iy + 1)
    trdx, trdy = central_diff(img, ix + 1, iy + 1)
    dx = (bldx + (brdx - bldx) * fx) * (1 - fy) + (tldx + (trdx - tldx) * fx) * fy
    dy = (bldy + (brdy - bldy) * fx) * (1 - fy) + (tldy + (trdy - tldy) * fx) * fy
    return dx, dy


def _cubic_bspline_weights(f: torch.Tensor):
    six, = f32_scalars(f.device, 6.0)
    f2 = f * f
    f3 = f2 * f
    return ((1.0 - 3.0 * f + 3.0 * f2 - f3) / six, (4.0 - 6.0 * f2 + 3.0 * f3) / six,
            (1.0 + 3.0 * f + 3.0 * f2 - 3.0 * f3) / six, f3 / six)


def _catmull_rom_weights(f: torch.Tensor):
    f2 = f * f
    f3 = f2 * f
    return (0.5 * (-f + 2.0 * f2 - f3), 0.5 * (2.0 - 5.0 * f2 + 3.0 * f3),
            0.5 * (f + 4.0 * f2 - 3.0 * f3), 0.5 * (-f2 + f3))


def _cubic_sample(img: torch.Tensor, x, y, weight_fn) -> torch.Tensor:
    """The 4x4 taps around (x, y) (indices clamped), weighted along x within
    each row, then the rows along y."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    ix, iy = torch.floor(x).long(), torch.floor(y).long()
    wx = weight_fn(x - torch.floor(x))
    wy = weight_fn(y - torch.floor(y))
    if img.dim() == 3:
        wx = tuple(w[..., None] for w in wx)
        wy = tuple(w[..., None] for w in wy)
    acc = 0.0
    for j, wyj in enumerate(wy):
        row = 0.0
        for i, wxi in enumerate(wx):
            row = row + wxi * get_clamped(img, ix + i - 1, iy + j - 1).to(torch.float32)
        acc = acc + wyj * row
    return acc


def bicubic(img: torch.Tensor, x, y) -> torch.Tensor:
    """Cubic B-spline sample at float coordinates, float32."""
    return _cubic_sample(img, x, y, _cubic_bspline_weights)


def catmull_rom(img: torch.Tensor, x, y) -> torch.Tensor:
    """Catmull-Rom sample at float coordinates, float32."""
    return _cubic_sample(img, x, y, _catmull_rom_weights)
