"""Separable blurs (``kangaroo_tpu/ops/blur.py``): the 3-tap binomial blur
with its border rule, and the Gaussian blur with edge-replicated borders.
Plain PyTorch on the input's device, float32 inside; an integer image
comes back in its own dtype, truncated.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..backend import f32_scalars


def _binomial_1d(f: torch.Tensor, dim: int) -> torch.Tensor:
    """(prev + 2 centre + next) / 4 along ``dim`` of a float32 (H, W) image;
    the first and last entries (2 edge + inner neighbour) / 3, and a lone
    entry (2 f + f) / 3, its own neighbour (the JAX package's clamped read)."""
    n = f.shape[dim]
    three, = f32_scalars(f.device, 3.0)
    if n < 2:
        return (2.0 * f + f) / three
    out = (torch.roll(f, 1, dim) + 2.0 * f + torch.roll(f, -1, dim)) / 4.0
    first = (2.0 * f.narrow(dim, 0, 1) + f.narrow(dim, 1, 1)) / three
    last = (2.0 * f.narrow(dim, n - 1, 1) + f.narrow(dim, n - 2, 1)) / three
    return torch.cat([first, out.narrow(dim, 1, n - 2), last], dim=dim)


def blur(img: torch.Tensor) -> torch.Tensor:
    """3-tap binomial blur, along x then y."""
    out = _binomial_1d(_binomial_1d(img.to(torch.float32), 1), 0)
    return out if img.dtype.is_floating_point else out.to(img.dtype)


def gaussian_blur(img: torch.Tensor, sigma, rad: int = 10, clamp255: bool | None = None):
    """Separable Gaussian blur over offsets -rad..rad with edge-replicated
    borders. The weights are float32 on the image's device,
    exp(-i^2 / (2 sigma^2)) / (sqrt(2 pi) sigma) with sigma at least 1e-6;
    the centre tap counts twice and the sum is divided by twice the
    weights' sum, as the reference does. An integer image is clamped to
    [0, 255] (``clamp255``) and truncated back to its dtype."""
    if clamp255 is None:
        clamp255 = not img.dtype.is_floating_point
    sigma, two_pi = f32_scalars(img.device, sigma, 2.0 * math.pi)
    sigma = torch.clamp(sigma, min=1e-6)
    i = torch.arange(rad + 1, dtype=torch.float32, device=img.device)
    w = torch.exp(-0.5 * i * i / (sigma * sigma)) / (torch.sqrt(two_pi) * sigma)
    norm = 2.0 * torch.sum(w)

    def pass_axis(a: torch.Tensor, dim: int) -> torch.Tensor:
        pad = (0, 0, rad, rad) if dim == 0 else (rad, rad)
        padded = F.pad(a[None], pad, mode="replicate")[0]
        acc = 2.0 * w[0] * a
        for off in range(1, rad + 1):
            lo = padded.narrow(dim, rad - off, a.shape[dim])
            hi = padded.narrow(dim, rad + off, a.shape[dim])
            acc = acc + w[off] * (lo + hi)
        return acc / norm

    out = pass_axis(pass_axis(img.to(torch.float32), 1), 0)
    if clamp255:
        out = torch.clamp(out, 0.0, 255.0)
    return out if img.dtype.is_floating_point else out.to(img.dtype)
