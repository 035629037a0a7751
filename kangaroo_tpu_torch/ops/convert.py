"""Pixel-format conversion (``kangaroo_tpu/ops/convert.py``).

Channel images are (H, W, C) tensors, grayscale (H, W). Gray from an
integer image is the integer mean of r, g and b (sum, then floor division
by 3), from a float image the float mean. The sums run in int64: PyTorch
has no uint32 arithmetic on the CPU, and the bits are the same.
"""
from __future__ import annotations

import torch

from ..backend import f32_scalars


def gray_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H, W, 3)."""
    return img[..., None].repeat_interleave(3, dim=-1)


def gray_to_rgba(img: torch.Tensor, alpha=255) -> torch.Tensor:
    """(H, W) -> (H, W, 4) with a constant alpha."""
    a = torch.full(img.shape + (1,), alpha, dtype=img.dtype, device=img.device)
    return torch.cat([gray_to_rgb(img), a], dim=-1)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3 or 4) -> (H, W): the mean of r, g and b."""
    rgb = img[..., :3]
    if not img.dtype.is_floating_point:
        return (rgb.to(torch.int64).sum(dim=-1) // 3).to(img.dtype)
    f = rgb.to(torch.float32)
    three, = f32_scalars(img.device, 3.0)
    return (f[..., 0] + f[..., 1] + f[..., 2]) / three


def rgb_to_rgba(img: torch.Tensor, alpha=255) -> torch.Tensor:
    a = torch.full(img.shape[:-1] + (1,), alpha, dtype=img.dtype, device=img.device)
    return torch.cat([img, a], dim=-1)


def rgba_to_rgb(img: torch.Tensor) -> torch.Tensor:
    return img[..., :3]


def to_float(img: torch.Tensor, scale=None) -> torch.Tensor:
    """float32 image; an integer image scaled to [0, 1] when ``scale`` is
    None, a float image unscaled."""
    if scale is None:
        scale = 1.0 if img.dtype.is_floating_point else 1.0 / 255.0
    return img.to(torch.float32) * scale


def to_uint8(img: torch.Tensor, scale=None) -> torch.Tensor:
    """uint8 image, saturated to [0, 255]; a float image is scaled by 255
    when ``scale`` is None, and a uint8 image is returned as it is."""
    if img.dtype == torch.uint8:
        return img
    if scale is None:
        scale = 255.0 if img.dtype.is_floating_point else 1.0
    return torch.clamp(img * scale, 0, 255).to(torch.uint8)
