"""Elementwise and reduction vocabulary (``kangaroo_tpu/ops/elementwise.py``):
fill, scale-bias, add, multiply, divide, square, multiply-add and the L1
image sum. Plain PyTorch on the input's device; every result but ``fill``
is float32.
"""
from __future__ import annotations

import torch


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def fill(img: torch.Tensor, value) -> torch.Tensor:
    return torch.full_like(img, value)


def scale_bias(img: torch.Tensor, scale, bias=0.0) -> torch.Tensor:
    """img * scale + bias."""
    return _f32(img) * scale + bias


def add(a: torch.Tensor, b: torch.Tensor, sa=1.0, sb=1.0, offset=0.0) -> torch.Tensor:
    """sa*a + sb*b + offset."""
    return sa * _f32(a) + sb * _f32(b) + offset


def multiply(a: torch.Tensor, b: torch.Tensor, scale=1.0) -> torch.Tensor:
    return scale * _f32(a) * _f32(b)


def divide(a: torch.Tensor, b: torch.Tensor, sa=1.0, sb=1.0, eps=0.0) -> torch.Tensor:
    """(sa*a) / (sb*b + eps)."""
    return (sa * _f32(a)) / (sb * _f32(b) + eps)


def square(a: torch.Tensor) -> torch.Tensor:
    a = _f32(a)
    return a * a


def multiply_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, sab=1.0,
                 sc=1.0) -> torch.Tensor:
    """sab*a*b + sc*c."""
    return sab * _f32(a) * _f32(b) + sc * _f32(c)


def image_l1(img: torch.Tensor) -> torch.Tensor:
    """Sum of |pixel| over the image, a 0-d float32 tensor."""
    return torch.sum(torch.abs(_f32(img)))
