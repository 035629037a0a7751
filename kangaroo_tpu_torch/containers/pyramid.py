"""Power-of-two image pyramids (``kangaroo_tpu/containers/pyramid.py``).

A pyramid is a tuple of tensors, level 0 the finest: the 2x2 box-mean
pyramid, its NaN-aware form (the KinectFusion frame's depth pyramid), and
the blur-then-box pyramid.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops import blur as blur_mod
from ..ops import resample

Pyramid = Tuple[torch.Tensor, ...]


def allocate(img: torch.Tensor, levels: int) -> Pyramid:
    """Level 0 ``img`` and zeroed coarser levels, each half the one above
    (rounded down) in its first two axes."""
    pyr = [img]
    for _ in range(1, levels):
        prev = pyr[-1]
        pyr.append(torch.zeros((prev.shape[0] // 2, prev.shape[1] // 2) + tuple(prev.shape[2:]),
                               dtype=prev.dtype, device=prev.device))
    return tuple(pyr)


def _reduce(first: torch.Tensor, levels: int, half) -> Pyramid:
    pyr = [first]
    for _ in range(1, levels):
        pyr.append(half(pyr[-1]))
    return tuple(pyr)


def box_reduce(img: torch.Tensor, levels: int) -> Pyramid:
    """2x2 box-mean pyramid of ``levels`` levels."""
    return _reduce(img, levels, resample.box_half)


def box_reduce_ignore_invalid(img: torch.Tensor, levels: int) -> Pyramid:
    """NaN-aware 2x2 box-mean pyramid of ``levels`` levels."""
    return _reduce(img, levels, resample.box_half_ignore_invalid)


def blur_reduce(img: torch.Tensor, levels: int, temp=None) -> Pyramid:
    """Level 0 the binomial blur of ``img``, then 2x2 box means. ``temp``
    (the reference's scratch image) is accepted and unused."""
    return _reduce(blur_mod.blur(img), levels, resample.box_half)


def sub_pyramid(pyr: Pyramid, start: int) -> Pyramid:
    """The levels from ``start`` on."""
    return tuple(pyr[start:])
