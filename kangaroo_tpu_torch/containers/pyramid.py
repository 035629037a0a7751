"""Power-of-two image pyramids (``kangaroo_tpu/containers/pyramid.py``).

A pyramid is a tuple of tensors, level 0 the finest. Ported:
``box_reduce_ignore_invalid``, the NaN-aware pyramid of the KinectFusion
frame; ``allocate``, ``box_reduce``, ``blur_reduce`` and ``sub_pyramid``
have no caller on the ported paths yet.
"""
from __future__ import annotations

import torch

from ..ops import resample


def box_reduce_ignore_invalid(img: torch.Tensor, levels: int) -> tuple:
    """NaN-aware 2x2 box-mean pyramid of ``levels`` levels."""
    pyr = [img]
    for _ in range(1, levels):
        pyr.append(resample.box_half_ignore_invalid(pyr[-1]))
    return tuple(pyr)
