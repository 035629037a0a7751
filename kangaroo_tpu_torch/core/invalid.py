"""Invalid-value sentinels (counterpart of ``kangaroo_tpu/core/invalid.py``).

float -> NaN, unsigned ints -> 0, signed ints -> -1.
"""
from __future__ import annotations

import torch

_UNSIGNED = {torch.uint8, torch.uint16, torch.uint32, torch.uint64}


def invalid_value(dtype: torch.dtype):
    """The invalid sentinel of ``dtype`` as a Python scalar."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype in _UNSIGNED:
        return 0
    return -1


def is_valid(x: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the entries that are not the invalid sentinel."""
    if x.dtype.is_floating_point:
        return torch.isfinite(x)
    if x.dtype in _UNSIGNED:
        return x != 0
    return x >= 0
