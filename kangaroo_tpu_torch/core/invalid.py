"""Invalid-value sentinels (counterpart of ``kangaroo_tpu/core/invalid.py``).

float -> NaN, unsigned ints -> 0, signed ints -> -1.
"""
from __future__ import annotations

import numpy as np
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


def invalid_like(x: torch.Tensor) -> torch.Tensor:
    """A tensor of ``x``'s shape, dtype and device filled with its sentinel."""
    return torch.full_like(x, invalid_value(x.dtype))


def np_invalid_value(dtype):
    """The invalid sentinel of a NumPy dtype, as a NumPy scalar (host side)."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        return dtype.type(np.nan)
    if np.issubdtype(dtype, np.unsignedinteger):
        return dtype.type(0)
    return dtype.type(-1)
