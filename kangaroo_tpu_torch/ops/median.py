"""Median filters (``kangaroo_tpu/ops/median.py``).

The window is gathered into an (H, W, k) tensor with edge-replicated
borders and sorted along the window axis. ``median_filter_reject_invalid``
is the plain version of the median kernel (``ops/median_cuda.py``); the
named 3x3 ... 9x9 forms below are the JAX package's plain wrappers and
stay plain on every device, as there (the SGM frame reaches the kernel
through ``stereo/dispatch.py``).
"""
from __future__ import annotations

import torch

from ..core import invalid as invalid_mod


def _window_stack(img: torch.Tensor, rad: int) -> torch.Tensor:
    """(..., H, W, (2r+1)**2) window taps in row-major (dy, dx) order, each
    image of a stack with its own edges."""
    H, W = img.shape[-2:]
    taps = []
    for dy in range(-rad, rad + 1):
        ys = (torch.arange(H, device=img.device) + dy).clamp_(0, H - 1)
        rows = img.index_select(-2, ys)
        for dx in range(-rad, rad + 1):
            xs = (torch.arange(W, device=img.device) + dx).clamp_(0, W - 1)
            taps.append(rows.index_select(-1, xs))
    return torch.stack(taps, dim=-1)


def median_filter(img: torch.Tensor, rad: int = 1) -> torch.Tensor:
    """Plain median over a (2r+1)^2 window."""
    win = _window_stack(img, rad)
    return torch.sort(win, dim=-1).values[..., win.shape[-1] // 2]


def median_filter_3x3(img: torch.Tensor) -> torch.Tensor:
    return median_filter(img, 1)


def median_filter_5x5(img: torch.Tensor) -> torch.Tensor:
    return median_filter(img, 2)


def median_filter_reject_invalid(img: torch.Tensor, max_bad: int, rad: int = 2) -> torch.Tensor:
    """Median ignoring invalid entries: they sort to the top (+inf) and the
    output is sorted element (k + bad) // 2 (capped at k-1), or invalid when
    bad >= max_bad or every tap is bad. ``img`` is (H, W), or an (N, H, W)
    stack whose images are filtered alone."""
    win = _window_stack(img, rad)
    k = win.shape[-1]
    valid = invalid_mod.is_valid(win)
    bad = (~valid).sum(dim=-1)
    sorted_win = torch.sort(torch.where(valid, win, float("inf")), dim=-1).values
    idx = ((k + bad) // 2).clamp(max=k - 1)
    med = sorted_win.gather(-1, idx[..., None])[..., 0]
    ok = (bad < max_bad) & (bad < k)
    return torch.where(ok, med, invalid_mod.invalid_value(img.dtype))


def median_filter_reject_negative_5x5(img: torch.Tensor, max_bad: int) -> torch.Tensor:
    return median_filter_reject_invalid(img, max_bad, rad=2)


def median_filter_reject_negative_7x7(img: torch.Tensor, max_bad: int) -> torch.Tensor:
    return median_filter_reject_invalid(img, max_bad, rad=3)


def median_filter_reject_negative_9x9(img: torch.Tensor, max_bad: int) -> torch.Tensor:
    return median_filter_reject_invalid(img, max_bad, rad=4)
