"""Patch matching scores (``kangaroo_tpu/core/patch_score.py``): single
pixel, SAD, SSD, SAND (zero-mean SAD), SSND (zero-mean SSD) and SSND over
a one-row line, each scoring a whole image against a horizontally shifted
partner through edge-clamped box sums. Plain PyTorch on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift_x(img: torch.Tensor, dx: int) -> torch.Tensor:
    """img sampled at (y, x + dx), edges clamped."""
    W = img.shape[1]
    xs = (torch.arange(W, device=img.device) + dx).clamp_(0, W - 1)
    return img.index_select(1, xs)


def _pad_edge(img: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    return F.pad(img[None, None], (left, right, top, bottom), mode="replicate")[0, 0]


def _window_sums(img: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sums of k consecutive entries along ``dim`` from a zero-led cumsum."""
    s = torch.cumsum(F.pad(img, (1, 0) if dim == 1 else (0, 0, 1, 0)), dim=dim)
    n = s.shape[dim]
    return s.narrow(dim, k, n - k) - s.narrow(dim, 0, n - k)


def _box_sum(img: torch.Tensor, rad: int) -> torch.Tensor:
    """Sum over the (2rad+1)^2 window, edge-clamped."""
    k = 2 * rad + 1
    p = _pad_edge(img, rad, rad, rad, rad)
    return _window_sums(_window_sums(p, k, 0), k, 1)


def _line_sum(img: torch.Tensor, rad: int) -> torch.Tensor:
    """Sum over the horizontal (2rad+1)-wide line, edge-clamped."""
    return _window_sums(_pad_edge(img, 0, 0, rad, rad), 2 * rad + 1, 1)


def score_shifted(img1: torch.Tensor, img2: torch.Tensor, dx: int, rad: int = 1,
                  kind: str = "sad") -> torch.Tensor:
    """Per-pixel patch score of img1 at (x, y) against img2 at (x + dx, y),
    float32. ``kind``: 'pixel' (squared difference), 'sad', 'ssd', 'sand'
    and 'ssnd' (each centre patch's mean subtracted from its pixels), or
    'ssnd_line' (SSND over the one-row line, keeping the square patch's
    count n = (2rad+1)^2 as the mean's normaliser, as the reference does)."""
    a = img1.to(torch.float32)
    b = _shift_x(img2.to(torch.float32), dx)
    d = a - b
    if kind == "pixel":
        return d * d
    if kind == "ssnd_line":
        n = float((2 * rad + 1) ** 2)
        sd = _line_sum(d, rad)
        return _line_sum(d * d, rad) - sd * sd / n
    area = float((2 * rad + 1) ** 2)
    if kind in ("sand", "ssnd"):
        dm = (_box_sum(a, rad) - _box_sum(b, rad)) / area
        H, W = d.shape
        p = _pad_edge(d, rad, rad, rad, rad)
        acc = torch.zeros_like(d)
        for dy in range(2 * rad + 1):
            for dx2 in range(2 * rad + 1):
                t = p[dy:dy + H, dx2:dx2 + W] - dm
                acc = acc + (t * t if kind == "ssnd" else t.abs())
        return acc
    if kind == "sad":
        return _box_sum(d.abs(), rad)
    if kind == "ssd":
        return _box_sum(d * d, rad)
    raise ValueError(kind)
