"""Feature detection (``kangaroo_tpu/ops/features.py``): the FAST-style
segment test, the Harris score, non-maximal suppression, and the host-side
compaction of the pixels above a threshold.

The segment test keeps its 16-bit ring masks in int64 and counts their
bits with the census module's SWAR popcount: PyTorch has no popcount and
no uint32 shift on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..backend import f32_scalars
from ..stereo.census import popcount32, shift_clamped

# the FAST ring with the reference's bit numbering: (dx, dy, bit)
_RING = [
    (-1, -3, 0), (0, -3, 1), (1, -3, 2), (-2, -2, 15), (2, -2, 3),
    (-3, -1, 14), (3, -1, 4), (-3, 0, 13), (3, 0, 5), (-3, 1, 12),
    (3, 1, 6), (-2, 2, 11), (2, 2, 7), (-1, 3, 10), (0, 3, 9), (1, 3, 8),
]


def _shift(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """img sampled at (x + dx, y + dy) with clamped borders."""
    return shift_clamped(img, dy, dx)


def _interior(H: int, W: int, lo: int, hi: int, device) -> torch.Tensor:
    """lo <= x < W - hi and lo <= y < H - hi."""
    y = torch.arange(H, device=device)[:, None]
    x = torch.arange(W, device=device)[None, :]
    return (x >= lo) & (x < W - hi) & (y >= lo) & (y < H - hi)


def segment_test(img: torch.Tensor, threshold, min_segment_len: int = 9) -> torch.Tensor:
    """FAST-style segment test: uint8 255 at corners, 0 elsewhere and
    within 3 pixels of the border. Keeps the reference's bit logic,
    including its ``oppdark`` quirk, (dark >> 8) | (light << 8)."""
    f = img.to(torch.int64)
    t = int(threshold)
    light = torch.zeros_like(f)
    dark = torch.zeros_like(f)
    for dx, dy, bit in _RING:
        q = _shift(f, dx, dy)
        light |= (f + t < q).to(torch.int64) << bit
        dark |= (q < f - t).to(torch.int64) << bit
    opplight = ((light >> 8) | (light << 8)) & 0xFFFF
    oppdark = ((dark >> 8) | (light << 8)) & 0xFFFF
    corner = ((popcount32(light & opplight) >= min_segment_len)
              | (popcount32(dark & oppdark) >= min_segment_len))
    inside = _interior(*f.shape, 3, 3, f.device)
    return torch.where(corner & inside, 255, 0).to(torch.uint8)


def harris_score(img: torch.Tensor, lam=0.04) -> torch.Tensor:
    """Harris response det - lam trace^2 of the 3x3 mean structure tensor
    of central differences; 0 outside 1 < x < W - 1, 1 < y < H - 1."""
    f = img.to(torch.float32)
    nine, = f32_scalars(f.device, 9.0)
    dx = (_shift(f, 1, 0) - _shift(f, -1, 0)) / 2.0
    dy = (_shift(f, 0, 1) - _shift(f, 0, -1)) / 2.0
    ixx, iyy, ixy = torch.zeros_like(f), torch.zeros_like(f), torch.zeros_like(f)
    for sy in (-1, 0, 1):
        for sx in (-1, 0, 1):
            gx, gy = _shift(dx, sx, sy), _shift(dy, sx, sy)
            ixx = ixx + gx * gx
            iyy = iyy + gy * gy
            ixy = ixy + gx * gy
    ixx, iyy, ixy = ixx / nine, iyy / nine, ixy / nine
    trace = ixx + iyy
    score = (ixx * iyy - ixy * ixy) - lam * trace * trace
    return torch.where(_interior(*f.shape, 2, 1, f.device), score, 0.0)


def non_maximal_suppression(scores: torch.Tensor, rad: int = 2, threshold=0.0) -> torch.Tensor:
    """uint8 255 where a score is the strict maximum of its (2 rad + 1)^2
    window and above ``threshold``, 0 elsewhere and within rad + 1 of the
    border; the window is -inf outside the image."""
    f = scores.to(torch.float32)
    H, W = f.shape
    padded = F.pad(f, (rad,) * 4, value=float("-inf"))
    is_max = torch.ones(f.shape, dtype=torch.bool, device=f.device)
    for sy in range(-rad, rad + 1):
        for sx in range(-rad, rad + 1):
            if sx or sy:
                is_max &= padded[rad + sy:rad + sy + H, rad + sx:rad + sx + W] < f
    keep = is_max & (f > threshold) & _interior(H, W, rad + 1, rad, f.device)
    return torch.where(keep, 255, 0).to(torch.uint8)


def get_indices(scores, threshold) -> np.ndarray:
    """(N, 2) int array of the (y, x) of the scores above ``threshold``,
    compacted on the host."""
    s = scores.cpu().numpy() if isinstance(scores, torch.Tensor) else np.asarray(scores)
    ys, xs = np.nonzero(s > threshold)
    return np.stack([ys, xs], axis=1)
