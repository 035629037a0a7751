"""Visualisation helpers (``kangaroo_tpu/ops/viz.py``): the red/cyan
anaglyph, the HSV heat-map overlay, circle painting and the cost volume's
cross-section at one row with the chosen disparity marked.
"""
from __future__ import annotations

import torch

from ..backend import f32_scalars


def make_anaglyph(left: torch.Tensor, right: torch.Tensor, color_code: bool = False):
    """(H, W, 4) uint8 anaglyph of a grayscale pair: red from the left
    image, green and blue from the right, alpha 255. ``color_code`` is
    accepted and unused, as in the JAX package."""
    l8, r8 = left.to(torch.uint8), right.to(torch.uint8)
    return torch.stack([l8, r8, r8, torch.full_like(l8, 255)], dim=-1)


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3) rgb of hue ``h`` in [0, 1), saturation and value."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    sector = (i.to(torch.int64) % 6)[..., None]

    def pick(*c):
        return torch.stack(c, dim=-1).gather(-1, sector)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)],
                       dim=-1)


def remap_heat(img: torch.Tensor, score: torch.Tensor, score_min, score_max) -> torch.Tensor:
    """(H, W, 3) float overlay in [0, 1]: half the image scaled by its
    finite maximum, half the heat colour of ``score`` normalised to
    [score_min, score_max] (blue low, red high)."""
    lo, hi = f32_scalars(score.device, score_min, score_max)
    t = torch.clamp((score - lo) / (hi - lo), 0.0, 1.0)
    heat = _hsv_to_rgb((1.0 - t) * (2.0 / 3.0), torch.ones_like(t), torch.ones_like(t))
    base = img.to(torch.float32)
    base = torch.where(torch.isfinite(base), base, 0.0)
    base = base / torch.clamp(base.max(), min=1e-6)
    return 0.5 * base[..., None] + 0.5 * heat


def paint_circle(img: torch.Tensor, value, cx, cy, radius) -> torch.Tensor:
    """``img`` with the pixels within ``radius`` of (cx, cy) set to ``value``."""
    cx, cy, radius = f32_scalars(img.device, cx, cy, radius)
    H, W = img.shape[:2]
    dy = torch.arange(H, dtype=torch.float32, device=img.device)[:, None] - cy
    dx = torch.arange(W, dtype=torch.float32, device=img.device)[None, :] - cx
    inside = dx * dx + dy * dy <= radius * radius
    return torch.where(inside, torch.as_tensor(value).to(img.dtype), img)


def disparity_cross_section(vol: torch.Tensor, disp: torch.Tensor, y: int) -> torch.Tensor:
    """(D, W, 3) float view of the cost volume at row ``y``, normalised to
    [0, 1] in gray, with red where d is within 0.5 of the disparity."""
    D = vol.shape[0]
    sl = vol[:, y, :]
    sl = (sl - sl.min()) / torch.clamp(sl.max() - sl.min(), min=1e-9)
    rgb = sl[..., None].repeat_interleave(3, dim=-1)
    d = torch.arange(D, dtype=torch.float32, device=vol.device)[:, None]
    chosen = torch.abs(d - disp[y][None, :]) < 0.5
    marker = torch.stack([torch.ones_like(sl), torch.zeros_like(sl), torch.zeros_like(sl)], -1)
    return torch.where(chosen[..., None], marker, rgb)
