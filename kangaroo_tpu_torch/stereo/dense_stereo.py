"""Scanline patch-match dense stereo without a cost volume
(``kangaroo_tpu/stereo/dense_stereo.py``): WTA over patch scores along the
scanline with the second-best acceptance test, and the 3-rescore parabola
refinement. Plain PyTorch on every device.
"""
from __future__ import annotations

import torch

from ..core.patch_score import _pad_edge, score_shifted

MIN_DISPARITY = 0


def dense_stereo(left: torch.Tensor, right: torch.Tensor, max_disp: int, rad: int = 1,
                 kind: str = "sand", accept_thresh=0.0) -> torch.Tensor:
    """WTA patch-match disparity (int32) over d in [0, max_disp] with
    d <= x + 2rad + 1: where the best and second-best disparities differ by
    more than 1 and (second - best) / best < ``accept_thresh``, and within
    the patch width of the border, the pixel is -1."""
    H, W = left.shape
    dev = left.device
    best_s = torch.full((H, W), 1e36, dtype=torch.float32, device=dev)
    best_d = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    snd_s = torch.full((H, W), 1e37, dtype=torch.float32, device=dev)
    snd_d = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    x = torch.arange(W, device=dev)[None, :]
    width = 2 * rad + 1
    for d in range(max_disp + 1):
        score = score_shifted(left, right, -d, rad, kind)
        ok = d <= x + width
        better = ok & (score < best_s)
        second = ok & ~better & (score <= snd_s)
        snd_s = torch.where(better, best_s, torch.where(second, score, snd_s))
        snd_d = torch.where(better, best_d, torch.where(second, d, snd_d))
        best_s = torch.where(better, score, best_s)
        best_d = torch.where(better, d, best_d)
    reject = ((best_d - snd_d).abs() > 1) & ((snd_s - best_s) / best_s < accept_thresh)
    out = torch.where(reject, -1, best_d)
    y = torch.arange(H, device=dev)[:, None]
    interior = (x >= width) & (x < W - width) & (y >= width) & (y < H - width)
    return torch.where(interior, out, -1)


def dense_stereo_subpixel_refine(disp: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                                 rad: int = 1, kind: str = "sand") -> torch.Tensor:
    """Parabola through the patch scores at d + 1, d and d - 1, the whole
    right patch shifted by the centre pixel's disparity (absolute
    differences for 'sad'/'sand', squared otherwise). NaN where the vertex
    leaves (d - 1, d + 1) or disp < MIN_DISPARITY."""
    H, W = disp.shape
    disp_i = disp.to(torch.int32)
    lp = _pad_edge(left.to(torch.float32), rad, rad, rad, rad)
    rp = _pad_edge(right.to(torch.float32), rad, rad, 0, 0)
    x_idx = torch.arange(W, device=disp.device)[None, :]

    def score_at(delta):
        acc = torch.zeros((H, W), dtype=torch.float32, device=disp.device)
        for dy in range(2 * rad + 1):
            for dx in range(-rad, rad + 1):
                l_val = lp[dy:dy + H, rad + dx:rad + dx + W]
                xs = (x_idx + dx - (disp_i + delta)).clamp(0, W - 1).to(torch.int64)
                r_val = rp[dy:dy + H].gather(1, xs)
                d = l_val - r_val
                acc = acc + (d.abs() if kind in ("sad", "sand") else d * d)
        return acc

    s1, s2, s3 = score_at(1), score_at(0), score_at(-1)
    d2 = disp.to(torch.float32)
    d1, d3 = d2 + 1.0, d2 - 1.0
    denom = (d1 - d2) * (d1 - d3) * (d2 - d3)
    A = (d3 * (s2 - s1) + d2 * (s1 - s3) + d1 * (s3 - s2)) / denom
    B = (d3 * d3 * (s1 - s2) + d2 * d2 * (s3 - s1) + d1 * d1 * (s2 - s3)) / denom
    new_disp = -B / (2.0 * A)
    sensible = (new_disp > d3) & (new_disp < d1)
    return torch.where(sensible & (disp >= MIN_DISPARITY), new_disp, float("nan"))
