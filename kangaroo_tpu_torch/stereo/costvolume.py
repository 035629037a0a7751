"""Cost-volume reductions (``kangaroo_tpu/stereo/costvolume.py``): WTA
disparity, subpixel refinement, right re-anchoring and the LR check.

Volumes are (D, H, W); disparity images are (H, W) float32 with NaN for
invalid, or int32. ``cost_vol_minimum_subpix`` and ``left_right_check`` are
the plain versions of the WTA and LR-check kernels (``stereo/dispatch.py``
picks between them).
"""
from __future__ import annotations

import torch

from ..core import invalid as invalid_mod

_BIG = 1e10


def _xr_valid(W: int, D: int, sd: int, device=None) -> torch.Tensor:
    """(D, W) mask: is x + sd*d inside the image."""
    x = torch.arange(W, device=device)[None, :]
    d = torch.arange(D, device=device)[:, None]
    xr = x + sd * d
    return (xr >= 0) & (xr < W)


def cost_vol_minimum(vol: torch.Tensor, max_disp: int | None = None) -> torch.Tensor:
    """WTA argmin over d with the per-x clip d < min(max_disp, x+1).
    Returns int32 disparity."""
    D, H, W = vol.shape
    d = torch.arange(D, device=vol.device)[:, None, None]
    x = torch.arange(W, device=vol.device)[None, None, :]
    ok = d <= x
    if max_disp is not None and max_disp < D:
        ok = ok & (d < max_disp)
    return torch.argmin(torch.where(ok, vol, _BIG), dim=0).to(torch.int32)


def cost_vol_minimum_subpix(vol: torch.Tensor, sd: int = -1) -> torch.Tensor:
    """WTA over all d with x + sd*d in the image, then the 3-point parabola
    step where the match is strictly interior and the fitted minimum lies
    within (best-1, best+1). Arithmetic in float32 for bf16 volumes."""
    vol = vol.to(torch.float32)
    D, H, W = vol.shape
    ok = _xr_valid(W, D, sd, vol.device)[:, None, :]
    masked = torch.where(ok, vol, _BIG)
    bestd = torch.argmin(masked, dim=0)  # first index attaining the min
    bestc = masked.gather(0, bestd[None])[0]
    sl = vol.gather(0, (bestd - 1).clamp(0, D - 1)[None])[0]
    sr = vol.gather(0, (bestd + 1).clamp(0, D - 1)[None])[0]
    denom = 2.0 * (sr - 2.0 * bestc + sl)
    subpix = bestd - (sr - sl) / denom

    bestxr = torch.arange(W, device=vol.device)[None, :] + sd * bestd
    interior = (bestxr > 0) & (bestxr < W - 1)
    sensible = (subpix > bestd - 1) & (subpix < bestd + 1)
    return torch.where(interior & sensible, subpix, bestd.to(torch.float32))


def reanchor_right(agg_l: torch.Tensor) -> torch.Tensor:
    """Re-anchor a left-anchored volume on the right image's lattice:
    aggR[d, y, x] = aggL[d, y, x + d]. Columns that wrap land at x + d >= W,
    which the right lattice (x + d < W) rejects downstream."""
    return torch.stack([torch.roll(agg_l[d], -d, dims=1)
                        for d in range(agg_l.shape[0])], dim=0)


def left_right_check(disp_l: torch.Tensor, disp_r: torch.Tensor, sd: int = -1,
                     max_diff: float = 0.5, max_disp: int | None = None) -> torch.Tensor:
    """Invalidate (NaN) left disparities inconsistent with the right image's.

    ``max_disp`` adds the TPU kernel's sweep bound: a pixel whose column
    offset x - trunc(x + sd*dl) lies outside [-1, max_disp) (sd=-1) or
    [-max_disp, 2) (sd=+1) is rejected, which makes this the exact plain
    version of the CUDA kernel; without it, the ``kangaroo_tpu`` XLA twin.
    """
    H, W = disp_l.shape
    x = torch.arange(W, device=disp_l.device)
    xr = x.to(torch.float32)[None, :] + sd * disp_l
    in_img = (xr >= 0) & (xr < W)
    # a NaN disparity never reaches the float-to-int conversion
    xi = torch.where(in_img, xr.clamp(0, W - 1), 0.0).to(torch.int64)
    dr = disp_r.gather(1, xi)
    ok = in_img & invalid_mod.is_valid(dr) & ((disp_l - dr).abs() <= max_diff)
    if max_disp is not None:
        k = x[None, :] - xi
        k_min, k_max = (-1, max_disp - 1) if sd < 0 else (-max_disp, 1)
        ok = ok & (k >= k_min) & (k <= k_max)
    return torch.where(ok, disp_l, float("nan"))
