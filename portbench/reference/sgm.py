"""Plain reference of the SGM frame, batched over frames.

Written from the frame's definition, with plain PyTorch operations only: it
imports nothing of the program. For a stack of rectified (B, H, W) uint8
pairs it computes, frame by frame and independently of one another:

- the census transform (a bit per window offset, set where the clamped
  neighbour is darker than the centre) and the Hamming cost volume
  vol[d, y, x] = popcount(L(y, x) xor R(y, x - d)) / bits, 0.5 where
  x - d < 0;
- the 4-path aggregation with the adaptive penalty P2' = P2 / (1 + |dI|) on
  the [0, 1] intensity, entries off the lattice d <= x carried as 1e30 and
  contributing 0, the paths summed ((down + up) + right) + left;
- subpixel winner-take-all on the left lattice and, on the aggregate
  re-anchored to the right image, on the right lattice;
- the 5x5 reject-invalid median of both disparities;
- the left-right check in both directions (the right image first), with the
  sweep bound of ``max_disp`` columns.

``dtype`` sets the precision of the aggregation: float32 is the frame as
configured, bfloat16 the control that the comparison has to reject.
"""
from __future__ import annotations

import torch

BIG = 1e30
WTA_BIG = 1e10

# offsets (rows, columns) and the normalising bit capacity of each window
WINDOWS = {
    "9x7": (range(-3, 4), range(-4, 5), 64),
    "11x11": (range(-5, 6), range(-5, 6), 128),
    "16x16": (range(-8, 8), range(-4, 4), 256),
}


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img[..., clamp(y + dy), clamp(x + dx)] of a (B, H, W) stack."""
    H, W = img.shape[-2:]
    ys = (torch.arange(H, device=img.device) + dy).clamp(0, H - 1)
    xs = (torch.arange(W, device=img.device) + dx).clamp(0, W - 1)
    return img[:, ys][:, :, xs]


def census_bits(img: torch.Tensor, window: str) -> torch.Tensor:
    """(K, B, H, W) bool: neighbour < centre for each of the K offsets."""
    rows, cols, _ = WINDOWS[window]
    return torch.stack([_shift(img, dy, dx) < img for dy in rows for dx in cols])


def cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                window: str) -> torch.Tensor:
    """(D, B, H, W) float32 Hamming volume of the left image."""
    bits = WINDOWS[window][2]
    cl, cr = census_bits(left, window), census_bits(right, window)
    W = left.shape[-1]
    out = torch.full((max_disp,) + tuple(left.shape), 0.5, dtype=torch.float32,
                     device=left.device)
    for d in range(max_disp):
        ham = (cl[..., d:] != cr[..., : W - d]).sum(dim=0, dtype=torch.int32)
        out[d, ..., d:] = ham.to(torch.float32) / bits
    return out


def _scan(cost: torch.Tensor, inten: torch.Tensor, valid: torch.Tensor, P1, P2,
          reverse: bool, acc: torch.Tensor, dim: int, dtype) -> None:
    """Add one path direction onto ``acc`` (D, B, H, W). The scan runs along
    ``dim`` (2: down the rows, 3: along the columns)."""
    n = cost.shape[dim]
    order = range(n - 1, -1, -1) if reverse else range(n)
    p1 = torch.tensor(P1, dtype=dtype, device=cost.device)
    p2 = torch.tensor(P2, dtype=dtype, device=cost.device)
    one = torch.tensor(1.0, dtype=dtype, device=cost.device)
    prev = best = last_i = None
    for t, s in enumerate(order):
        c = cost.select(dim, s).to(dtype)
        i = inten.select(dim - 1, s).to(dtype)
        m = valid.select(dim, s)
        if t == 0:
            lr = torch.where(m, c, torch.zeros((), dtype=dtype, device=c.device))
            prev = torch.where(m, c, torch.full((), BIG, dtype=dtype, device=c.device))
            best = torch.zeros_like(i)
        else:
            pen = p2 / (one + (last_i - i).abs())
            edge = torch.full_like(prev[:1], BIG)
            lower = torch.cat([edge, prev[:-1]]) + p1
            upper = torch.cat([prev[1:], edge]) + p1
            cm = torch.minimum(torch.minimum(prev, torch.minimum(lower, upper)),
                               (best + pen)[None])
            cr = torch.where(m, cm + c - best[None], torch.full((), BIG, dtype=dtype,
                                                                  device=c.device))
            lr = torch.where(m, cr, torch.zeros((), dtype=dtype, device=c.device))
            prev = cr
            best = cr.amin(dim=0)
        last_i = i
        acc.select(dim, s).add_(lr.to(acc.dtype))


def aggregate(vol: torch.Tensor, inten: torch.Tensor, P1: float, P2: float,
              dtype=torch.float32) -> torch.Tensor:
    """Sum of the four straight paths of vol (D, B, H, W) on the left
    lattice; inten (B, H, W) in [0, 1]. Accumulated in ``dtype``."""
    D, B, H, W = vol.shape
    d = torch.arange(D, device=vol.device)[:, None, None, None]
    x = torch.arange(W, device=vol.device)[None, None, None, :]
    valid = (d <= x).expand(D, B, H, W)
    acc = torch.zeros(vol.shape, dtype=dtype, device=vol.device)
    for dim, reverse in ((2, False), (2, True), (3, False), (3, True)):
        _scan(vol, inten, valid, P1, P2, reverse, acc, dim, dtype)
    return acc


def wta_subpix(vol: torch.Tensor, sd: int) -> torch.Tensor:
    """Subpixel WTA of (D, B, H, W) over the d with x + sd d in the image:
    the first minimum, refined by a parabola where the match is strictly
    interior and the step stays within one disparity."""
    vol = vol.to(torch.float32)
    D, B, H, W = vol.shape
    d = torch.arange(D, device=vol.device)[:, None, None, None]
    x = torch.arange(W, device=vol.device)[None, None, None, :]
    ok = (x + sd * d >= 0) & (x + sd * d < W)
    masked = torch.where(ok, vol, WTA_BIG)
    bestd = torch.argmin(masked, dim=0)
    bestc = masked.gather(0, bestd[None])[0]
    sl = vol.gather(0, (bestd - 1).clamp(0, D - 1)[None])[0]
    sr = vol.gather(0, (bestd + 1).clamp(0, D - 1)[None])[0]
    sub = bestd - (sr - sl) / (2.0 * (sr - 2.0 * bestc + sl))
    xr = torch.arange(W, device=vol.device) + sd * bestd
    keep = (xr > 0) & (xr < W - 1) & (sub > bestd - 1) & (sub < bestd + 1)
    return torch.where(keep, sub, bestd.to(torch.float32))


def reanchor_right(agg: torch.Tensor) -> torch.Tensor:
    """aggR[d, ..., x] = aggL[d, ..., x + d] (wrapped columns land where the
    right lattice rejects them)."""
    return torch.stack([torch.roll(agg[d], -d, dims=-1) for d in range(agg.shape[0])])


def median_reject_invalid(img: torch.Tensor, max_bad: int, rad: int = 2) -> torch.Tensor:
    """Median of the valid taps of each (2 rad + 1)^2 window of a (B, H, W)
    stack, edges replicated: invalid taps sort last and the output is the
    sorted tap (k + bad) // 2, or NaN where bad >= max_bad."""
    taps = torch.stack([_shift(img, dy, dx) for dy in range(-rad, rad + 1)
                        for dx in range(-rad, rad + 1)], dim=-1)
    k = taps.shape[-1]
    valid = torch.isfinite(taps)
    bad = (~valid).sum(dim=-1)
    srt = torch.sort(torch.where(valid, taps, float("inf")), dim=-1).values
    med = srt.gather(-1, ((k + bad) // 2).clamp(max=k - 1)[..., None])[..., 0]
    return torch.where((bad < max_bad) & (bad < k), med, float("nan"))


def lr_check(disp_a: torch.Tensor, disp_b: torch.Tensor, sd: int, max_diff: float,
             max_disp: int) -> torch.Tensor:
    """Keep disp_a where the other image's disparity at x + sd disp_a agrees
    within ``max_diff`` and the column offset lies in the sweep bound."""
    W = disp_a.shape[-1]
    x = torch.arange(W, device=disp_a.device)
    xr = x.to(torch.float32) + sd * disp_a
    inside = (xr >= 0) & (xr < W)
    xi = torch.where(inside, xr.clamp(0, W - 1), 0.0).to(torch.int64)
    other = disp_b.gather(-1, xi)
    k = x - xi
    lo, hi = (-1, max_disp - 1) if sd < 0 else (-max_disp, 1)
    ok = (inside & torch.isfinite(other) & ((disp_a - other).abs() <= max_diff)
          & (k >= lo) & (k <= hi))
    return torch.where(ok, disp_a, float("nan"))


def frames(left: torch.Tensor, right: torch.Tensor, cfg: dict,
           dtype=torch.float32) -> torch.Tensor:
    """Disparity (B, H, W) float32, NaN invalid, of uint8 pairs (B, H, W)
    under the frame's settings ``cfg`` (the program's SgmConfig fields)."""
    for key, want in (("do_horiz", True), ("do_vert", True), ("do_reverse", True),
                      ("do_diagonal", False), ("lr_check", True), ("lr_from_left", True),
                      ("median_its", 1), ("subpix", True), ("guided_filter", False),
                      ("bilateral_filter", False)):
        if cfg.get(key, want) != want:
            raise ValueError(f"the reference computes the frame with {key}={want!r}")
    D = cfg["max_disp"]
    vol = cost_volume(left, right, D, cfg["census_window"])
    agg = aggregate(vol, left.to(torch.float32) / 255.0, cfg["p1"], cfg["p2"], dtype)
    del vol
    disp_l = wta_subpix(agg, -1)
    disp_r = wta_subpix(reanchor_right(agg), 1)
    del agg
    disp_l = median_reject_invalid(disp_l, cfg["median_max_bad"])
    disp_r = median_reject_invalid(disp_r, cfg["median_max_bad"])
    disp_r = lr_check(disp_r, disp_l, 1, cfg["max_disp_diff"], D)
    return lr_check(disp_l, disp_r, -1, cfg["max_disp_diff"], D)
