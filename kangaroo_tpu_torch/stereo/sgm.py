"""Semi-global matching path aggregation (``kangaroo_tpu/stereo/sgm.py``).

The plain version of the SGM kernel (``stereo/sgm_cuda.py``): a Python loop
over the scan axis. Per path step, with adaptive P2' = P2 / (1 + |dI|):

  CM(d)   = min(Lr(p-r, d), Lr(p-r, d-1) + P1, Lr(p-r, d+1) + P1,
                min_d' Lr(p-r, d') + P2')
  Lr(p,d) = CM(d) + C(p,d) - min_d' Lr(p-r, d')

The first pixel of a path contributes C(p,d) directly with lastBest = 0.
Entries off the disparity lattice (d <= x for sd=-1, x + d < W for sd=+1)
carry 1e30 and contribute 0. Paths are independent and summed in the order
((vertical fwd + vertical rev) + horizontal fwd) + horizontal rev, then the
four diagonals (8-path, ``do_diagonal``): down-right, down-left, up-right,
up-left.
"""
from __future__ import annotations

import torch

_MAX_ERROR = 1e30


def _shift_min(prev: torch.Tensor, P1: float) -> torch.Tensor:
    """min(prev[d], prev[d-1]+P1, prev[d+1]+P1) along axis 0 of (D, N), with
    out-of-range neighbours excluded."""
    edge = torch.full_like(prev[:1], _MAX_ERROR)
    below = torch.cat([edge, prev[:-1]], dim=0)
    above = torch.cat([prev[1:], edge], dim=0)
    return torch.minimum(prev, torch.minimum(below + P1, above + P1))


def _shift_lines(a: torch.Tensor, dx: int, fill: float) -> torch.Tensor:
    """a[..., n - dx] at position n along the last axis, ``fill`` where
    n - dx is off the line (dx in {-1, 0, 1})."""
    if dx == 0:
        return a
    edge = torch.full_like(a[..., :1], fill)
    if dx > 0:
        return torch.cat([edge, a[..., :-1]], dim=-1)
    return torch.cat([a[..., 1:], edge], dim=-1)


def _scan_direction(vol: torch.Tensor, img: torch.Tensor, mask: torch.Tensor,
                    P1: float, P2: float, reverse: bool, dx: int = 0) -> torch.Tensor:
    """Aggregate along axis 0 of vol (L, D, N); img is (L, N), mask
    (L, D, N) the lattice. Returns Lr (L, D, N) with masked entries 0.

    ``dx`` makes the path diagonal (``_scan_diagonal`` of the JAX package):
    position n continues the path from position n - dx of the previous
    scan step, and a position whose predecessor is off the line starts a
    fresh path there (Lr = C, lastBest = 0), as the first step does."""
    L, N = vol.shape[0], vol.shape[2]
    n = torch.arange(N, device=vol.device)
    has_pred = (n - dx >= 0) & (n - dx < N)  # (N,): all True for dx = 0
    order = range(L - 1, -1, -1) if reverse else range(L)
    out = [None] * L
    prev = last_best = last_c = None
    for t, s in enumerate(order):
        cost, c, m = vol[s], img[s], mask[s]
        if t == 0:
            out[s] = torch.where(m, cost, 0.0)
            prev = torch.where(m, cost, _MAX_ERROR)
            last_best = torch.zeros_like(c)  # the seed does not update lastBest
        else:
            prev_s = _shift_lines(prev, dx, _MAX_ERROR)
            best_s = _shift_lines(last_best, dx, 0.0)
            p2 = P2 / (1.0 + (_shift_lines(last_c, dx, 0.0) - c).abs())
            cm = torch.minimum(_shift_min(prev_s, P1), (best_s + p2)[None])
            cr = cm + cost - best_s[None]
            if dx:
                cr = torch.where(has_pred[None], cr, cost)
            cr = torch.where(m, cr, _MAX_ERROR)
            out[s] = torch.where(m, cr, 0.0)
            prev = cr
            last_best = cr.min(dim=0).values
            if dx:
                last_best = torch.where(has_pred, last_best, 0.0)
        last_c = c
    return torch.stack(out, dim=0)


def semi_global_matching(vol: torch.Tensor, img: torch.Tensor, P1: float = 0.01,
                         P2: float = 0.02, do_horiz: bool = True, do_vert: bool = True,
                         do_reverse: bool = True, do_diagonal: bool = False,
                         sd: int = -1) -> torch.Tensor:
    """4-path (8-path with ``do_diagonal``) SGM aggregation of a (D, H, W)
    cost volume guided by the (H, W) image; returns the float32 aggregate
    (D, H, W). ``sd`` selects the lattice: -1 for a left-anchored volume,
    +1 for a right-anchored one. The four diagonals always run when
    ``do_diagonal`` is set; the flags select only the straight pairs."""
    D, H, W = vol.shape
    v = vol.to(torch.float32)
    img = img.to(torch.float32)
    d = torch.arange(D, device=vol.device)[:, None]
    x = torch.arange(W, device=vol.device)[None, :]
    lattice = (d <= x) if sd < 0 else (x + d < W)  # (D, W)

    out = torch.zeros_like(v)
    # scan along y: (H, D, W), lines are columns
    vv = v.permute(1, 0, 2)
    mv = lattice[None].expand(H, D, W)
    if do_vert:
        for rev in ((False, True) if do_reverse else (False,)):
            out = out + _scan_direction(vv, img, mv, P1, P2, rev).permute(1, 0, 2)
    if do_horiz:
        # scan along x: (W, D, H), lines are rows; the lattice follows x
        vh = v.permute(2, 0, 1)
        mh = lattice.T[:, :, None].expand(W, D, H)
        for rev in ((False, True) if do_reverse else (False,)):
            out = out + _scan_direction(vh, img.T, mh, P1, P2, rev).permute(1, 2, 0)
    if do_diagonal:
        for rev in (False, True):
            for dx in (1, -1):
                out = out + _scan_direction(vv, img, mv, P1, P2, rev, dx).permute(1, 0, 2)
    return out
