"""Semi-global matching path aggregation (``kangaroo_tpu/stereo/sgm.py``).

The plain version of the SGM kernel (``stereo/sgm_cuda.py``): a Python loop
over the scan axis. Per path step, with adaptive P2' = P2 / (1 + |dI|):

  CM(d)   = min(Lr(p-r, d), Lr(p-r, d-1) + P1, Lr(p-r, d+1) + P1,
                min_d' Lr(p-r, d') + P2')
  Lr(p,d) = CM(d) + C(p,d) - min_d' Lr(p-r, d')

The first pixel of a path contributes C(p,d) directly with lastBest = 0.
Entries off the disparity lattice (d <= x for sd=-1, x + d < W for sd=+1)
carry 1e30 and contribute 0. Paths are independent and summed in the order
((vertical fwd + vertical rev) + horizontal fwd) + horizontal rev.
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


def _scan_direction(vol: torch.Tensor, img: torch.Tensor, mask: torch.Tensor,
                    P1: float, P2: float, reverse: bool) -> torch.Tensor:
    """Aggregate along axis 0 of vol (L, D, N); img is (L, N), mask
    (L, D, N) the lattice. Returns Lr (L, D, N) with masked entries 0."""
    L = vol.shape[0]
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
            p2 = P2 / (1.0 + (last_c - c).abs())
            cm = torch.minimum(_shift_min(prev, P1), (last_best + p2)[None])
            cr = torch.where(m, cm + cost - last_best[None], _MAX_ERROR)
            out[s] = torch.where(m, cr, 0.0)
            prev = cr
            last_best = cr.min(dim=0).values
        last_c = c
    return torch.stack(out, dim=0)


def semi_global_matching(vol: torch.Tensor, img: torch.Tensor, P1: float = 0.01,
                         P2: float = 0.02, do_horiz: bool = True, do_vert: bool = True,
                         do_reverse: bool = True, do_diagonal: bool = False,
                         sd: int = -1) -> torch.Tensor:
    """4-path SGM aggregation of a (D, H, W) cost volume guided by the (H, W)
    image; returns the float32 aggregate (D, H, W). ``sd`` selects the
    lattice: -1 for a left-anchored volume, +1 for a right-anchored one."""
    if do_diagonal:
        raise NotImplementedError("8-path SGM (do_diagonal) is not ported yet")
    D, H, W = vol.shape
    v = vol.to(torch.float32)
    img = img.to(torch.float32)
    d = torch.arange(D, device=vol.device)[:, None]
    x = torch.arange(W, device=vol.device)[None, :]
    lattice = (d <= x) if sd < 0 else (x + d < W)  # (D, W)

    out = torch.zeros_like(v)
    if do_vert:
        # scan along y: (H, D, W), lines are columns
        vv = v.permute(1, 0, 2)
        mv = lattice[None].expand(H, D, W)
        for rev in ((False, True) if do_reverse else (False,)):
            out = out + _scan_direction(vv, img, mv, P1, P2, rev).permute(1, 0, 2)
    if do_horiz:
        # scan along x: (W, D, H), lines are rows; the lattice follows x
        vh = v.permute(2, 0, 1)
        mh = lattice.T[:, :, None].expand(W, D, H)
        for rev in ((False, True) if do_reverse else (False,)):
            out = out + _scan_direction(vh, img.T, mh, P1, P2, rev).permute(1, 2, 0)
    return out
