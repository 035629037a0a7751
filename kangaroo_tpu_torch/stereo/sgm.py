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

The segment functions (``sgm_aggregate_scan``, ``sgm_aggregate_block``,
``sgm_aggregate_diag_block``; ``kangaroo_tpu/stereo/sgm_pallas.py``) are the
plain versions of the multi-device wavefront's and reshard's kernels: one
scan over a column block at a lattice offset, a row segment that continues
an upstream segment's carry and returns its own, and a stacked frame batch
re-seeded at every seam. Their volumes keep the (D, S, N) layout of the
single-device code: a horizontal scan runs along axis 2 (the JAX package
transposes the volume to (D, W, H) for it), and an upward segment scans
its rows bottom to top (``reverse``) where the JAX package reverses the
rows. With ``acc`` the result is added onto ``acc`` in place.
"""
from __future__ import annotations

import torch

from ..backend import f32_scalars

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
                    P1: float, P2: float, reverse: bool, dx: int = 0, carry_in=None,
                    return_carry: bool = False, width: int | None = None):
    """Aggregate along axis 0 of vol (L, D, N); img is (L, N), mask
    (L, D, N) the lattice. Returns Lr (L, D, N) with masked entries 0.

    ``dx`` makes the path diagonal (``_scan_diagonal`` of the JAX package):
    position n continues the path from position n - dx of the previous
    scan step, and a position whose predecessor is off the line, or at or
    past ``width`` (default N), starts a fresh path there (Lr = C,
    lastBest = 0), as the first step does.

    ``carry_in`` continues an upstream segment (the JAX twin's carry, with
    prev as (D, N)): (prev, last_best, last_c) for a straight path, whose
    first step then steps from it; a diagonal's carry adds the has-path
    mask (N,), and its first step continues only where the predecessor's
    mask is set, so an all-false mask is the seed. With ``return_carry``
    the final carry of the same form is returned too."""
    L, D, N = vol.shape
    width = N if width is None else width
    n = torch.arange(N, device=vol.device)
    # (N,): all True for dx = 0
    pred_in = (n - dx >= 0) & (n - dx < min(N, width)) if dx else torch.ones_like(n, dtype=bool)
    p2_num = f32_scalars(vol.device, P2)[0]
    order = range(L - 1, -1, -1) if reverse else range(L)
    out = [None] * L
    prev = last_best = last_c = has = None
    if carry_in is not None:
        prev, last_best, last_c = (t.to(torch.float32) for t in carry_in[:3])
        if dx:
            has = carry_in[3] > 0.5 if carry_in[3].is_floating_point() else carry_in[3]
    for t, s in enumerate(order):
        cost, c, m = vol[s], img[s], mask[s]
        if t == 0 and carry_in is None:
            out[s] = torch.where(m, cost, 0.0)
            prev = torch.where(m, cost, _MAX_ERROR)
            last_best = torch.zeros_like(c)  # the seed does not update lastBest
        else:
            prev_s = _shift_lines(prev, dx, _MAX_ERROR)
            best_s = _shift_lines(last_best, dx, 0.0)
            p2 = p2_num / (1.0 + (_shift_lines(last_c, dx, 0.0) - c).abs())
            cm = torch.minimum(_shift_min(prev_s, P1), (best_s + p2)[None])
            cr = cm + cost - best_s[None]
            if dx:
                has_pred = pred_in if t > 0 else pred_in & _shift_lines(has, dx, False)
                cr = torch.where(has_pred[None], cr, cost)
            cr = torch.where(m, cr, _MAX_ERROR)
            out[s] = torch.where(m, cr, 0.0)
            prev = cr
            last_best = cr.min(dim=0).values
            if dx:
                last_best = torch.where(has_pred, last_best, 0.0)
        last_c = c
    lr = torch.stack(out, dim=0)
    if not return_carry:
        return lr
    fin = (prev, last_best, last_c)
    return lr, (fin + (torch.ones(N, dtype=torch.bool, device=vol.device),) if dx else fin)


def _lattice(D: int, N: int, sd: int, width: int, offset: int, device) -> torch.Tensor:
    """(D, N) valid-disparity mask at absolute columns offset .. offset+N-1."""
    d = torch.arange(D, device=device)[:, None]
    x = torch.arange(N, device=device)[None, :] + offset
    return (d <= x) if sd < 0 else (x + d < width)


def _sd(mask_mode: str) -> int:
    if mask_mode not in ("left", "right"):
        raise ValueError(f"mask_mode must be 'left' or 'right', got {mask_mode!r}")
    return -1 if mask_mode == "left" else 1


def _finish(lr: torch.Tensor, acc: torch.Tensor | None) -> torch.Tensor:
    """Lr (D, S, N) as a new tensor, or added onto ``acc`` in place."""
    if acc is None:
        return lr.contiguous()
    return acc.add_(lr)


def _vertical(vol, img, P1, P2, sd, width, offset, reverse, seam_period=None, dx=0,
              carry_in=None, return_carry=False):
    """One row-direction scan of vol (D, S, N): Lr as (D, S, N) (and the
    carry). A seam period re-seeds every that many rows: the frames become
    independent lines side by side."""
    D, S, N = vol.shape
    v = vol.to(torch.float32)
    img = img.to(torch.float32)
    lat = _lattice(D, N, sd, width, offset, vol.device)
    if seam_period:
        B = S // seam_period
        lines = v.reshape(D, B, seam_period, N).permute(2, 0, 1, 3).reshape(seam_period, D, B * N)
        lines_img = img.reshape(B, seam_period, N).permute(1, 0, 2).reshape(seam_period, B * N)
        m = lat.repeat(1, B)[None].expand(seam_period, D, B * N)
        lr = _scan_direction(lines, lines_img, m, P1, P2, reverse)
        return lr.reshape(seam_period, D, B, N).permute(1, 2, 0, 3).reshape(D, S, N)
    m = lat[None].expand(S, D, N)
    res = _scan_direction(v.permute(1, 0, 2), img, m, P1, P2, reverse, dx, carry_in,
                          return_carry, width)
    if return_carry:
        return res[0].permute(1, 0, 2), res[1]
    return res.permute(1, 0, 2)


def sgm_aggregate_scan(vol: torch.Tensor, img: torch.Tensor, P1: float = 0.01, P2: float = 0.02,
                       do_reverse: bool = True, mask_mode: str = "left", scan_is_x: bool = False,
                       width: int | None = None, acc: torch.Tensor | None = None,
                       lane_offset: int | None = None, seam_period: int | None = None):
    """Both path directions along one axis of vol (D, S, N), forward first,
    the reverse added on; img is (S, N). Along the rows by default, with the
    lattice at absolute column x + ``lane_offset`` of an image ``width``
    wide (default N): a column shard's vertical scans. ``scan_is_x`` scans
    along the columns instead (a row shard's horizontal scans; the lattice
    follows the column, ``width`` must be N). ``seam_period`` re-seeds the
    row scans every that many rows (frames stacked along the rows)."""
    D, S, N = vol.shape
    sd = _sd(mask_mode)
    width = N if width is None else int(width)
    offset = 0 if lane_offset is None else int(lane_offset)
    _check_scan(S, N, scan_is_x, width, offset, seam_period)
    if scan_is_x:
        lat = _lattice(D, N, sd, N, 0, vol.device)
        v = vol.to(torch.float32).permute(2, 0, 1)  # (N, D, S): lines are rows
        m = lat.T[:, :, None].expand(N, D, S)
        it = img.to(torch.float32).T
        lrs = [_scan_direction(v, it, m, P1, P2, rev).permute(1, 2, 0)
               for rev in ((False, True) if do_reverse else (False,))]
    else:
        lrs = [_vertical(vol, img, P1, P2, sd, width, offset, rev, seam_period)
               for rev in ((False, True) if do_reverse else (False,))]
    out = _finish(lrs[0], acc)
    for lr in lrs[1:]:
        out = out.add_(lr)
    return out


def _check_scan(S, N, scan_is_x, width, offset, seam_period) -> None:
    if scan_is_x and (width != N or offset):
        raise ValueError("a horizontal scan covers whole rows: width must be N and no "
                         "lane_offset")
    if seam_period is not None and (scan_is_x or seam_period < 1 or S % seam_period):
        raise ValueError(f"seam_period {seam_period} must divide the {S} rows of a row scan")


def sgm_aggregate_block(vol: torch.Tensor, img: torch.Tensor, P1: float = 0.01,
                        P2: float = 0.02, mask_mode: str = "left", width: int | None = None,
                        seed: bool = True, carry_prev=None, carry_best=None, last_img=None,
                        lane_offset: int | None = None, acc: torch.Tensor | None = None,
                        reverse: bool = False):
    """One vertical path direction over a row segment vol (D, S, N) of a
    column block at absolute column ``lane_offset`` of an image ``width``
    wide: downward, or upward with ``reverse``. With ``seed`` the paths start
    at the segment's first row; otherwise ``carry_prev`` (D, N),
    ``carry_best`` (N,) and ``last_img`` (N,), the upstream segment's final
    state, continue the recurrence. Returns (Lr, added onto ``acc`` in place
    when given; final prev (D, N); final best (N,); the segment's last
    intensity row)."""
    D, S, N = vol.shape
    _check_block(vol, img, carry_prev, carry_best, last_img, None, seed)
    sd = _sd(mask_mode)
    width = N if width is None else int(width)
    carry = None if seed else (carry_prev, carry_best, last_img)
    lr, (prev, best, last) = _vertical(vol, img, P1, P2, sd, width,
                                       0 if lane_offset is None else int(lane_offset),
                                       reverse, carry_in=carry, return_carry=True)
    return _finish(lr, acc), prev.contiguous(), best, last.to(torch.float32)


def sgm_aggregate_diag_block(vol: torch.Tensor, img: torch.Tensor, carry_prev, carry_best,
                             carry_has, last_img, P1: float = 0.01, P2: float = 0.02,
                             mask_mode: str = "left", dx: int = 1, width: int | None = None,
                             acc: torch.Tensor | None = None, reverse: bool = False):
    """One diagonal path direction over a row segment vol (D, S, N): pixel
    (x, y) continues from (x - dx, y - 1), or from (x - dx, y + 1) with
    ``reverse`` (upward). The carry (``carry_prev`` (D, N), ``carry_best``,
    ``carry_has`` and ``last_img``, each (N,)) is the upstream segment's
    final state; the first row continues where ``carry_has`` is set at the
    predecessor's column, so an all-zero mask is the seed. A predecessor at
    or past column ``width`` (default N) starts a fresh path. Returns (Lr,
    added onto ``acc`` in place when given; final prev; final best; the
    segment's last intensity row; an all-ones has mask (N,) float32)."""
    D, S, N = vol.shape
    if dx not in (1, -1):
        raise ValueError(f"dx must be +1 or -1, got {dx}")
    _check_block(vol, img, carry_prev, carry_best, last_img, carry_has, False)
    sd = _sd(mask_mode)
    width = N if width is None else int(width)
    lr, (prev, best, last, has) = _vertical(
        vol, img, P1, P2, sd, width, 0, reverse, dx=dx,
        carry_in=(carry_prev, carry_best, last_img, carry_has), return_carry=True)
    return (_finish(lr, acc), prev.contiguous(), best, last.to(torch.float32),
            has.to(torch.float32))


def _check_block(vol, img, carry_prev, carry_best, last_img, carry_has, seed) -> None:
    """Shapes of a segment's inputs; the segments have no gradient."""
    if vol.dim() != 3:
        raise ValueError(f"vol must be (D, S, N), got {tuple(vol.shape)}")
    D, S, N = vol.shape
    if tuple(img.shape) != (S, N):
        raise ValueError(f"img {tuple(img.shape)} does not match vol {tuple(vol.shape)}")
    carry = [] if seed else [("carry_prev", carry_prev, (D, N)), ("carry_best", carry_best, (N,)),
                             ("last_img", last_img, (N,))]
    if carry_has is not None:
        carry.append(("carry_has", carry_has, (N,)))
    for name, t, shape in carry:
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{None if t is None else tuple(t.shape)}")
    for name, t in [("vol", vol), ("img", img)] + [(n, t) for n, t, _ in carry]:
        if t.requires_grad:
            raise RuntimeError(f"the SGM segments have no gradient; {name} requires grad")


def _check_step(step) -> tuple[int, int]:
    s = tuple(int(v) for v in step)
    if len(s) != 2 or not set(s) <= {-1, 0, 1} or s == (0, 0):
        raise ValueError(f"step must be (sx, sy) in {{-1, 0, 1}}^2 other than (0, 0), got {step}")
    return s


def aggregate_direction(vol: torch.Tensor, img: torch.Tensor, step, P1: float = 0.01,
                        P2: float = 0.02, sd: int = -1, acc: torch.Tensor | None = None):
    """One path direction of the aggregation over vol (D, S, N): pixel
    (x, y) continues the path from (x - sx, y - sy), ``step`` = (sx, sy).
    Returns Lr (D, S, N) float32 with the lattice of ``sd`` (masked entries
    0), or ``acc`` + Lr, added in place. ``semi_global_matching`` is the sum
    of its directions: (0, 1), (0, -1), (1, 0), (-1, 0), then the diagonals
    (1, 1), (-1, 1), (1, -1), (-1, -1)."""
    D, S, N = vol.shape
    sx, sy = _check_step(step)
    if sd not in (-1, 1):
        raise ValueError(f"sd must be -1 or 1, got {sd}")
    v = vol.to(torch.float32)
    img = img.to(torch.float32)
    if sy == 0:  # lines are rows: scan along x
        m = _lattice(D, N, sd, N, 0, vol.device).T[:, :, None].expand(N, D, S)
        lr = _scan_direction(v.permute(2, 0, 1), img.T, m, P1, P2, sx < 0).permute(1, 2, 0)
    else:
        lr = _vertical(v, img, P1, P2, sd, N, 0, sy < 0, dx=sx)
    return _finish(lr, acc)


def semi_global_matching(vol: torch.Tensor, img: torch.Tensor, P1: float = 0.01,
                         P2: float = 0.02, do_horiz: bool = True, do_vert: bool = True,
                         do_reverse: bool = True, do_diagonal: bool = False,
                         sd: int = -1, seam_period: int | None = None) -> torch.Tensor:
    """4-path (8-path with ``do_diagonal``) SGM aggregation of a (D, H, W)
    cost volume guided by the (H, W) image; returns the float32 aggregate
    (D, H, W). ``sd`` selects the lattice: -1 for a left-anchored volume,
    +1 for a right-anchored one. The four diagonals always run when
    ``do_diagonal`` is set; the flags select only the straight pairs.
    ``seam_period`` re-seeds the vertical paths every that many rows, so
    frames stacked along the rows aggregate as if each were alone (4-path
    only; the horizontal paths never cross a row)."""
    D, H, W = vol.shape
    if seam_period is not None:
        _check_scan(H, W, False, W, 0, seam_period)
        if do_diagonal:
            raise ValueError("a stacked batch (seam_period) aggregates 4 paths only")
    v = vol.to(torch.float32)
    img = img.to(torch.float32)
    lattice = _lattice(D, W, sd, W, 0, vol.device)  # (D, W)

    out = torch.zeros_like(v)
    if do_vert:
        for rev in ((False, True) if do_reverse else (False,)):
            out = out + _vertical(v, img, P1, P2, sd, W, 0, rev, seam_period)
    if do_horiz:
        # scan along x: (W, D, H), lines are rows; the lattice follows x
        vh = v.permute(2, 0, 1)
        mh = lattice.T[:, :, None].expand(W, D, H)
        for rev in ((False, True) if do_reverse else (False,)):
            out = out + _scan_direction(vh, img.T, mh, P1, P2, rev).permute(1, 2, 0)
    if do_diagonal:
        vv = v.permute(1, 0, 2)
        mv = lattice[None].expand(H, D, W)
        for rev in (False, True):
            for dx in (1, -1):
                out = out + _scan_direction(vv, img, mv, P1, P2, rev, dx).permute(1, 0, 2)
    return out
