"""Cost-volume reductions (``kangaroo_tpu/stereo/costvolume.py``): WTA
disparity, subpixel refinement, the DTAM auxiliary search, edge weights,
right re-anchoring, the LR check, the truncated abs-and-gradient volume,
and the running-mean (CostVolElem) volumes of ``MultiViewStereo``.

Volumes are (D, H, W); disparity images are (H, W) float32 with NaN for
invalid, or int32. ``cost_vol_minimum_subpix``,
``cost_vol_minimum_square_penalty_subpix``, ``left_right_check`` and
``left_right_check_pair`` are the plain versions of the WTA, auxiliary-search
and LR-check kernels (``stereo/dispatch.py`` picks between them);
``cost_volume_add`` picks between its plain version and its kernel itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..backend import f32_scalars
from ..core import invalid as invalid_mod
from ..utils import profiling
from . import census as census_mod
from . import costvolume_cuda

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


def cost_vol_minimum_square_penalty_subpix(vol: torch.Tensor, last_disp: torch.Tensor, lam,
                                           theta, sd: int = -1) -> torch.Tensor:
    """The DTAM auxiliary search: argmin_d (last - d)^2 / (2 theta) + lam C(d)
    over the d with x + sd*d in the image, then the parabola step through the
    penalised costs at bestd-1 and bestd+1 (the volume read clamped to
    [0, D-1], the penalty at the unclamped index), kept where the match is
    strictly interior and the step stays within (best-1, best+1).

    The plain version of the ``wta_sq`` kernel. ``lam`` and ``theta`` are
    numbers or 0-dim tensors; both are taken as float32, and 1/(2 theta)
    is a float32 division, as in ``kangaroo_tpu``."""
    vol = vol.to(torch.float32)
    D, H, W = vol.shape
    lam, theta = f32_scalars(vol.device, lam, theta)
    last = last_disp.to(torch.float32)
    inv2theta = 1.0 / (2.0 * theta)
    d = torch.arange(D, dtype=torch.float32, device=vol.device)[:, None, None]
    dd = last[None] - d
    cost = inv2theta * (dd * dd) + lam * vol
    ok = _xr_valid(W, D, sd, vol.device)[:, None, :]
    masked = torch.where(ok, cost, _BIG)
    bestd = torch.argmin(masked, dim=0)  # first index attaining the min
    bestc = masked.gather(0, bestd[None])[0]

    bf = bestd.to(torch.float32)
    dlf, drf = bf - 1.0, bf + 1.0
    vl = vol.gather(0, (bestd - 1).clamp(0, D - 1)[None])[0]
    vr = vol.gather(0, (bestd + 1).clamp(0, D - 1)[None])[0]
    el, er = last - dlf, last - drf
    cl = inv2theta * (el * el) + lam * vl
    cr = inv2theta * (er * er) + lam * vr
    subpix = bf - (cr - cl) / (2.0 * (cr - 2.0 * bestc + cl))

    bestxr = torch.arange(W, device=vol.device)[None, :] + sd * bestd
    interior = (bestxr > 0) & (bestxr < W - 1)
    sensible = (subpix > dlf) & (subpix < drf)
    return torch.where(interior & sensible, subpix, bf)


@profiling.spanned("stage")
def exponential_edge_weight(img: torch.Tensor, alpha, beta) -> torch.Tensor:
    """g = exp(-alpha |grad I|^beta) with central differences, zero on the
    image border."""
    H, W = img.shape
    alpha, beta = f32_scalars(img.device, alpha, beta)
    gx = (torch.roll(img, -1, 1) - torch.roll(img, 1, 1)) / 2.0
    gy = (torch.roll(img, -1, 0) - torch.roll(img, 1, 0)) / 2.0
    x = torch.arange(W, device=img.device)[None, :]
    y = torch.arange(H, device=img.device)[:, None]
    gx = torch.where((x > 0) & (x < W - 1), gx, 0.0)
    gy = torch.where((y > 0) & (y < H - 1), gy, 0.0)
    mag = torch.sqrt(gx * gx + gy * gy)
    return torch.exp(-alpha * torch.pow(mag, beta))


def _central_diff_image(img: torch.Tensor):
    """Central differences (dx, dy) with the reference's clamped-neighbour
    one-sided halves on the border."""
    dx = (torch.roll(img, -1, 1) - torch.roll(img, 1, 1)) / 2.0
    dy = (torch.roll(img, -1, 0) - torch.roll(img, 1, 0)) / 2.0
    dx[:, 0] = (img[:, 1] - img[:, 0]) / 2.0
    dx[:, -1] = (img[:, -1] - img[:, -2]) / 2.0
    dy[0] = (img[1] - img[0]) / 2.0
    dy[-1] = (img[-1] - img[-2]) / 2.0
    return dx, dy


def filter_disp_grad(disp: torch.Tensor, threshold) -> torch.Tensor:
    """Set to -1 the pixels whose squared disparity gradient reaches
    ``threshold``."""
    dx, dy = _central_diff_image(disp)
    (threshold,) = f32_scalars(disp.device, threshold)
    return torch.where(dx * dx + dy * dy < threshold, disp, -1.0)


def cost_volume_from_stereo_truncated_abs_and_grad(img_l: torch.Tensor, img_r: torch.Tensor,
                                                   max_disp: int, sd: int = -1, alpha=0.0,
                                                   r1=1e37, r2=1e37) -> torch.Tensor:
    """(max_disp, H, W) float32 volume of the truncated intensity and
    x-gradient differences (1 - alpha) min(|dI|, r1) + alpha min(|dgx|, r2),
    (1 - alpha) r1 + alpha r2 where x + sd*d leaves the image."""
    H, W = img_l.shape
    gx_l, _ = _central_diff_image(img_l)
    gx_r, _ = _central_diff_image(img_r)
    alpha, r1, r2 = f32_scalars(img_l.device, alpha, r1, r2)
    oob = (1.0 - alpha) * r1 + alpha * r2
    x = torch.arange(W, device=img_l.device)
    slices = []
    for d in range(max_disp):
        xr = x + sd * d
        ok = (xr >= 0) & (xr < W)
        xi = xr.clamp(0, W - 1)
        abs_i = (img_r[:, xi] - img_l).abs()
        abs_g = (gx_r[:, xi] - gx_l).abs()
        cost = (1.0 - alpha) * torch.minimum(abs_i, r1) + alpha * torch.minimum(abs_g, r2)
        slices.append(torch.where(ok[None, :], cost, oob))
    return torch.stack(slices, dim=0)


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


def left_right_check_pair(disp_l: torch.Tensor, disp_r: torch.Tensor, max_diff: float = 0.5,
                          max_disp: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Both directions of a frame in the reference's order: the right
    disparity against the left first, then the left against the checked
    right, so the second check also rejects left pixels whose partner was
    rejected. Returns (disp_l', disp_r'); the plain version of the pair
    kernel (``stereo/lr_cuda.left_right_check_pair``)."""
    disp_r = left_right_check(disp_r, disp_l, 1, max_diff, max_disp)
    return left_right_check(disp_l, disp_r, -1, max_diff, max_disp), disp_r


# --- running-mean (CostVolElem) volumes: a count n and a sum s per cell ------


def _box_zero_padded(img: torch.Tensor, rad: int) -> torch.Tensor:
    """Sum over the (2rad+1)^2 window, zeros outside the image."""
    k = 2 * rad + 1
    s = torch.cumsum(F.pad(img, (0, 0, rad + 1, rad)), dim=0)
    img = s[k:] - s[:-k]
    s = torch.cumsum(F.pad(img, (rad + 1, rad)), dim=1)
    return s[:, k:] - s[:, :-k]


@profiling.spanned("stage")
def cost_volume_from_stereo(img_l: torch.Tensor, img_r: torch.Tensor, max_disp: int,
                            sd: int = -1, rad: int = 2):
    """Zero-mean SAD patch volume of a rectified pair as a running-mean
    accumulator: returns (n, s), (max_disp, H, W) float32, n = 1 where the
    left patch and the patch at x + sd*d both lie inside the image, else 0
    (s = 0 there). All disparities at once, as (D, H, W) tensor ops."""
    H, W = img_l.shape
    dev = img_l.device
    f_l, f_r = img_l.to(torch.float32), img_r.to(torch.float32)
    (n_pix,) = f32_scalars(dev, (2 * rad + 1) ** 2)
    mean_l = _box_zero_padded(f_l, rad) / n_pix
    mean_r = _box_zero_padded(f_r, rad) / n_pix

    x = torch.arange(W, device=dev)
    y = torch.arange(H, device=dev)[:, None]
    in_l = (x[None, :] >= rad) & (x[None, :] < W - rad) & (y >= rad) & (y < H - rad)
    xr = x[None, :] + sd * torch.arange(max_disp, device=dev)[:, None]  # (D, W)
    ok = in_l[None] & ((xr >= rad) & (xr < W - rad))[:, None, :]
    xi = xr.clamp(0, W - 1)

    def columns(img, cols):
        """img[:, cols] for (D, W) columns -> (D, H, W)."""
        return img[:, cols.reshape(-1)].reshape(H, max_disp, W).transpose(0, 1)

    mean_r_at = columns(mean_r, xi)
    acc = torch.zeros((max_disp, H, W), dtype=torch.float32, device=dev)
    for dy in range(-rad, rad + 1):
        ys = (y[:, 0] + dy).clamp(0, H - 1)
        row_l, row_r = f_l[ys], f_r[ys]
        for dx in range(-rad, rad + 1):
            a = row_l[:, (x + dx).clamp(0, W - 1)] - mean_l
            b = columns(row_r, (xi + dx).clamp(0, W - 1)) - mean_r_at
            acc += (a - b).abs()
    return ok.to(torch.float32), torch.where(ok, acc, 0.0)


def cost_elem_to_float(n: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The running mean s / n, 1e30 where n == 0."""
    return torch.where(n > 0, s / torch.clamp(n, min=1.0), 1e30)


def cost_volume_zero(max_disp: int, h: int, w: int, device="cuda"):
    """An empty running-mean volume: (n, s), both zero."""
    return tuple(torch.zeros((max_disp, h, w), dtype=torch.float32, device=device)
                 for _ in range(2))


def _bilinear_finite(flat: torch.Tensor, H: int, W: int, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """``core.sampling.bilinear`` of the (H, W) image ``flat`` (flattened)
    at finite coordinates, with row-major float offsets (exact below 2**24
    pixels), one int64 index alive at a time, and each lerp a fused
    multiply-add (as XLA computes it on the CPU)."""
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    ix0 = x0.clamp(0, W - 1)
    ix1 = x0.add_(1.0).clamp_(0, W - 1)
    r0 = y0.clamp(0, H - 1).mul_(W)
    r1 = y0.add_(1.0).clamp_(0, H - 1).mul_(W)

    def at(r, c):
        return flat[(r + c).long()]

    tl = at(r0, ix0)
    top = torch.addcmul(tl, at(r0, ix1).sub_(tl), fx)
    bl = at(r1, ix0)
    bot = torch.addcmul(bl, at(r1, ix1).sub_(bl), fx)
    return torch.addcmul(top, bot.sub_(top), fy)


@profiling.spanned("stage")
def cost_volume_add(n: torch.Tensor, s: torch.Tensor, img_v: torch.Tensor, img_c: torch.Tensor,
                    KT_cv: torch.Tensor, K, baseline, rad: int = 1):
    """Accumulate a posed view into the running-mean volume (n, s) of the
    keyframe ``img_v``: each (d, v, u) is unprojected at depth
    fu * baseline / max(d, 1e-9) in the keyframe camera, projected through
    KT_cv (3, 4) into the contributing image ``img_c``, and where it lands
    in front of the camera and 5 pixels inside the image, n gains 1 and s
    the zero-mean SAD over the (2rad+1)^2 patch (img_v at integer taps,
    img_c bilinear) divided by the patch area. Returns the new (n, s).

    On the CPU the plain version (``_cost_volume_add_plain``); any other
    tensor takes the kernel (``csrc/cost_volume_add.cu``, one launch a
    view, the same bits), which raises off an sm_90 card, with the plain
    version's gradient."""
    kw = dict(K=K, baseline=baseline, rad=rad)
    if n.device.type == "cpu":
        return _cost_volume_add_plain(n, s, img_v, img_c, KT_cv, **kw)
    from .dispatch import _KernelOp  # dispatch imports this module

    return _KernelOp.apply(costvolume_cuda.cost_volume_add, _cost_volume_add_plain, kw,
                           n, s, img_v, img_c, KT_cv)


def _cost_volume_add_plain(n: torch.Tensor, s: torch.Tensor, img_v: torch.Tensor,
                           img_c: torch.Tensor, KT_cv: torch.Tensor, K, baseline,
                           rad: int = 1):
    """``cost_volume_add`` as (D, H, W) tensor ops, all disparities at once;
    the contributing image's bilinear taps are sampled once and serve both
    its patch mean and the SAD. The kernel's yardstick."""
    D, H, W = n.shape
    dev = n.device
    fv_img, fc_img = img_v.to(torch.float32), img_c.to(torch.float32)
    fu, fv, base, area, tiny = f32_scalars(dev, K.fu, K.fv, baseline, (2 * rad + 1) ** 2, 1e-9)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    d = torch.arange(D, dtype=torch.float32, device=dev)
    z = (fu * base / torch.maximum(d, tiny))[:, None, None]
    P = (z * (u - K.u0) / fu, z * (v - K.v0) / fv, z)
    M = KT_cv.to(torch.float32)

    def row(i):
        """(P @ M[:, :3].T + M[:, 3])[..., i], the products summed by fused
        multiply-adds in the order of the JAX package's CPU dot."""
        acc = torch.addcmul(P[0] * M[i, 0], P[1], M[i, 1])
        return torch.addcmul(acc, P[2], M[i, 2]) + M[i, 3]

    kz = row(2)
    pu, pv = row(0) / kz, row(1) / kz
    ok = (kz > 0) & (pu >= 5) & (pu < W - 5) & (pv >= 5) & (pv < H - 5)
    del P, kz
    # the samples of cells that are not ok are discarded: keep their
    # coordinates finite for the gather
    pu, pv = torch.where(ok, pu, 0.0), torch.where(ok, pv, 0.0)

    taps = [(dy, dx) for dy in range(-rad, rad + 1) for dx in range(-rad, rad + 1)]
    flat = fc_img.reshape(-1)
    b = [_bilinear_finite(flat, H, W, pu + dx, pv + dy) for dy, dx in taps]
    del pu, pv
    a = [census_mod.shift_clamped(fv_img, dy, dx) for dy, dx in taps]
    mean_v = torch.zeros_like(fv_img)
    mean_c = torch.zeros((D, H, W), dtype=torch.float32, device=dev)
    for a_k, b_k in zip(a, b):
        mean_v = mean_v + a_k
        mean_c += b_k
    mean_v = mean_v / area
    mean_c /= area
    acc = torch.zeros_like(mean_c)
    for a_k, b_k in zip(a, b):
        acc += torch.sub(a_k - mean_v, b_k.sub_(mean_c)).abs_()
    del b
    return n + ok.to(torch.float32), s + torch.where(ok, acc.div_(area), 0.0)
