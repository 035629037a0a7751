"""Integral images, box filtering and the guided filter
(``kangaroo_tpu/ops/integral_image.py``).

``box_filter`` is the mean over the window [x-rad, x+rad] x [y-rad, y+rad]
clamped to the image (the JAX package's corrected form of the reference's
4-corner lookup). It takes the JAX package's two routes: for rad <= 16 a
zero-padded window sum along each axis, summed in window order, divided by
the clamped window area; above that an inclusive integral image and its
four clamped corners (``box_filter_integral_image`` takes that integral
image as it is, front-padded to (H+1, W+1)). Plain PyTorch on every
device; the JAX package runs these as XLA outside any Pallas kernel.
Every function takes (..., H, W) and works on the last two axes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..backend import f32_scalars

# the largest radius summed directly (kangaroo_tpu box_filter's switch)
_DIRECT_MAX_RAD = 16


def _window_area(H: int, W: int, rad: int, device=None) -> torch.Tensor:
    """(H, W) float32 count of pixels in each clamped window."""
    y = torch.arange(H, device=device)
    x = torch.arange(W, device=device)
    ny = (y + rad).clamp(0, H - 1) - (y - rad).clamp(0, H - 1) + 1
    nx = (x + rad).clamp(0, W - 1) - (x - rad).clamp(0, W - 1) + 1
    return (ny[:, None] * nx[None, :]).to(torch.float32)


def _window_sum(f: torch.Tensor, rad: int, dim: int) -> torch.Tensor:
    """Zero-padded sum over [i-rad, i+rad] along ``dim`` (-2 or -1), added
    in window order as reduce_window does."""
    n = f.shape[dim]
    pad = (0, 0, rad, rad) if dim == -2 else (rad, rad)
    p = F.pad(f, pad)
    s = torch.zeros_like(f)
    for k in range(2 * rad + 1):
        s = s + p.narrow(dim, k, n)
    return s


def prefix_sum_rows(img: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along each row, float32."""
    return torch.cumsum(img.to(torch.float32), dim=-1)


def transpose(img: torch.Tensor) -> torch.Tensor:
    """The image transposed: (W, H) from (H, W)."""
    return img.transpose(-2, -1)


def integral_image(img: torch.Tensor) -> torch.Tensor:
    """Inclusive 2-D integral image, float32: a scan down the columns, then
    along the rows."""
    return torch.cumsum(torch.cumsum(img.to(torch.float32), dim=-2), dim=-1)


def _box_sum(ii: torch.Tensor, rad: int) -> torch.Tensor:
    """Clamped-window sums from an (H+1, W+1) front-padded inclusive
    integral image: its four corners at rows clip(y - rad) and
    min(y + rad + 1, H), columns likewise."""
    H, W = ii.shape[-2] - 1, ii.shape[-1] - 1
    y = torch.arange(H, device=ii.device)
    x = torch.arange(W, device=ii.device)
    r_lo, r_hi = (y - rad).clamp(0, H - 1), (y + rad + 1).clamp(max=H)
    c_lo, c_hi = (x - rad).clamp(0, W - 1), (x + rad + 1).clamp(max=W)

    def at(rows, cols):
        return ii.index_select(-2, rows).index_select(-1, cols)

    return at(r_hi, c_hi) + at(r_lo, c_lo) - at(r_lo, c_hi) - at(r_hi, c_lo)


def box_filter(img: torch.Tensor, rad: int) -> torch.Tensor:
    """Mean over the clamped (2 rad + 1)^2 window, float32."""
    f = img.to(torch.float32)
    H, W = f.shape[-2:]
    if rad <= _DIRECT_MAX_RAD:
        s = _window_sum(_window_sum(f, rad, -2), rad, -1)
    else:
        s = _box_sum(F.pad(integral_image(f), (1, 0, 1, 0)), rad)
    return s / _window_area(H, W, rad, f.device)


def box_filter_integral_image(ii_padded: torch.Tensor, rad: int) -> torch.Tensor:
    """Box mean over the clamped window from an (H+1, W+1) zero-padded
    inclusive integral image (``F.pad(integral_image(img), (1, 0, 1, 0))``)."""
    H, W = ii_padded.shape[-2] - 1, ii_padded.shape[-1] - 1
    return _box_sum(ii_padded, rad) / _window_area(H, W, rad, ii_padded.device)


def mean_variance(I: torch.Tensor, rad: int):
    """(var_I, mean_II, mean_I) over the clamped window."""
    mean_i = box_filter(I, rad)
    mean_ii = box_filter(I * I, rad)
    return mean_ii - mean_i * mean_i, mean_ii, mean_i


def covariance(P: torch.Tensor, I: torch.Tensor, mean_i: torch.Tensor, rad: int):
    """(cov_IP, mean_IP, mean_P) over the clamped window."""
    mean_p = box_filter(P, rad)
    mean_ip = box_filter(I * P, rad)
    return mean_ip - mean_i * mean_p, mean_ip, mean_p


def _guided_with_stats(P, I, var_i, mean_i, rad: int, eps):
    cov_ip, _, mean_p = covariance(P, I, mean_i, rad)
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return box_filter(a, rad) * I + box_filter(b, rad)


def guided_filter(P: torch.Tensor, I: torch.Tensor, rad: int, eps) -> torch.Tensor:
    """Guided image filter (He, Sun, Tang 2010): q = mean_a I + mean_b."""
    (eps,) = f32_scalars(P.device, eps)
    var_i, _, mean_i = mean_variance(I, rad)
    return _guided_with_stats(P, I, var_i, mean_i, rad, eps)


def guided_filter_volume(vol: torch.Tensor, I: torch.Tensor, rad: int, eps) -> torch.Tensor:
    """Guided-filter every slice of a (D, H, W) cost volume against the
    (H, W) guide ``I``, whose statistics are computed once. float32 out."""
    (eps,) = f32_scalars(vol.device, eps)
    I = I.to(torch.float32)
    var_i, _, mean_i = mean_variance(I, rad)
    return _guided_with_stats(vol.to(torch.float32), I, var_i, mean_i, rad, eps)
