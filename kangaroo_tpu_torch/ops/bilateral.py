"""Bilateral filtering (``kangaroo_tpu/ops/bilateral.py``): the plain
spatial + range filter, the min-value-masked form that KinectFusion runs
on depth, the cross (joint) filter guided by a second image, and its
per-slice form over a (D, H, W) cost volume, the SGM frame's
``bilateral_filter``. A brute-force window of shifted copies with clamped
borders, plain PyTorch on the input's device; the weights multiply in the
JAX package's order (spatial, then self range, then guide range), with
the constants as float32 tensors on the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..backend import constant, f32_scalars


def _offsets(size: int):
    return [(r, c) for r in range(-size, size + 1) for c in range(-size, size + 1)]


def _padded(f: torch.Tensor, size: int) -> torch.Tensor:
    return F.pad(f[None, None], (size,) * 4, mode="replicate")[0, 0]


def _range_scale(device, g):
    """-1 / (2 g^2) as a float32 scalar on ``device`` (the JAX package's
    traced float32 arguments)."""
    (g,) = f32_scalars(device, g)
    return -1.0 / (2.0 * g * g)


def bilateral(img: torch.Tensor, gs, gr, size: int = 5) -> torch.Tensor:
    """Plain bilateral filter."""
    f = img.to(torch.float32)
    H, W = f.shape
    padded = _padded(f, size)
    inv2gs2, inv2gr2 = _range_scale(f.device, gs), _range_scale(f.device, gr)
    s, sw = torch.zeros_like(f), torch.zeros_like(f)
    for r, c in _offsets(size):
        q = padded[size + r:size + r + H, size + c:size + c + W]
        w = torch.exp((r * r + c * c) * inv2gs2) * torch.exp((f - q) ** 2 * inv2gr2)
        s = s + w * q
        sw = sw + w
    return s / sw


def bilateral_above_min(img: torch.Tensor, gs, gr, size: int, minval) -> torch.Tensor:
    """Bilateral filter that ignores samples below ``minval``; a pixel whose
    centre is below it (or NaN) comes out NaN, which is how KinectFusion
    turns too-close or missing depth into invalid depth."""
    f = img.to(torch.float32)
    H, W = f.shape
    padded = _padded(f, size)
    inv2gs2, inv2gr2 = _range_scale(f.device, gs), _range_scale(f.device, gr)
    minval, = f32_scalars(f.device, minval)
    s, sw = torch.zeros_like(f), torch.zeros_like(f)
    for r, c in _offsets(size):
        q = padded[size + r:size + r + H, size + c:size + c + W]
        ok = q >= minval
        w = torch.where(ok, torch.exp((r * r + c * c) * inv2gs2)
                        * torch.exp((f - q) ** 2 * inv2gr2), 0.0)
        s = s + w * torch.where(ok, q, 0.0)
        sw = sw + w
    return torch.where(f >= minval, s / sw, float("nan"))


def _spatial_weights(device, gs, size: int) -> torch.Tensor:
    """exp(-(r^2 + c^2) / (2 gs^2)) of every tap, in ``_offsets`` order."""
    r2 = constant(tuple(float(r * r + c * c) for r, c in _offsets(size)), device=device)
    return torch.exp(r2 * _range_scale(device, gs))


def _range_weight(p: torch.Tensor, q: torch.Tensor, scale) -> torch.Tensor:
    d = p - q
    return torch.exp(d * d * scale)


def bilateral_cross(img: torch.Tensor, guide: torch.Tensor, gs, gr, size: int,
                    gc=None) -> torch.Tensor:
    """Cross (joint) bilateral filter of ``img`` guided by ``guide``, both
    (H, W). With ``gc`` each tap weighs spatial (``gs``) x self range on
    the filtered values (``gr``) x guide range (``gc``), the reference's
    three Gaussians; with ``gc=None`` the self-range term is dropped and
    ``gr`` applies to the guide (the joint-bilateral form)."""
    f = img.to(torch.float32)
    g = guide.to(torch.float32)
    H, W = f.shape
    pf, pg = _padded(f, size), _padded(g, size)
    spatial = _spatial_weights(f.device, gs, size)
    inv2gr2 = _range_scale(f.device, gr)
    inv2gc2 = None if gc is None else _range_scale(f.device, gc)
    s, sw = torch.zeros_like(f), torch.zeros_like(f)
    for k, (r, c) in enumerate(_offsets(size)):
        q = pf[size + r:size + r + H, size + c:size + c + W]
        qg = pg[size + r:size + r + H, size + c:size + c + W]
        if gc is None:
            w = spatial[k] * _range_weight(g, qg, inv2gr2)
        else:
            w = spatial[k] * _range_weight(f, q, inv2gr2) * _range_weight(g, qg, inv2gc2)
        s = s + w * q
        sw = sw + w
    # the centre tap weighs exp(0) = 1 in every form, so sw > 0
    return s / sw


def bilateral_volume(vol: torch.Tensor, guide: torch.Tensor, gs, gr, size: int = 2,
                     gc=None) -> torch.Tensor:
    """``bilateral_cross`` of every slice of a (D, H, W) cost volume against
    the (H, W) guide, float32 out. The guide's term is computed once a tap
    on (H, W) and broadcast over the slices, so the filter loops over the
    window's (2 size + 1)^2 taps only, not over D. With ``gc=None`` the
    weights depend on the guide alone and their sum is one (H, W) plane."""
    f = vol.to(torch.float32)
    g = guide.to(torch.float32)
    _, H, W = f.shape
    pf = F.pad(f[None], (size,) * 4, mode="replicate")[0]
    pg = _padded(g, size)
    spatial = _spatial_weights(f.device, gs, size)
    inv2gr2 = _range_scale(f.device, gr)
    inv2gc2 = None if gc is None else _range_scale(f.device, gc)
    s = torch.zeros_like(f)
    sw = torch.zeros_like(f if gc is not None else g)
    for k, (r, c) in enumerate(_offsets(size)):
        q = pf[:, size + r:size + r + H, size + c:size + c + W]
        qg = pg[size + r:size + r + H, size + c:size + c + W]
        if gc is None:
            w = spatial[k] * _range_weight(g, qg, inv2gr2)
        else:
            # spatial x self range x guide range, as bilateral_cross
            # multiplies them; in place, one volume temporary a tap
            w = f - q
            w.mul_(w).mul_(inv2gr2).exp_().mul_(spatial[k]).mul_(_range_weight(g, qg, inv2gc2))
        s += w * q
        sw += w
    return s / sw
