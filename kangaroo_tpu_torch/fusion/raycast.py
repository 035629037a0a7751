"""SDF raycasting by sphere tracing, analytic primitives and Phong shading
(``kangaroo_tpu/fusion/raycast.py``).

``raycast_sdf`` is the whole-image march: every live ray advances by
max(sdf, voxel) per step until all rays have hit or left the volume, on
trilinear samples (the reference's) or nearest ones (``march_sample=
'nearest'``, which can also stride through never-observed space,
``skip_unobserved``), from the box entry or a given warm start
(``lam_init``/``done_init``), shading with Phong or sampling a colour
volume. ``raycast_sdf_guided`` marches a 1/f image first and starts the
full-resolution rays just in front of each 3x3 neighbourhood's nearest hit
(the guided engine). ``raycast_box``, ``raycast_sphere`` and
``raycast_plane`` are the analytic primitives. All plain PyTorch on every
device: a step is a dozen small ops, and the march reads on the host once
per ``_DONE_CHECK_EVERY`` steps whether every ray is done.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..backend import constant
from ..containers.intrinsics import Intrinsics
from ..core import se3

# the march checks whether every ray is done once per this many steps (a
# host read); a step after all rays are done changes nothing
_DONE_CHECK_EVERY = 8


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2])


def phong_shade(p_c: torch.Tensor, n_c: torch.Tensor) -> torch.Tensor:
    """Phong shading (ambient 0.4, diffuse 0.4, specular 0.2)."""
    eyedir = -p_c / _norm(p_c)[..., None]
    lightdir = torch.tensor([0.4, 0.4, -1.0], dtype=torch.float32, device=p_c.device)
    lightdir = lightdir / _norm(lightdir)
    ldotn = (lightdir * n_c).sum(-1)
    lightreflect = 2.0 * ldotn[..., None] * n_c - lightdir
    edotr = torch.clamp((eyedir * lightreflect).sum(-1), min=0.0)
    return 0.4 + 0.4 * ldotn + 0.2 * edotr ** 10


def _ray_box(bbox, c_w, ray_w, near, far):
    """Williams slab test."""
    tminb = (bbox.lo - c_w) / ray_w
    tmaxb = (bbox.hi - c_w) / ray_w
    tmin = torch.minimum(tminb, tmaxb)
    tmax = torch.maximum(tminb, tmaxb)
    max_tmin = torch.clamp(tmin.amax(-1), min=near)
    min_tmax = torch.clamp(tmax.amin(-1), max=far)
    return max_tmin, min_tmax


def _nearest_sampler(vol):
    """The nearest march's sample: (val, weight) of the voxel nearest each
    position, one gather of the packed pair. The index is (pos - lo) / size
    * (n - 1) rounded half up, in that order."""
    Dv, Hv, Wv = vol.val.shape
    packed = torch.stack([vol.val, vol.weight], dim=-1).reshape(-1, 2)
    nvox = constant((Wv - 1, Hv - 1, Dv - 1), device=vol.val.device)

    def sample(pos_w):
        pf = (pos_w - vol.bbox.lo) / vol.bbox.size() * nvox
        ix, iy, iz = (torch.clamp(torch.floor(pf[..., a] + 0.5), 0, n - 1).nan_to_num(0.0).long()
                      for a, n in ((0, Wv), (1, Hv), (2, Dv)))
        got = packed[(iz * Hv + iy) * Wv + ix]
        return got[..., 0], got[..., 1]

    return sample


def raycast_sdf(vol, T_wc: torch.Tensor, K, w: int, h: int, near=0.1, far=10.0,
                trunc_dist=None, subpix: bool = True, max_steps: int = 512, color_vol=None,
                march_sample: str = "trilinear", skip_unobserved: float = 0.0, lam_init=None,
                done_init=None):
    """Raycast the TSDF. Returns (depth (h, w) with NaN misses, normals
    (h, w, 4) camera-frame with w = 1 on hits, image): the image is Phong
    shading, or the colour volume's trilinear samples with ``color_vol``.
    ``march_sample='nearest'`` marches on the nearest voxel's value, and
    ``skip_unobserved`` > 0 then strides that many voxels where its weight
    is 0. ``lam_init`` (h, w) starts each ray there (or at the box entry if
    later) and ``done_init`` marks rays that do not march. ``trunc_dist``
    is accepted for the JAX signature; the march does not use it."""
    if march_sample not in ("trilinear", "nearest"):
        raise ValueError(f"march_sample must be 'trilinear' or 'nearest', got {march_sample!r}")
    dev = vol.val.device
    c_w = se3.translation(T_wc)
    ray_c = K.unproject_grid(w, h, device=dev)
    ray_w = se3.rotate(T_wc, ray_c)
    max_tmin, min_tmax = _ray_box(vol.bbox, c_w, ray_w, near, far)
    voxel = vol.voxel_size_units()[0]
    done = ~(max_tmin < min_tmax)
    if lam_init is not None:
        lam = torch.maximum(max_tmin, lam_init)
        if done_init is not None:
            done = done | done_init
    else:
        lam = max_tmin
    if march_sample == "nearest":
        sample = _nearest_sampler(vol)
        skip = skip_unobserved * voxel if skip_unobserved > 0 else None
    else:
        sample, skip = (lambda pos_w: (vol.sample_trilinear_world(pos_w), None)), None

    last_sdf = torch.full((h, w), float("nan"), dtype=torch.float32, device=dev)
    last_delta = torch.zeros((h, w), dtype=torch.float32, device=dev)
    depth = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for step in range(max_steps):
        if step % _DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        sdf, obs_w = sample(c_w + lam[..., None] * ray_w)
        crossed = (sdf <= 0) & ~done
        surface = crossed & (last_sdf > 0)
        lam_hit = lam + last_delta * sdf / (last_sdf - sdf) if subpix else lam
        depth = torch.where(surface, lam_hit, depth)
        done_now = done | crossed
        # NaN sdf (unobserved voxels) marches at the minimum step
        delta = torch.where(torch.isnan(sdf), voxel, torch.maximum(sdf, voxel))
        if skip is not None:
            delta = torch.where(obs_w <= 0, skip, delta)
        lam_next = torch.where(done_now, lam, lam + delta)
        last_sdf = torch.where(done, last_sdf, sdf)
        last_delta = torch.where(done, last_delta, delta)
        done = done_now | (lam_next >= min_tmax)
        lam = lam_next

    pos_w = c_w + depth[..., None] * ray_w
    n_w = vol.grad_backward_world(pos_w)
    len_n = _norm(n_w)[..., None]
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev)
    n_w = torch.where(len_n > 0, n_w / torch.clamp(len_n, min=1e-20), up)
    n_c = se3.rotate_inv(T_wc, n_w)
    hit = depth > 0
    if color_vol is not None:
        img = color_vol.sample_trilinear_world(pos_w)
    else:
        img = phong_shade(depth[..., None] * ray_c, n_c)
    depth_out = torch.where(hit, depth, float("nan"))
    img_out = torch.where(hit, img, 0.0)
    ones = torch.ones((h, w, 1), dtype=torch.float32, device=dev)
    norm_out = torch.where(hit[..., None], torch.cat([n_c, ones], dim=-1), 0.0)
    return depth_out, norm_out, img_out


def raycast_sdf_guided(vol, T_wc: torch.Tensor, K, w: int, h: int, near=0.1, far=10.0,
                       trunc_dist=None, subpix: bool = True, max_steps: int = 512,
                       coarse_factor: int = 4, fine_steps: int = 24,
                       march_sample: str = "nearest", skip_unobserved: float = 4.0,
                       color_vol=None):
    """Coarse-to-fine raycast: march at 1/coarse_factor resolution without
    subpixel interpolation, then start the full-resolution rays 6 voxels in
    front of the nearest coarse hit of their 3x3 neighbourhood (edge-padded)
    and finish in at most ``fine_steps``. Pixels whose whole coarse
    neighbourhood misses are misses. Same returns as :func:`raycast_sdf`."""
    f = coarse_factor
    wc, hc = w // f, h // f
    d_c, _, _ = raycast_sdf(vol, T_wc, Intrinsics_scale(K, f), wc, hc, near, far, trunc_dist,
                            subpix=False, max_steps=max_steps, march_sample=march_sample,
                            skip_unobserved=skip_unobserved)
    voxel = vol.voxel_size_units()[0]
    big = torch.where(torch.isfinite(d_c), d_c, float("inf"))
    p = F.pad(big[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    start_c = torch.stack([p[dy:dy + hc, dx:dx + wc] for dy in range(3) for dx in range(3)]
                          ).amin(0)
    miss_c = ~torch.isfinite(start_c)

    def up(x):
        return x.repeat_interleave(f, dim=0).repeat_interleave(f, dim=1)[:h, :w]

    start, dead = up(start_c), up(miss_c)
    lam_init = torch.where(dead, 0.0, start - 6.0 * voxel)
    return raycast_sdf(vol, T_wc, K, w, h, near, far, trunc_dist, subpix=subpix,
                       max_steps=fine_steps, color_vol=color_vol, march_sample=march_sample,
                       skip_unobserved=skip_unobserved, lam_init=lam_init, done_init=dead)


def Intrinsics_scale(K, f: int) -> Intrinsics:
    """Intrinsics of a 1/f-resolution image (``K.level`` for a power of two),
    in float32."""
    l = int(math.log2(f))
    if 2 ** l == f:
        return K.level(l)
    s, half = np.float32(1.0 / f), np.float32(0.5)
    fu, fv, u0, v0 = (np.float32(v) for v in (K.fu, K.fv, K.u0, K.v0))
    return Intrinsics(float(fu * s), float(fv * s), float((u0 + half) * s - half),
                      float((v0 + half) * s - half))


def raycast_box(bbox, T_wc: torch.Tensor, K, w: int, h: int) -> torch.Tensor:
    """Depth of the box entry point, NaN on a miss (RaycastBox)."""
    c_w = se3.translation(T_wc)
    ray_w = se3.rotate(T_wc, K.unproject_grid(w, h, device=T_wc.device))
    tminb = (bbox.lo - c_w) / ray_w
    tmaxb = (bbox.hi - c_w) / ray_w
    max_tmin = torch.minimum(tminb, tmaxb).amax(-1)
    min_tmax = torch.maximum(tminb, tmaxb).amin(-1)
    return torch.where(max_tmin < min_tmax, max_tmin, float("nan"))


def _closer(depth, prev_depth):
    return (depth > 0) & (~(depth >= prev_depth) | ~torch.isfinite(prev_depth))


def raycast_sphere(prev_depth, T_wc: torch.Tensor, K, center, r, w: int, h: int,
                   shade: bool = True):
    """Analytic sphere depth, z-tested against ``prev_depth``
    (RaycastSphere). Returns (depth, shaded image or None)."""
    dev = T_wc.device
    ray_c = K.unproject_grid(w, h, device=dev)
    center_c = se3.transform_inv(T_wc, torch.as_tensor(center, dtype=torch.float32, device=dev))
    ldotc = (ray_c * center_c).sum(-1)
    lsq = (ray_c * ray_c).sum(-1)
    csq = torch.dot(center_c, center_c)
    disc = ldotc * ldotc - lsq * (csq - r * r)
    depth = (ldotc - torch.sqrt(disc)) / lsq
    closer = _closer(depth, prev_depth)
    out_depth = torch.where(closer, depth, prev_depth)
    img = None
    if shade:
        p_c = depth[..., None] * ray_c
        n_c = p_c - center_c
        n_c = n_c / _norm(n_c)[..., None]
        img = torch.where(closer, phong_shade(p_c, n_c), 0.0)
    return out_depth, img


def raycast_plane(prev_depth, T_wc: torch.Tensor, K, n_w, w: int, h: int):
    """Analytic plane n.x = -1 (RaycastPlane). Returns (depth, shaded image)."""
    dev = T_wc.device
    ray_c = K.unproject_grid(w, h, device=dev)
    n_c = se3.plane_b_from_a(T_wc, torch.as_tensor(n_w, dtype=torch.float32, device=dev))
    depth = -1.0 / (ray_c @ n_c)
    closer = _closer(depth, prev_depth)
    out_depth = torch.where(closer, depth, prev_depth)
    p_c = depth[..., None] * ray_c
    img = torch.where(closer, phong_shade(p_c, n_c / _norm(n_c)), 0.0)
    return out_depth, img
