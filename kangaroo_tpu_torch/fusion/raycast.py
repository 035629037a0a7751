"""SDF raycasting by sphere tracing, and Phong shading
(``kangaroo_tpu/fusion/raycast.py``).

``raycast_sdf`` is the exact whole-image march: every live ray advances by
max(sdf, voxel) per step on trilinear samples until all rays have hit or
left the volume. It renders the synthetic KinectFusion frames. Its
nearest-sample march, ``skip_unobserved``, the colour volume and the
warm start (``lam_init``/``done_init``), and ``raycast_sdf_guided``,
``raycast_box``, ``raycast_sphere`` and ``raycast_plane``, are not ported
yet.
"""
from __future__ import annotations

import torch

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


def raycast_sdf(vol, T_wc: torch.Tensor, K, w: int, h: int, near=0.1, far=10.0,
                trunc_dist=None, subpix: bool = True, max_steps: int = 512):
    """Raycast the TSDF. Returns (depth (h, w) with NaN misses, normals
    (h, w, 4) camera-frame with w = 1 on hits, Phong image). ``trunc_dist``
    is accepted for the JAX signature; the exact march does not use it."""
    dev = vol.val.device
    c_w = se3.translation(T_wc)
    ray_c = K.unproject_grid(w, h, device=dev)
    ray_w = se3.rotate(T_wc, ray_c)
    max_tmin, min_tmax = _ray_box(vol.bbox, c_w, ray_w, near, far)
    voxel = vol.voxel_size_units()[0]

    lam = max_tmin
    last_sdf = torch.full((h, w), float("nan"), dtype=torch.float32, device=dev)
    last_delta = torch.zeros((h, w), dtype=torch.float32, device=dev)
    depth = torch.zeros((h, w), dtype=torch.float32, device=dev)
    done = ~(max_tmin < min_tmax)
    for step in range(max_steps):
        if step % _DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        sdf = vol.sample_trilinear_world(c_w + lam[..., None] * ray_w)
        crossed = (sdf <= 0) & ~done
        surface = crossed & (last_sdf > 0)
        lam_hit = lam + last_delta * sdf / (last_sdf - sdf) if subpix else lam
        depth = torch.where(surface, lam_hit, depth)
        done_now = done | crossed
        # NaN sdf (unobserved voxels) marches at the minimum step
        delta = torch.where(torch.isnan(sdf), voxel, torch.maximum(sdf, voxel))
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
    img = phong_shade(depth[..., None] * ray_c, n_c)
    depth_out = torch.where(hit, depth, float("nan"))
    img_out = torch.where(hit, img, 0.0)
    ones = torch.ones((h, w, 1), dtype=torch.float32, device=dev)
    norm_out = torch.where(hit[..., None], torch.cat([n_c, ones], dim=-1), 0.0)
    return depth_out, norm_out, img_out
