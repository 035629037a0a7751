"""Depth-map utilities (``kangaroo_tpu/geometry/depth.py``): disparity to
depth and to a point image, the Kinect near-range filter, depth to a point
image ("vbo"), point colouring, normals, and texturing a depth map from one
or several keyframes.
"""
from __future__ import annotations

import torch

from ..backend import f32_scalars
from ..core import sampling, se3


def disp_to_depth(disp: torch.Tensor, fu, baseline, min_disp=0.0) -> torch.Tensor:
    """depth = fu * baseline / disp, NaN below ``min_disp``."""
    fu, baseline = f32_scalars(disp.device, fu, baseline)
    return torch.where(disp >= min_disp, fu * baseline / disp, float("nan"))


def depth_from_disparity_vbo(disp: torch.Tensor, K, baseline, min_disp=16.0) -> torch.Tensor:
    """Disparity image -> (H, W, 4) points (x, y, z, w) at z = fu * baseline /
    disp: z NaN and w = 0 where disp < ``min_disp``, else w = 1."""
    H, W = disp.shape
    fu, fv, baseline = f32_scalars(disp.device, K.fu, K.fv, baseline)
    z = fu * baseline / disp
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=disp.device),
                          torch.arange(W, dtype=torch.float32, device=disp.device), indexing="ij")
    x = z * (u - K.u0) / fu
    y = z * (v - K.v0) / fv
    near = disp >= min_disp
    w = torch.where(near, 1.0, 0.0)
    return torch.stack([x, y, torch.where(near, z, float("nan")), w], dim=-1)


def filter_bad_kinect_data(depth_mm: torch.Tensor) -> torch.Tensor:
    """float32 depth with the returns closer than 200 mm set to NaN."""
    return torch.where(depth_mm >= 200.0, depth_mm.to(torch.float32), float("nan"))


def depth_to_vbo(depth: torch.Tensor, K, depth_scale=1.0) -> torch.Tensor:
    """Unproject a depth image to a (H, W, 4) point image with w = 1."""
    H, W = depth.shape
    P = K.unproject_grid(W, H, depth_scale * depth)
    return torch.cat([P, torch.ones((H, W, 1), dtype=torch.float32, device=depth.device)], dim=-1)


def colour_vbo(points: torch.Tensor, img_c: torch.Tensor, KT_cd: torch.Tensor) -> torch.Tensor:
    """Project a point image through KT_cd (3, 4) into an (H, W, 3) colour
    image and sample it bilinearly: (H, W, 4) uint8 RGBA, alpha 255, zero
    where the projection leaves the image (1-pixel border)."""
    KP = points[..., :3] @ KT_cd[:, :3].T + KT_cd[:, 3]
    u, v = KP[..., 0] / KP[..., 2], KP[..., 1] / KP[..., 2]
    ok = sampling.in_bounds(img_c, u, v, 1)
    rgb = sampling.bilinear(img_c, u, v)
    rgba = torch.cat([rgb, torch.full(rgb.shape[:-1] + (1,), 255.0, device=rgb.device)], dim=-1)
    return torch.where(ok[..., None], rgba, 0.0).to(torch.uint8)


def normals_from_vbo(points: torch.Tensor) -> torch.Tensor:
    """Normals from forward differences of a point image -> (H, W, 4); w = 1
    marks valid, the last row and column get w = 0."""
    H, W = points.shape[:2]
    Vc = points[..., :3]
    a = torch.roll(Vc, -1, dims=1) - Vc
    b = torch.roll(Vc, -1, dims=0) - Vc
    axb = torch.linalg.cross(a, b, dim=-1)
    mag = torch.sqrt(axb[..., 0] * axb[..., 0] + axb[..., 1] * axb[..., 1]
                     + axb[..., 2] * axb[..., 2])[..., None]
    n = -axb / mag
    valid = torch.ones((H, W), dtype=torch.float32, device=points.device)
    valid[:, -1] = 0.0
    valid[-1, :] = 0.0
    n = torch.where(valid[..., None] > 0, n, 0.0)
    return torch.cat([n, valid[..., None]], dim=-1)


def _grey_to_rgb(rgb: torch.Tensor) -> torch.Tensor:
    return rgb[..., None].repeat_interleave(3, dim=-1) if rgb.dim() == 2 else rgb


def texture_depth(depth, normals, keyframe_img, K_kf, T_iw, T_wd, K_depth) -> torch.Tensor:
    """Texture a depth map from one keyframe: each point (through T_wd, depth
    camera to world, and T_iw, world to keyframe camera) takes the
    keyframe's bilinear colour / 255 where it projects 2 pixels inside it
    and its normal faces the keyframe (N.z < -0.2), else black. Returns
    (H, W, 4) float32, alpha 1."""
    H, W = depth.shape
    P_w = se3.transform(T_wd, K_depth.unproject_grid(W, H, depth))
    N_w = se3.rotate(T_wd, normals[..., :3])
    P_kf = se3.transform(T_iw, P_w)
    p = K_kf.project(P_kf)
    N_c = se3.rotate(T_iw, N_w)
    ok = sampling.in_bounds(keyframe_img, p[..., 0], p[..., 1], 2) & (N_c[..., 2] < -0.2)
    rgb = _grey_to_rgb(sampling.bilinear(keyframe_img, p[..., 0], p[..., 1])) / 255.0
    out = torch.where(ok[..., None], rgb, 0.0)
    return torch.cat([out, torch.ones((H, W, 1), dtype=torch.float32, device=depth.device)], -1)


def texture_depth_keyframes(depth, normals, phong, keyframes, T_wd, K_depth,
                            min_ndot=0.1) -> torch.Tensor:
    """Texture a depth map from several keyframes, a list of (img, K, T_iw):
    the colours weighted by the view alignment ndot = -N.P/|P| where the
    point projects 2 pixels inside, in front, with ndot > ``min_ndot``; the
    grey ``phong`` shading where no keyframe sees it. Returns (H, W, 4)
    float32, alpha 1."""
    H, W = depth.shape
    P_w = se3.transform(T_wd, K_depth.unproject_grid(W, H, depth))
    N_w = se3.rotate(T_wd, normals[..., :3])
    colour = torch.zeros((H, W, 3), dtype=torch.float32, device=depth.device)
    wsum = torch.zeros((H, W), dtype=torch.float32, device=depth.device)
    for img, K_kf, T_iw in keyframes:
        P_kf = se3.transform(T_iw, P_w)
        p = K_kf.project(P_kf)
        N_c = se3.rotate(T_iw, N_w)
        ndot = (N_c * P_kf).sum(-1) / -torch.linalg.vector_norm(P_kf, dim=-1)
        ok = (sampling.in_bounds(img, p[..., 0], p[..., 1], 2) & (ndot > min_ndot)
              & (P_kf[..., 2] > 0))
        rgb = _grey_to_rgb(sampling.bilinear(img, p[..., 0], p[..., 1]))
        w = torch.where(ok, ndot, 0.0)
        colour = colour + w[..., None] * rgb / 255.0
        wsum = wsum + w
    fallback = phong[..., None].repeat_interleave(3, dim=-1)
    out = torch.where(wsum[..., None] > 0, colour / torch.clamp(wsum, min=1e-9)[..., None],
                      fallback)
    return torch.cat([out, torch.ones((H, W, 1), dtype=torch.float32, device=depth.device)], -1)
