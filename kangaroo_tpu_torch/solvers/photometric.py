"""Photometric (direct) pose-refinement systems (``kangaroo_tpu/solvers/photometric.py``).

Gauss-Newton normal equations for the pose of a live image against a
reference image with known geometry: a point image, a disparity map, or a
depth map seen by its own camera (the forward-compositional "ESM" builder
of the reference). Residual y = I_live(pi(K T_lr P_r)) - I_ref; the
Jacobian is the image gradient times the projection's derivative times
the SE3 generators; Tukey IRLS weights. Each builder returns an ``LSS``
through ``reduce_system``; plain PyTorch on the inputs' device, with no
host read.
"""
from __future__ import annotations

import torch

from ..core import reweighting, sampling, se3
from .lss import LSS, reduce_system


def _proj_jacobian_rows(dI, KP, KT, P):
    """J_i = dI * dpi(KP) * KT * gen_i(P) for dI (..., 2), the homogeneous
    projection KP (..., 3), KT (3, 4) and the pre-transform point P
    (..., 3). Returns (..., 6)."""
    z = KP[..., 2]
    a = dI[..., 0] / z
    b = dI[..., 1] / z
    cterm = -(dI[..., 0] * KP[..., 0] + dI[..., 1] * KP[..., 1]) / (z * z)
    v = torch.stack([a, b, cterm], dim=-1)
    vKT = v @ KT[:, :3]  # (..., 3): the translation part of v @ KT
    x, y_, zz = P[..., 0], P[..., 1], P[..., 2]
    J3 = -vKT[..., 1] * zz + vKT[..., 2] * y_
    J4 = vKT[..., 0] * zz - vKT[..., 2] * x
    J5 = -vKT[..., 0] * y_ + vKT[..., 1] * x
    return torch.cat([vKT, torch.stack([J3, J4, J5], dim=-1)], dim=-1)


def _gradient(img, u, v):
    return torch.stack(sampling.central_diff_bilinear(img, u, v), dim=-1)


def pose_refinement_from_points(img_live, img_ref, points_ref, KT_lr, c) -> LSS:
    """Photometric system from a reference point image: img_live/img_ref
    (H, W) grey, points_ref (H, W, 4) points in the reference frame, KT_lr
    (3, 4) = K T_lr, c the Tukey constant on the intensity difference."""
    Pr = points_ref[..., :3]
    KPl = se3.transform(KT_lr, Pr)
    pu = KPl[..., 0] / KPl[..., 2]
    pv = KPl[..., 1] / KPl[..., 2]
    in_img = sampling.in_bounds(img_live, pu, pv, 2)
    Il = sampling.bilinear(img_live, pu, pv)
    Ir = img_ref.to(torch.float32)
    y = Il - Ir
    J = _proj_jacobian_rows(_gradient(img_live, pu, pv), KPl, KT_lr, Pr)
    valid = torch.isfinite(Pr[..., 2]) & in_img & torch.isfinite(y)
    w = reweighting.weight_tukey(y, c)
    return reduce_system(J, y, w, valid)


def pose_refinement_from_disparity(img_live, img_ref, disp_ref, KT_lr, c, baseline, K,
                                   min_disp=16.0) -> LSS:
    """The points from a reference disparity map
    (``geometry/depth.depth_from_disparity_vbo``), then
    :func:`pose_refinement_from_points`."""
    from ..geometry.depth import depth_from_disparity_vbo

    points = depth_from_disparity_vbo(disp_ref, K, baseline, min_disp)
    return pose_refinement_from_points(img_live, img_ref, points, KT_lr, c)


def _project(Km, P):
    """Km (3, 3) pinhole applied to P (..., >= 3): (fu x + u0 z, fv y + v0 z, z)."""
    return torch.stack([Km[0, 0] * P[..., 0] + Km[0, 2] * P[..., 2],
                        Km[1, 1] * P[..., 1] + Km[1, 2] * P[..., 2], P[..., 2]], dim=-1)


def pose_refinement_from_depth_esm(img_live, img_ref, depth_ref, Klg, Krg, Krd, Tgd, Tlr, KlgTlr,
                                   c, discard_saturated: bool = False, min_depth=0.2,
                                   max_depth=20.0) -> LSS:
    """Forward-compositional photometric system from a reference depth map.

    Klg/Krg/Krd: (3, 3) intrinsics of the live grey, reference grey and
    reference depth cameras; Tgd (4, 4) reference depth -> reference grey;
    Tlr (4, 4) reference grey -> live grey; KlgTlr (3, 4) = Klg Tlr[:3]. Both
    images are sampled bilinearly; the Jacobian is the forward-compositional
    one (what the reference computes: its ESM average is commented out).
    ``discard_saturated`` drops pixels where either intensity is 0 or 255.
    """
    H, W = depth_ref.shape
    dev = depth_ref.device
    depth = depth_ref.to(torch.float32)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    # the 3d point in the reference depth camera, then the reference grey one
    Pr_d = torch.stack([depth * (u - Krd[0, 2]) / Krd[0, 0],
                        depth * (v - Krd[1, 2]) / Krd[1, 1], depth, torch.ones_like(depth)],
                       dim=-1)
    Pr_g = Pr_d @ Tgd.T
    KrPr = _project(Krg, Pr_g)
    pr_u = KrPr[..., 0] / KrPr[..., 2]
    pr_v = KrPr[..., 1] / KrPr[..., 2]
    # the live grey camera
    Pl = Pr_g @ Tlr.T
    KlPl = _project(Klg, Pl)
    pl_u = KlPl[..., 0] / KlPl[..., 2]
    pl_v = KlPl[..., 1] / KlPl[..., 2]

    depth_ok = torch.isfinite(depth) & (depth > min_depth) & (depth < max_depth)
    in_imgs = (sampling.in_bounds(img_ref, pr_u, pr_v, 2)
               & sampling.in_bounds(img_live, pl_u, pl_v, 2))
    Il = sampling.bilinear(img_live, pl_u, pl_v)
    Ir = sampling.bilinear(img_ref, pr_u, pr_v)
    y = Il - Ir
    valid = depth_ok & in_imgs & torch.isfinite(y)
    if discard_saturated:
        valid = valid & (Il != 0) & (Il != 255) & (Ir != 0) & (Ir != 255)
    J = _proj_jacobian_rows(_gradient(img_live, pl_u, pl_v), KlPl, KlgTlr, Pr_g[..., :3])
    w = reweighting.weight_tukey(y, c)
    return reduce_system(J, y, w, valid)


def pose_refinement_from_disparity_esm(img_live, img_ref, disp_ref, baseline, Klg, Krg, Krd, Tgd,
                                       Tlr, KlgTlr, c, discard_saturated: bool = False,
                                       min_depth=0.2, max_depth=20.0) -> LSS:
    """Depth from a reference disparity map through the depth camera's focal
    length (fu baseline / d where d > 0, NaN elsewhere), then
    :func:`pose_refinement_from_depth_esm`."""
    depth = torch.where(disp_ref > 0, Krd[0, 0] * baseline / torch.clamp(disp_ref, min=1e-9),
                        float("nan"))
    return pose_refinement_from_depth_esm(img_live, img_ref, depth, Klg, Krg, Krd, Tgd, Tlr,
                                          KlgTlr, c, discard_saturated, min_depth, max_depth)


def kt_lr(K, T_lr) -> torch.Tensor:
    """K (3, 3 tensor or Intrinsics) times T_lr (3, 4), on T_lr's device."""
    T_lr = torch.as_tensor(T_lr, dtype=torch.float32)
    Km = K.matrix(device=T_lr.device) if hasattr(K, "matrix") else torch.as_tensor(K)
    return Km @ T_lr
