"""Photometric calibration systems (``kangaroo_tpu/solvers/calibration.py``).

* :func:`calibration_rgbd_from_depth_esm`: the 6-dof depth -> colour
  extrinsic T_cd from a photometric constraint between two RGBD keyframes:
  y = I_live(pi(K Tcd Tlr P_d)) - I_ref(pi(K Tcd P_d)), J = Jl1 - Jl2.
* :func:`kinect_calibration`: the joint 12-dof system over (T_cd, T_lr)
  for colour keyframes, grey or three channels (the channels' Tukey
  weights summed, as the reference does).
* :func:`stereo_intrinsics_refine`: Gauss-Newton over (fu, fv, u0, v0, T_rl)
  on the reprojection error of known points in both cameras; the Jacobian
  comes from ``torch.func.jacfwd``.

Plain PyTorch on the inputs' device; the builders read nothing on the
host, and the refinement only its result.
"""
from __future__ import annotations

import numpy as np
import torch

from ..backend import constant
from ..core import reweighting, sampling, se3
from .lss import LSS, reduce_system, solve_spd
from .photometric import _gradient


def _sparse_j(vKT, P):
    """J_i = vKT . (gen_i P) for vKT (..., 3) and P (..., 3) -> (..., 6)."""
    x, y_, zz = P[..., 0], P[..., 1], P[..., 2]
    J3 = -vKT[..., 1] * zz + vKT[..., 2] * y_
    J4 = vKT[..., 0] * zz - vKT[..., 2] * x
    J5 = -vKT[..., 0] * y_ + vKT[..., 1] * x
    return torch.cat([vKT, torch.stack([J3, J4, J5], dim=-1)], dim=-1)


def _dpi_apply(dI, KP):
    """(dI . dpi(KP)) as a (..., 3) row vector."""
    z = KP[..., 2]
    a = dI[..., 0] / z
    b = dI[..., 1] / z
    c = -(dI[..., 0] * KP[..., 0] + dI[..., 1] * KP[..., 1]) / (z * z)
    return torch.stack([a, b, c], dim=-1)


def calibration_rgbd_from_depth_esm(img_live, img_ref, points_depth, K, T_cd, T_lr, c,
                                    min_depth=0.2, max_depth=20.0,
                                    discard_saturated: bool = False) -> LSS:
    """The 6-dof T_cd system. points_depth (H, W, 4): points in the reference
    depth camera; K (3, 3) colour intrinsics; T_cd (3, 4) depth -> colour;
    T_lr (3, 4) reference -> live in the depth frame. Every valid pixel
    weighs 1 (the reference's weight here); ``c`` is accepted for the
    reference's signature."""
    Pr_d = points_depth[..., :3]
    Pl_d = se3.transform(T_lr, Pr_d)
    Pr_c = se3.transform(T_cd, Pr_d)
    Pl_c = se3.transform(T_cd, Pl_d)
    KPr = Pr_c @ K.T
    KPl = Pl_c @ K.T
    pr_u, pr_v = KPr[..., 0] / KPr[..., 2], KPr[..., 1] / KPr[..., 2]
    pl_u, pl_v = KPl[..., 0] / KPl[..., 2], KPl[..., 1] / KPl[..., 2]

    z = points_depth[..., 2]
    depth_ok = torch.isfinite(z) & (z > min_depth) & (z < max_depth)
    inb = sampling.in_bounds(img_live, pl_u, pl_v, 2) & sampling.in_bounds(img_ref, pr_u, pr_v, 2)
    Il = sampling.bilinear(img_live, pl_u, pl_v)
    Ir = sampling.bilinear(img_ref, pr_u, pr_v)
    y = Il - Ir
    valid = depth_ok & inb & torch.isfinite(y)
    if discard_saturated:
        valid = valid & (Il != 0) & (Il != 255) & (Ir != 0) & (Ir != 255)

    KT = K @ T_cd[:, :3]
    vl = _dpi_apply(_gradient(img_live, pl_u, pl_v), KPl) @ KT
    vr = _dpi_apply(_gradient(img_ref, pr_u, pr_v), KPr) @ KT
    J = _sparse_j(vl, Pl_d) - _sparse_j(vr, Pr_d)
    return reduce_system(J, y, torch.ones_like(y), valid)


def kinect_calibration(points_live, img_live, points_ref, img_ref, KcT_cd, T_lr, c) -> LSS:
    """The joint 12-dof (T_cd, T_lr) system: points_* (H, W, 4) depth-camera
    point images, img_* (H, W) or (H, W, 3) colour, KcT_cd (3, 4) = K_colour
    T_cd. Parameters: the T_cd update, then the T_lr update.
    ``points_live`` is accepted for the reference's signature."""
    Pr = points_ref[..., :3]
    Pl = se3.transform(T_lr, Pr)
    _pl = se3.transform(KcT_cd, Pl)
    _pr = se3.transform(KcT_cd, Pr)
    pl_u, pl_v = _pl[..., 0] / _pl[..., 2], _pl[..., 1] / _pl[..., 2]
    pr_u, pr_v = _pr[..., 0] / _pr[..., 2], _pr[..., 1] / _pr[..., 2]
    inb = sampling.in_bounds(img_live, pl_u, pl_v, 2) & sampling.in_bounds(img_ref, pr_u, pr_v, 2)
    multi = img_live.dim() == 3

    Il = sampling.bilinear(img_live, pl_u, pl_v)
    Ir = sampling.bilinear(img_ref, pr_u, pr_v)
    y = Il - Ir  # (..., C) or (...)

    Kc = KcT_cd[:, :3]
    KcT_lr = KcT_cd @ torch.cat([T_lr, constant(((0.0, 0.0, 0.0, 1.0),), device=T_lr.device)])

    def channel_rows(ch):
        dl = _gradient(img_live[..., ch] if multi else img_live, pl_u, pl_v)
        dr = _gradient(img_ref[..., ch] if multi else img_ref, pr_u, pr_v)
        vl = _dpi_apply(dl, _pl) @ Kc
        vr = _dpi_apply(dr, _pr) @ Kc
        vl_lr = _dpi_apply(dl, _pl) @ KcT_lr[:, :3]
        J_cd = _sparse_j(vl, Pl) - _sparse_j(vr, Pr)
        J_lr = _sparse_j(vl_lr, Pr)
        return torch.cat([J_cd, J_lr], dim=-1)

    finite = torch.isfinite(points_ref[..., 2]) & torch.isfinite(Pl[..., 2]) & inb
    if multi:
        ys = [y[..., ch] for ch in range(img_live.shape[-1])]
        w = sum(reweighting.weight_tukey(yc, c) for yc in ys)
        out = LSS.zero(12, device=y.device)
        for ch, yc in enumerate(ys):
            out = out + reduce_system(channel_rows(ch), yc, w, finite & torch.isfinite(yc))
        return out
    w = reweighting.weight_tukey(y, c)
    return reduce_system(channel_rows(0), y, w, finite & torch.isfinite(y))


def _project(P, fu, fv, u0, v0):
    return torch.stack([u0 + fu * P[..., 0] / P[..., 2], v0 + fv * P[..., 1] / P[..., 2]], dim=-1)


def reprojection_residuals(theta, T_rl0, points_w, obs_l, obs_r) -> torch.Tensor:
    """The residuals :func:`stereo_intrinsics_refine` minimises at
    theta = (fu, fv, u0, v0, xi): the left pixels of ``points_w``, then the
    right pixels through exp(xi) T_rl0, less the observations, flattened."""
    fu, fv, u0, v0 = theta[0], theta[1], theta[2], theta[3]
    T_rl = se3.compose(se3.exp(theta[4:10]), T_rl0)
    P_r = points_w @ T_rl[:, :3].T + T_rl[:, 3]
    return torch.cat([(_project(points_w, fu, fv, u0, v0) - obs_l).reshape(-1),
                      (_project(P_r, fu, fv, u0, v0) - obs_r).reshape(-1)])


def stereo_intrinsics_refine(points_w, obs_l, obs_r, K0, T_rl0, iterations: int = 20,
                             damping: float = 1e-3, device="cuda"):
    """Refine shared pinhole intrinsics (fu, fv, u0, v0) and the rig pose
    T_rl from known points and their pixels in both cameras, on ``device``
    (the card unless the caller asks for another).

    points_w: (N, 3) points in the LEFT camera frame; obs_l/obs_r: (N, 2)
    pixels; K0 the starting Intrinsics, T_rl0 the starting (3, 4) pose.
    Each step solves the damped normal equations of the Jacobian
    ``torch.func.jacfwd`` gives, re-anchors the pose on its update and
    zeroes the pose part. Returns (Intrinsics, T_rl)."""
    from ..containers.intrinsics import Intrinsics

    f32 = lambda a: (a if torch.is_tensor(a) else torch.from_numpy(  # noqa: E731
        np.array(a, np.float32))).to(device=device, dtype=torch.float32)
    obs = (f32(points_w), f32(obs_l), f32(obs_r))
    theta = torch.cat([f32([K0.fu, K0.fv, K0.u0, K0.v0]), torch.zeros(6, device=device)])
    T_rl0 = f32(T_rl0)
    for _ in range(iterations):
        J = torch.func.jacfwd(reprojection_residuals)(theta, T_rl0, *obs)
        r = reprojection_residuals(theta, T_rl0, *obs)
        theta = theta - solve_spd(J.T @ J, J.T @ r, damping)
        # re-anchor the pose part so exp stays near identity
        T_rl0 = se3.compose(se3.exp(theta[4:10]), T_rl0)
        theta = torch.cat([theta[:4], torch.zeros(6, device=device)])
    return Intrinsics(*(float(v) for v in theta[:4].tolist())), T_rl0
