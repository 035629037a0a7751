"""Scanline rectification of stereo rigs (``kangaroo_tpu/geometry/rectify.py``).

From the rig's relative pose T_rl and the two cameras' intrinsics and
radial distortion: a common rectifying rotation, the homography of each
camera, and the distortion-plus-homography lookup tables that
``ops/warp.warp`` samples through. The rotation and the homographies are
float64 NumPy on the host, as in the JAX package; the tables are made by
``ops/warp.create_matlab_lookup_table`` on the caller's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import warp as warp_mod


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _host64(a) -> np.ndarray:
    return _host(a).astype(np.float64)


def create_scanline_rectified_lookup(w: int, h: int, T_rl, K_l, K_r, lk1=0.0, lk2=0.0,
                                     rk1=0.0, rk2=0.0, device="cuda"):
    """Left and right rectification lookups for a rig T_rl (3, 4), left ->
    right, with Intrinsics K_l, K_r and distortions (k1, k2) each. Returns
    (lookup_left, lookup_right, T_nr_nl, R_nl) on ``device`` (the card
    unless the caller asks for another): the (h, w, 2) lookups, the
    rectified rig pose (a pure x baseline) and the rectified left frame's
    axes in the old left frame (float32)."""
    T_rl = _host64(T_rl)
    R_rl = T_rl[:, :3]
    l_r = T_rl[:, 3]
    R_lr = R_rl.T
    r_l = -(R_lr @ l_r)

    # up vectors in the left frame
    lup_l = np.array([0.0, 1.0, 0.0])
    rup_l = R_lr @ np.array([0.0, 1.0, 0.0])
    lfwd = np.cross(lup_l, r_l)
    rfwd = np.cross(rup_l, r_l)
    new_fwd = lfwd + rfwd
    new_fwd = new_fwd / np.linalg.norm(new_fwd)

    x = r_l / np.linalg.norm(r_l)
    z = -new_fwd
    y = np.cross(z, x)
    y = y / np.linalg.norm(y)
    R_nl = np.stack([x, y, z], axis=1)  # columns: the new basis in the left frame

    baseline = np.linalg.norm(r_l)
    T_nr_nl = np.concatenate(
        [np.eye(3), np.array([[-baseline], [0.0], [0.0]])], axis=1).astype(np.float32)

    Kl = _host64(K_l.matrix(device="cpu"))
    Kr = _host64(K_r.matrix(device="cpu"))
    H_l = Kl @ R_nl.T @ np.linalg.inv(Kl)
    H_r = Kr @ (R_nl.T @ R_lr).T @ np.linalg.inv(Kr)
    # the lookups map new image coordinates to the original (distorted)
    # ones, so they take the inverse homographies
    H_l_inv = np.linalg.inv(H_l)
    H_r_inv = np.linalg.inv(H_r)

    lut_l = warp_mod.create_matlab_lookup_table(
        w, h, float(Kl[0, 0]), float(Kl[1, 1]), float(Kl[0, 2]), float(Kl[1, 2]), lk1, lk2,
        H_on=torch.from_numpy(H_l_inv.astype(np.float32)), device=device)
    lut_r = warp_mod.create_matlab_lookup_table(
        w, h, float(Kr[0, 0]), float(Kr[1, 1]), float(Kr[0, 2]), float(Kr[1, 2]), rk1, rk2,
        H_on=torch.from_numpy(H_r_inv.astype(np.float32)), device=device)
    return (lut_l, lut_r, torch.from_numpy(T_nr_nl).to(device),
            torch.from_numpy(R_nl.astype(np.float32)).to(device))


def baseline_from_t_rl(T_rl) -> float:
    """The stereo baseline |t| of the rig's relative pose."""
    return float(np.linalg.norm(_host(T_rl)[:, 3]))
