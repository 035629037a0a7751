"""Projective point-plane ICP (``kangaroo_tpu/solvers/icp.py``).

Per model pixel: project it into the live image, associate the live point
there (nearest pixel, or within a bounded window), and form the point-plane
residual, its Jacobian and Tukey weight; the rows reduce to a 6x6 system.
"""
from __future__ import annotations

import torch

from ..core import reweighting, sampling, se3
from .lss import LSS, reduce_system, solve_spd


def icp_point_plane(points_live, points_ref, normals_ref, KT_lr, T_rl, c,
                    assoc_radius: int | None = None, K_live=None) -> LSS:
    """The 6-dof point-plane system.

    points_live: (Hl, Wl, 4) live point image; points_ref / normals_ref:
    (H, W, 4) model points and normals (normal w = 1 marks valid); KT_lr:
    (3, 4) = K T_lr projecting model points into the live image; T_rl: live
    -> model; c: the Tukey constant. Residual y = (T_rl p_live - P_r) . N_r,
    weight Tukey(y) / P_r.z.

    ``assoc_radius`` r: associate only matches within r pixels of the model
    pixel (a (2r + 1)^2 masked-shift stencil; valid only when the model lies
    on the live pixel lattice); None: the exact nearest-pixel gather.
    ``K_live`` (fu, fv, u0, v0): the live point image is the unprojection of
    its depth, so the association reads the depth and rebuilds x and y.
    """
    H, W = points_ref.shape[:2]
    Hl, Wl = points_live.shape[:2]
    dev = points_ref.device
    Pr, Nr = points_ref[..., :3], normals_ref[..., :3]
    nr_valid = normals_ref[..., 3] == 1.0
    KPl = Pr @ KT_lr[:, :3].T + KT_lr[:, 3]
    pl_u = KPl[..., 0] / KPl[..., 2]
    pl_v = KPl[..., 1] / KPl[..., 2]
    in_img = sampling.in_bounds(points_live[..., 0], pl_u, pl_v, 3)

    def reconstruct(z, ui, vi):
        # depth_to_vbo's op order: ray = (u - u0) / fu, then ray * z
        fu, fv, u0, v0 = K_live
        return torch.stack([(ui.to(torch.float32) - u0) / fu * z,
                            (vi.to(torch.float32) - v0) / fv * z, z], dim=-1)

    if assoc_radius is None:
        # a NaN position converts to index 0, as XLA's float-to-int does;
        # in_img rejects that pixel
        ui = torch.clamp(torch.floor(pl_u + 0.5), 0, Wl - 1).nan_to_num(0.0).long()
        vi = torch.clamp(torch.floor(pl_v + 0.5), 0, Hl - 1).nan_to_num(0.0).long()
        if K_live is None:
            Pl = sampling.nearest(points_live, pl_u, pl_v)[..., :3]
        else:
            Pl = reconstruct(points_live[..., 2].reshape(-1)[vi * Wl + ui], ui, vi)
        pl_valid = torch.isfinite(Pl[..., 2])
    else:
        r = assoc_radius
        ui = torch.floor(pl_u + 0.5).nan_to_num(0.0).long()
        vi = torch.floor(pl_v + 0.5).nan_to_num(0.0).long()
        vv, uu = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                                indexing="ij")
        du, dv = ui - uu, vi - vv
        found = torch.zeros((H, W), dtype=torch.bool, device=dev)
        # in_img keeps a matched index in bounds wherever m holds, so the
        # roll's wrap never selects wrapped data
        if K_live is None:
            live3 = points_live[..., :3]
            Pl = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
        else:
            zl = points_live[..., 2]
            z = torch.zeros((H, W), dtype=torch.float32, device=dev)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                m = (dv == dy) & (du == dx)
                if K_live is None:
                    Pl = torch.where(m[..., None], torch.roll(live3, (-dy, -dx), (0, 1)), Pl)
                else:
                    z = torch.where(m, torch.roll(zl, (-dy, -dx), (0, 1)), z)
                found = found | m
        if K_live is not None:
            Pl = reconstruct(z, ui, vi)
        pl_valid = found & torch.isfinite(Pl[..., 2])

    Pr_l = Pl @ T_rl[:, :3].T + T_rl[:, 3]
    y = ((Pr_l - Pr) * Nr).sum(-1)
    J = -(se3.generator_products(Pr_l) * Nr[..., None, :]).sum(-1)  # (H, W, 6)
    valid = torch.isfinite(Pr[..., 2]) & nr_valid & in_img & pl_valid & torch.isfinite(y)
    w = (1.0 / Pr[..., 2]) * reweighting.weight_tukey(y, c)
    return reduce_system(J, y, w, valid)


def solve_pose_update(sum_lss: LSS, rotation_only: bool = False) -> torch.Tensor:
    """The se3 update x with T_lp <- exp(x) T_lp; ``rotation_only`` solves
    the 3x3 rotation block (the coarsest pyramid level)."""
    if rotation_only:
        x_rot = solve_spd(sum_lss.JTJ[3:, 3:], sum_lss.JTy[3:])
        return torch.cat([torch.zeros(3, dtype=torch.float32, device=x_rot.device), x_rot])
    return sum_lss.solve()
