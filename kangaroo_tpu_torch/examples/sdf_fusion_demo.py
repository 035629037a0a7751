"""SDF examples: analytic raycasts, synthetic fusion round-trip with
ground-truth diff, and volume differencing.

Offline equivalents of applications/examples/{Raycast,SdfFusion,
SdfDifference}.cpp (``examples/sdf_fusion_demo.py``) — including
SdfFusion's 'test' mode, which renders depth - ground-truth as the
correctness check (SdfFusion.cpp:130-135).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _common


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--size", type=int, default=160)
    args = ap.parse_args(argv)

    from kangaroo_tpu_torch import BoundingBox, Intrinsics, TsdfVolume
    from kangaroo_tpu_torch.apps import synthetic
    from kangaroo_tpu_torch.core import se3
    from kangaroo_tpu_torch.fusion import marching_cubes as mc
    from kangaroo_tpu_torch.fusion import raycast as rc
    from kangaroo_tpu_torch.fusion import sdf as sdf_mod
    from kangaroo_tpu_torch.geometry import depth as depth_mod
    from kangaroo_tpu_torch.io import pxm

    dev = torch.device(args.device)
    out = _common.out_dir()
    W = args.size
    H = args.size * 3 // 4
    K = Intrinsics.centered(W * 0.9, W, H)
    bbox = BoundingBox.create((-1.2, -1.2, -1.2), (1.2, 1.2, 1.2), device=dev)
    trunc = 4.0 * 2.4 / args.res

    def no_hit():
        return torch.full((H, W), float("nan"), device=dev)

    # ---- Raycast.cpp: analytic primitives
    T_wc = se3.make(np.eye(3), [0.0, 0.0, -3.0], device=dev)
    d_sph, img_sph = rc.raycast_sphere(no_hit(), T_wc, K, (0.0, 0.0, 0.0), 0.9, W, H)
    d_pl, img_pl = rc.raycast_plane(d_sph, T_wc, K, (0.0, -0.45, 0.0), W, H)
    _common.save_png(f"{out}/raycast_primitives.png",
                     torch.where(torch.isfinite(d_pl), img_pl, 0.0))

    # ---- SdfFusion.cpp: fuse analytic depth from several views, then 'test'
    vol = TsdfVolume.create(args.res, args.res, args.res, bbox, trunc_dist=trunc)
    for ang in np.linspace(0, 2 * np.pi, args.views, endpoint=False):
        T = synthetic.orbit_pose(float(ang), device=dev)
        gt, _ = rc.raycast_sphere(no_hit(), T, K, (0.0, 0.0, 0.0), 0.9, W, H)
        vbo = depth_mod.depth_to_vbo(gt, K)
        norm = depth_mod.normals_from_vbo(vbo)
        vol = sdf_mod.sdf_fuse(vol, gt, norm, se3.inverse(T), K, trunc, 1000.0, 0.1)

    T = synthetic.orbit_pose(0.35, device=dev)
    depth, norm, img = rc.raycast_sdf(vol, T, K, W, H, near=0.5, far=8.0, trunc_dist=trunc)
    gtd, _ = rc.raycast_sphere(no_hit(), T, K, (0.0, 0.0, 0.0), 0.9, W, H)
    diff = (depth - gtd).abs()
    both = torch.isfinite(diff)
    mean_err = float(diff[both].mean()) if bool(both.any()) else float("nan")
    print(f"fused-vs-analytic depth: mean abs err {mean_err:.4f} units "
          f"({int(both.sum())} px)")
    _common.save_png(f"{out}/sdf_fusion_render.png", img)
    _common.save_png(f"{out}/sdf_fusion_gt_diff.png", torch.where(both, diff, 0.0))

    # volume save + mesh (kinectfusion 's' key)
    pxm.save_tsdf(f"{out}/save.vol", vol)
    tris = mc.extract_mesh(TsdfVolume(torch.nan_to_num(vol.val, nan=trunc), vol.weight, vol.bbox))
    mc.save_ply(f"{out}/fused.ply", tris)

    # ---- SdfDifference.cpp: diff two volumes
    vol2 = sdf_mod.sdf_sphere(
        TsdfVolume.create(args.res, args.res, args.res, bbox, trunc_dist=trunc),
        (0.0, 0.0, 0.0), 0.9,
    )
    valid = vol.weight > 0
    vdiff = torch.where(valid, (vol.val - torch.clamp(vol2.val, -trunc, trunc)).abs(), 0.0)
    print(f"volume diff vs analytic sphere: mean {float(vdiff.sum() / valid.sum()):.5f}")
    print(f"wrote raycast/fusion artefacts + save.vol + fused.ply to {out}/")


if __name__ == "__main__":
    main()
