"""Stereo pipelines end-to-end on a synthetic pair: SGM, DTAM-variational,
and raw WTA; exports disparity maps, depth and a point cloud.

Offline equivalent of applications/stereo/main.cpp and stereo2/main.cpp
(``examples/stereo_demo.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _common


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--maxdisp", type=int, default=32)
    ap.add_argument("--mode", choices=["sgm", "dtam", "wta", "multiview"],
                    default="sgm")
    ap.add_argument("--baseline", type=float, default=0.1)
    ap.add_argument("--rig", type=str, default=None,
                    help="JSON camera-rig file (io/rig.py schema): intrinsics "
                         "and baseline come from it, like the reference's "
                         "-cmod camera models (stereo/main.cpp:103-110)")
    ap.add_argument("--heightmap", action="store_true",
                    help="run the full stereo2 app tail (Stereo2App): plane "
                         "fit + heightmap fusion + heightmap mesh export "
                         "(stereo2/main.cpp:503-536)")
    args = ap.parse_args(argv)

    from kangaroo_tpu_torch import Intrinsics
    from kangaroo_tpu_torch.apps import stereo as stereo_app
    from kangaroo_tpu_torch.apps import stereo_sgm, synthetic
    from kangaroo_tpu_torch.fusion.marching_cubes import save_ply

    dev = torch.device(args.device)
    out = _common.out_dir()
    left, right, gt = synthetic.stereo_pair(args.width, args.height, args.maxdisp, device=dev)
    _common.save_png(f"{out}/left.png", left)
    _common.save_png(f"{out}/gt_disp.png", gt)

    if args.mode == "sgm" and args.heightmap:
        # the full stereo2 app: SGM -> vbo -> PlaneFitGN -> HeightmapFusion
        K0 = Intrinsics.centered(args.width * 0.9, args.width, args.height)
        app = stereo_sgm.Stereo2App(
            K0, args.baseline,
            stereo_sgm.SgmConfig(max_disp=args.maxdisp, census_window="9x7"),
            hm_size=(4.0, 4.0), hm_cell=0.02, min_disp=1.0)
        disp, d3d = app(left, right, image=left)
        n = _common.to_numpy(app.n_c)
        print(f"plane fit: n_c = {n}, plane depth on axis = {-1.0/n[2]:.3f} m")
        app.hm.save_mesh(f"{out}/heightmap_sgm.ply")
        counts = _common.to_numpy(app.hm.hm[..., 1])
        print(f"heightmap: {int((counts > 0).sum())} fused cells "
              f"-> {out}/heightmap_sgm.ply")
    elif args.mode == "sgm":
        cfg = stereo_sgm.SgmConfig(max_disp=args.maxdisp, census_window="9x7")
        disp = stereo_sgm.sgm_pipeline(left, right, cfg)
    elif args.mode == "multiview":
        # the stereo2 COSTVOL_TIME loop: anchor a keyframe, CostVolumeAdd a
        # posed synthetic camera track, DTAM-solve the accumulated volume
        from kangaroo_tpu_torch.core import se3

        key, gt, track = synthetic.multiview_track(
            args.width, args.height, args.maxdisp, baseline=args.baseline, device=dev)
        K = Intrinsics.centered(args.width * 0.9, args.width, args.height)
        mvs = stereo_app.MultiViewStereo(
            K, args.baseline,
            stereo_app.StereoConfig(max_disp=args.maxdisp,
                                    census_window="9x7",
                                    dtam_iterations=50))
        mvs.reset(key.to(torch.float32), se3.identity(device=dev))
        for img, T_wc in track:
            mvs.add(img.to(torch.float32), T_wc)
        print(f"multiview: accumulated {len(track)} posed views "
              f"(max n = {float(mvs.n.max()):.0f})")
        disp = mvs.solve(use_dtam=True)
        left = key
    else:
        cfg = stereo_app.StereoConfig(max_disp=args.maxdisp, census_window="9x7",
                                      dtam_iterations=50)
        disp = stereo_app.stereo_pipeline(left, right, cfg, use_dtam=args.mode == "dtam")

    g = _common.to_numpy(gt)
    d = _common.to_numpy(disp)
    m = np.isfinite(d)
    m[:, : args.maxdisp] = False
    err = np.abs(d[m] - g[m])
    print(f"{args.mode}: valid {m.mean():.2%}, median err {np.median(err):.3f} px, "
          f"<1px {np.mean(err < 1):.2%}")
    _common.save_png(f"{out}/disp_{args.mode}.png", _common.finite_or_zero(disp))

    if args.rig:
        from kangaroo_tpu_torch.io import rig as rig_mod

        rig = rig_mod.load_rig(args.rig)
        cam = rig[rig.names()[0]].scaled_to(args.width, args.height)
        K = cam.intrinsics()
        args.baseline = rig.baseline()
        print(f"rig: fu={cam.fu:.1f} baseline={args.baseline:.4f} m")
    else:
        K = Intrinsics.centered(args.width * 0.9, args.width, args.height)
    depth, cloud = stereo_app.depth_and_cloud(disp, K, args.baseline, min_disp=1.0)
    _common.save_png(f"{out}/depth_{args.mode}.png", _common.finite_or_zero(depth))
    pts = _common.to_numpy(cloud).reshape(-1, 4)
    pts = pts[np.isfinite(pts[:, 2]) & (pts[:, 3] > 0)][:, :3]
    save_ply(f"{out}/cloud_{args.mode}.ply", pts.reshape(-1, 1, 3).repeat(3, 1))
    print(f"wrote disparity/depth/point cloud to {out}/")
    return disp, depth, cloud


if __name__ == "__main__":
    main()
