"""SdfDifference: load two saved TSDF volumes and visualise their difference.

Offline equivalent of applications/examples/SdfDifference.cpp (:1-120)
(``examples/sdf_difference_demo.py``): the reference loads
save.vol/save2.vol, raycasts one (switch_sdf picks which) and renders the
other's SDF value sampled at the hit points (diff_sdf) as a heat overlay.
Here: raycast depth/normals of volume A, sample volume B at the hit points
(fusion.sdf.sdf_distance), write a heat-mapped PNG + stats.

Usage: python -m kangaroo_tpu_torch.examples.sdf_difference_demo volA.vol
volB.vol [--switch] [--stats-only]. With no volumes, synthesises two
offset spheres as a self-test.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _common


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("vols", nargs="*", help="two .vol PXM TSDF dumps")
    ap.add_argument("--switch", action="store_true",
                    help="raycast B and sample A (ui.switch_sdf)")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--focal", type=float, default=288.0)
    ap.add_argument("--stats-only", action="store_true")
    args = ap.parse_args(argv)

    from kangaroo_tpu_torch import BoundingBox, Intrinsics, TsdfVolume
    from kangaroo_tpu_torch.core import se3
    from kangaroo_tpu_torch.fusion import raycast as rc
    from kangaroo_tpu_torch.fusion import sdf as sdf_mod
    from kangaroo_tpu_torch.io import pxm
    from kangaroo_tpu_torch.ops import viz

    dev = torch.device(args.device)
    out = _common.out_dir()
    if len(args.vols) == 2:
        vol_a = pxm.load_tsdf(args.vols[0], device=dev)
        vol_b = pxm.load_tsdf(args.vols[1], device=dev)
    elif not args.vols:
        print("no volumes given; synthesising two offset spheres")
        bbox = BoundingBox.create((-1.2,) * 3, (1.2,) * 3, device=dev)
        base = TsdfVolume.create(96, 96, 96, bbox, trunc_dist=0.15)
        vol_a = sdf_mod.sdf_sphere(base, (0.0, 0.0, 0.0), 0.8)
        vol_b = sdf_mod.sdf_sphere(base, (0.05, 0.0, 0.0), 0.8)
    else:
        ap.error("pass exactly two volumes (or none for the self-test)")

    if args.switch:
        vol_a, vol_b = vol_b, vol_a

    W, H = args.width, args.height
    K = Intrinsics.centered(args.focal, W, H)
    T_wc = se3.make(np.eye(3), [0.0, 0.0, -3.0], device=dev)
    size = float(vol_a.bbox.size().max())
    trunc = 2.0 * size / vol_a.val.shape[0]
    depth, norm, img = rc.raycast_sdf(vol_a, T_wc, K, W, H, near=0.1,
                                      far=3.0 + 2 * size, trunc_dist=trunc)

    # sample B's SDF at A's surface (SdfDistance, cu_sdffusion.cu:201-224)
    dist = sdf_mod.sdf_distance(depth, vol_b, T_wc, K)
    hit = np.isfinite(_common.to_numpy(depth))
    d = _common.to_numpy(dist)[hit]
    d = d[np.isfinite(d)]
    if d.size == 0:
        print("no overlapping surface between the two volumes")
        return
    print(f"surface pixels: {hit.sum()}  |sdf_B at surface_A|: "
          f"mean {np.abs(d).mean():.5f}  median {np.median(np.abs(d)):.5f}  "
          f"max {np.abs(d).max():.5f}  (volume units)")
    if args.stats_only:
        return

    # heat overlay like the reference's diff_sdf render
    span = float(np.percentile(np.abs(d), 95)) or 1e-6
    heat = viz.remap_heat(img, _common.finite_or_zero(dist), -span, span)
    _common.save_png(f"{out}/sdf_diff.png", heat)
    _common.save_png(f"{out}/sdf_diff_shaded.png", img)
    print(f"wrote sdf_diff.png (heat span ±{span:.4f}) and "
          f"sdf_diff_shaded.png to {out}/")


if __name__ == "__main__":
    main()
