"""Standalone SDF raycast demo.

Offline equivalent of applications/examples/Raycast.cpp
(``examples/raycast_demo.py``): a 128^3 analytic sphere SDF (SdfSphere,
radius 0.9 in a [-1, 1]^3 volume) raycast from an orbiting camera at
512x512 with K = (500, 500, w/2, h/2) — the app's exact working config
(Raycast.cpp:19-22,59). Instead of the interactive Pangolin view, each
orbit pose writes the Phong-shaded render, the depth map and the normal
map as PNGs, for both the subpix setting's states (the app's ui.subpix
toggle, Raycast.cpp:61) and both raycast engines (the reference-exact
sphere trace and the plane sweep).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _common


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--size", type=int, default=512, help="render w=h")
    ap.add_argument("--res", type=int, default=128, help="volume resolution")
    ap.add_argument("--views", type=int, default=3)
    ap.add_argument("--near", type=float, default=0.0)
    ap.add_argument("--far", type=float, default=10.0)
    args = ap.parse_args(argv)

    from kangaroo_tpu_torch import BoundingBox, Intrinsics, TsdfVolume
    from kangaroo_tpu_torch.apps import synthetic
    from kangaroo_tpu_torch.fusion import raycast as rc
    from kangaroo_tpu_torch.fusion import sdf as sdf_mod
    from kangaroo_tpu_torch.fusion import separable as sep

    dev = torch.device(args.device)
    out = _common.out_dir()
    w = h = args.size
    K = Intrinsics.create(500.0, 500.0, w / 2, h / 2)
    bbox = BoundingBox.create((-1, -1, -1), (1, 1, 1), device=dev)
    vol = TsdfVolume.create(args.res, args.res, args.res, bbox,
                            trunc_dist=2.0 / args.res * 2)
    vol = sdf_mod.sdf_sphere(vol, (0.0, 0.0, 0.0), 0.9)

    for i, ang in enumerate(np.linspace(0, 2 * np.pi, args.views,
                                        endpoint=False)):
        T_wc = synthetic.orbit_pose(float(ang), radius=4.0, device=dev)
        # the app's RaycastSdf with subpix on (the ui.subpix default)
        d, nrm, img = rc.raycast_sdf(vol, T_wc, K, w, h, near=args.near,
                                     far=args.far, subpix=True)
        hit = torch.isfinite(d)
        _common.save_png(f"{out}/raycast_shaded_{i}.png", torch.where(hit, img, 0.0))
        _common.save_png(f"{out}/raycast_depth_{i}.png", torch.where(hit, d, 0.0))
        _common.save_png(f"{out}/raycast_normals_{i}.png",
                         torch.where(hit[..., None], 0.5 * (nrm + 1.0), 0.0))
        # subpix off: snap to the voxel step like the toggle's other state
        d0, _, _ = rc.raycast_sdf(vol, T_wc, K, w, h, near=args.near,
                                  far=args.far, subpix=False)
        # the plane-sweep engine renders the same scene
        ds, _, imgs = sep.raycast_sdf_separable(vol, T_wc, K, w, h,
                                                near=max(args.near, 0.5),
                                                far=args.far)
        _common.save_png(f"{out}/raycast_sweep_{i}.png",
                         torch.where(torch.isfinite(ds), imgs, 0.0))
        dn, d0n = _common.to_numpy(d), _common.to_numpy(d0)
        fin = np.isfinite(dn)
        print(f"view {i}: hit fraction {fin.mean():.3f}, "
              f"depth range [{dn[fin].min():.3f}, {dn[fin].max():.3f}] "
              f"(subpix-off mean |delta| {np.nanmean(np.abs(d0n - dn)):.4f})")
    print(f"wrote renders for {args.views} orbit views to {out}/")


if __name__ == "__main__":
    main()
