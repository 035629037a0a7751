"""KinectFusion end-to-end on a synthetic orbit sequence: tracking + fusion +
render + mesh export.

Offline equivalent of applications/kinectfusion/main.cpp
(``examples/kinectfusion_demo.py``). ``--input DIR`` streams 16-bit PGM
depth frames through the native frame loader, as the reference app reads
its camera.
"""
from __future__ import annotations

import glob
import os

import torch

from . import _common


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--volres", type=int, default=96)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--input", type=str, default=None,
                    help="directory of PGM depth frames (millimetres, sorted "
                         "by name) streamed via the native frame loader; "
                         "default: synthetic orbit sequence")
    ap.add_argument("--depth-scale", type=float, default=1e-3,
                    help="raw depth -> metres (1/1000 for Kinect mm files)")
    ap.add_argument("--sequence", action="store_true",
                    help="replay the synthetic sequence through run_sequence "
                         "(the frame step over the stacked frames) instead of "
                         "the per-frame loop")
    ap.add_argument("--colour", action="store_true",
                    help="fuse a colour volume in the same frame step as tracking "
                         "(synthetic shaded-grey frames) and render from it")
    args = ap.parse_args(argv)
    if args.colour and args.input:
        ap.error("--colour requires the synthetic sequence (the PGM input "
                 "path carries no rgb stream)")

    from kangaroo_tpu_torch import Intrinsics
    from kangaroo_tpu_torch.apps import kinectfusion as kf
    from kangaroo_tpu_torch.apps import synthetic

    dev = torch.device(args.device)
    out = _common.out_dir()
    K = Intrinsics.centered(args.width * 0.9, args.width, args.height)
    cfg = kf.KinectFusionConfig(
        w=args.width, h=args.height, vol_res=args.volres, vol_extent=1.2,
        max_levels=args.levels, its=(2,) * args.levels, near=0.5, far=6.0,
        max_rmse=0.3, front_volume=bool(args.input),
        use_colour=args.colour, rgb_focal=args.width * 0.9,
        rgb_baseline_m=0.0,
    )
    pipe = kf.KinectFusion(K, cfg, device=dev)

    def shaded_rgb(depth):
        # synthetic colour: depth-shaded grey (nearer = brighter)
        g = torch.clamp(255.0 * (1.0 - (depth - 2.0) / 2.0), 0.0, 255.0)
        g = torch.where(torch.isfinite(depth) & (depth > 0), g, 0.0)
        return torch.stack([g, g, g], dim=-1)

    errs = [0.0]
    if args.input:
        from kangaroo_tpu_torch.io.frame_loader import FrameLoader

        paths = sorted(glob.glob(os.path.join(args.input, "*.pgm")))[: args.frames]
        cfg.depth_scale = args.depth_scale  # the app reads its config by reference
        for i, raw in FrameLoader(paths, n_threads=1):
            pipe.process_frame(torch.from_numpy(raw))  # the raw uint16 frame
            print(f"frame {i}: rmse {pipe.rmse:.4f} "
                  f"tracking_good={pipe.tracking_good}")
    else:
        scene = synthetic.sphere_scene(res=128, device=dev)
        frames = list(synthetic.depth_sequence(
            args.frames, K, args.width, args.height, scene=scene, step=0.02))
        pipe.T_wl = frames[0][0]
        if args.sequence:
            depths = torch.stack([_common.finite_or_zero(d) for _, d in frames])
            rgbs = (torch.stack([shaded_rgb(d) for d in depths])
                    if args.colour else None)
            poses, rmses = pipe.run_sequence(depths, rgbs=rgbs)
            for i, (T_wc, _) in enumerate(frames):
                err = float((poses[i] - T_wc).abs().max())
                errs.append(err)
                rmse = float(rmses[i]) if i > 0 else 0.0  # frame 0: no model
                print(f"frame {i}: rmse {rmse:.4f} "
                      f"pose err {err:.4f}  (sequence replay)")
        else:
            for i, (T_wc, depth) in enumerate(frames):
                depth = _common.finite_or_zero(depth)
                est = pipe.process_frame(
                    depth, rgb=shaded_rgb(depth) if args.colour else None)
                err = float((est - T_wc).abs().max())
                errs.append(err)
                print(f"frame {i}: rmse {pipe.rmse:.4f} "
                      f"tracking_good={pipe.tracking_good} "
                      f"pose err {err:.4f}")

    d, n, img = pipe.render(show_colour=args.colour)
    _common.save_png(f"{out}/kf_render.png", img)
    _common.save_png(f"{out}/kf_depth.png", _common.finite_or_zero(d))
    tris = pipe.save_mesh(f"{out}/kf_mesh.ply")
    pipe.save_volume(f"{out}/kf_save.vol")
    print(f"final pose drift {errs[-1]:.4f}; mesh {len(tris)} tris; "
          f"wrote kf_render.png, kf_depth.png, kf_mesh.ply, kf_save.vol to {out}/")
    return pipe


if __name__ == "__main__":
    main()
