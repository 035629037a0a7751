#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kangaroo_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 (H100) and ``nvcc``; it
builds the kernels from ``kangaroo_tpu_torch/csrc`` on first use. Phases:

1. the card's name and power limit (nvidia-smi) and the kernels' build time,
   then the three host cores' (g++, ``kangaroo_tpu_torch/native``: the two
   meshing cores and the frame loader);
2. each CUDA kernel against its plain PyTorch version on the card: the SGM
   frame's kernels (4- and 8-path) and the DTAM auxiliary search (theta
   100, 1, 1e-3) at 640x480/64 and 1242x375/128 on random inputs (NumPy
   seed) and on the synthetic pair (its census volume also as a view at
   an odd element offset), the DTAM alternation (a 50-iteration cold
   solve, bf16 and float32, and 3 + 3 incremental steps against 6) on the
   synthetic pair's census volumes at both shapes, the search and the
   alternation each also against the designs they replaced
   (``kt_wta_sq_pixel``, ``kt_dtam_run_split``, exactly), the ROF (tv, huber,
   lambda-weighted) and TGV solves for 100 iterations at 640x480, 1242x375
   and 375x1242, each ROF solve, inpainting and Huber solves of 9 and 37
   iterations also through the design it replaced
   (``kt_rof_denoise_steps``, exactly), TGV solves of 0, 9, 37 and 100
   iterations, on an input with NaN and infinity and on images smaller
   than a tile also through the design it replaced
   (``kt_tgv_denoise_steps``, exactly), plus one backward pass through each
   autograd op against the plain version's gradient; the plane-sweep TSDF
   fuse at 256^3 with 640x480 depth and at (200, 136, 248) with 1242x375
   depth, on the three sweep axes, an empty and a fused volume, three plane
   windows, and enable=False (a bit-exact passthrough), each case and an
   empty window also through the voxel design it replaced
   (``kt_separable_fuse_voxel``, exactly); the median on tiles against the
   one-thread-per-pixel design it replaced
   (``kt_median_reject_invalid_pixel``, exactly; +0 equal to -0) and plain
   at radius 1, 2 and 3 and max_bad 0, 1, 12, K and K + 5, on inputs with
   NaN, +inf and -inf, a bad row and column and +0 and -0 taps, at
   640x480, 1242x375, 375x1242 and images narrower than a tile or smaller
   than a window, and on a stack of 4 VGA frames against 4 single launches;
   the LR check one way and as the pair of both directions against
   ``kt_lr_check_pixel`` (the pair against two launches in the reference's
   order, exactly) on the frame's disparities, random ones and W = 1, and a
   backward pass through the pair; the SGM segment kernels of the
   multi-device and batched paths on a 4-way split of 640x480/64 and a
   3-way split of 1242x375/128: column shards' vertical pairs at their
   lattice offsets, row segments and the four diagonal segments chained
   through their carries (each also against one pass through the same
   kernel, exactly), and the seam pass of 4 stacked VGA frames against 4
   single passes (exactly), every case also through ``csrc/sgm.cu``'s
   warp-per-line design (``kt_sgm_segment_lines``, exactly); the
   whole-image path kernel (kernels 1 and 5) against that design run over
   the whole image, each of the 8 steps alone, bf16 and float32, both
   lattices, Lr written and added onto an accumulator, at both shapes
   (exactly);
3. the main paths, each run with every launch count set to 0 just before
   and read just after: ``sgm_pipeline`` at 640x480/64 (default SgmConfig)
   and with ``do_diagonal=True`` on the synthetic pair for 3 frames each
   (every kernel of the frame is launched every frame, a median of each
   image and one LR launch for both directions a frame, the frame agrees
   with the plain frame on the card, its disparity error against the
   ground truth is within bounds); the same two frames on a virtual
   4-shard mesh of the card (``make_mesh(devices=["cuda:0"] * 4)``: the
   reshard and the wavefront, with the segment kernels launched every
   frame, the frame agreeing with the single-device frame and with the
   mesh frame of plain versions, no host synchronisation inside the
   aggregation) and ``sgm_pipeline_batched`` on 4 pairs (one median launch
   a stack and one LR launch; equal to the 4 frames one by one, exactly);
   DTAM stereo: ``stereo_pipeline`` (the
   cold 50-iteration solve, 16x16 census) for 3 frames and
   ``VariationalStereo(its_per_frame=5)`` for 10 frames on the same pair
   (the alternation, the auxiliary search, WTA, median and LR check
   launched every frame, the cold frame agreeing with the plain frame on
   the card, both within limits set from the JAX package's CPU-JAX quality
   on this pair); then ``rof.denoise``, ``tgv.denoise`` and
   ``deconvolution.inpaint`` on a seeded noisy 640x480 image (each brings
   the error against the clean image down); KinectFusion at bench.py's
   config (256^3 TSDF, 640x480, its (1, 0, 2, 3)) on the synthetic orbit:
   frame 0 seeded at the true pose, 8 frames of ``process_frame`` (the
   fuse kernel launched once per frame, every frame tracked), the same 8
   through ``run_sequence`` and through a frame of plain versions (poses
   within 1e-4), and ATE and final rmse within limits set from the JAX
   package's CPU-JAX figures; BASELINE config 1 (``gaussian_blur(img, 2.0,
   rad=10)`` and ``bilateral(img, 2.0, 0.1, 5)`` on a 640x480 float32
   frame, the Gaussian blur also on uint8) with ``blur``, a 4-level
   ``blur_reduce``, the integral image and ``box_filter_integral_image``,
   each against the same call on the CPU; the SGM frame with the cost-volume
   bilateral filter (``SgmConfig(bilateral_filter=True)``, size 18) for 2
   frames (kernels 1-4 launched every frame, agreement with the plain frame,
   a disparity map and not noise), the SGM and WTA kernels on the filtered
   float32 volume against their plain versions, and one frame at size 3
   within 0.01 of the JAX package's CPU-JAX quality; KinectFusion's
   leftover paths at the same config on the same orbit, 8 frames each with
   the counts read after every frame: the guided and exact engines and
   colour fusion (a seeded rgb texture) launch no kernel, every frame of
   the moving workspace (threshold 2 voxels, lead 2 m) launches the fuse
   once, also right after a roll, and rolls the volume at least once; each
   path's ATE and final rmse within the JAX package's CPU-JAX figures +
   slack; the colour volume's touched share and median grey within 1e-3
   of the JAX package's, ``run_sequence(rgbs=)`` against the frame loop
   (poses 1e-4, colour 1e-3) and ``render(show_colour=True)`` hitting; the
   moving workspace against the frame of plain versions after the same
   rolls (poses 1e-4); the output side and the remaining solvers, each with
   the launch counts read around it (none of them launches a kernel):
   ``save_volume`` of the 8-frame separable run and ``load_volume`` into a
   second app (val, weight and box bit-equal), ``save_mesh`` "tet" and "mc"
   of the same run (triangle counts; the vertices' median distance to the
   three analytic spheres under 0.15 voxel, their p99 distance to the scene
   the frames were rendered from under 0.5 voxel; the .ply read back),
   native against NumPy extraction on ``sphere_scene(128)`` (the 256-case
   core the same triangles; the tetrahedra the same count, sorted
   coordinates within 1e-5), ``save_keyframe`` on two frames of the colour
   run and ``render_textured`` at level 2 against the same call on a CPU
   copy of the state, ``HeightmapFusion.save_mesh`` after Stereo2App's steady
   frame (the .ply's vertices are ``world_vbo``'s), and each solver on the
   card against the same call on a CPU copy of its inputs: the four
   photometric builders and both calibration builders at VGA on textured
   orbit frames (LSS fields within 1e-4 of the largest entry), 10 GN steps of
   the depth ESM builder from a perturbed pose (the error to the true pose
   within the CPU run's + 1e-5), ``manhattan_line_cost`` (1e-4) and
   ``estimate_manhattan_rotation`` after 3 steps (1e-5),
   ``create_scanline_rectified_lookup`` on a tilted rig (1e-4 px) and a
   ``PoseGraph`` of 100 keyframes with loop edges and a prior (the final
   residual within 1e-4 relative); the host side: the KinectFusion orbit's
   9 frames as 16-bit PGM files in millimetres through ``FrameLoader`` (one
   thread) into ``KinectFusion(front_volume=True, depth_scale=1e-3)`` at
   256^3/VGA, seeded at frame 0's pose (indices in order, the fuse kernel
   once a frame and nothing else, poses bit-equal to the same uint16 frames
   fed from memory, ATE and final rmse within the JAX package's CPU-JAX
   figures + slack, 4 loader threads bit-equal to 1), ``save_rig`` and
   ``load_rig`` of a two-camera rig (baseline 0.08 within 1e-6;
   ``depth_and_cloud`` of the SGM frame with the rig's K and baseline
   bit-equal to the call with them given), every demo of
   ``kangaroo_tpu_torch/examples`` at its defaults in this process (the
   kernels of its path launched and no other, the JAX demo's files
   written), the ``roo`` names' representative calls on the card against
   CPU copies (no launch), ``debug_mode`` raising on a NaN made on the
   card, ``device_memory_report`` naming the card, and, after phase 4 (so
   that no profile phase 4 counts launches in follows it), a
   ``profiling.trace`` of an SGM frame naming the path kernels;
4. CUDA-event times of each kernel, of both SGM frames, of one
   horizontal, vertical and diagonal direction through the path kernel
   and through the warp-per-line design in turns (and the chained byte
   floor; the path kernel again with its data aliased into L2),
   of the 100-iteration solves, of the 50-iteration DTAM solve, the cold DTAM
   frame and one incremental DTAM frame against their plain versions at
   640x480(/64); each kernel's bound; the device time by kernel of one
   DTAM solve (also through the three-launch design) and one cold DTAM
   frame (torch.profiler); the auxiliary search (bf16 and float32), the
   solve and 5 incremental iterations against the designs they replaced, in
   turns (old, new, new, old), with device times, the search's TB/s and
   the solve's chained byte floor, and the search against builds of its
   source with one constant changed (pixels a thread, slices a group,
   threads a block); the device time a launch of WTA, median and LR check
   (100 calls back to back, torch.profiler), the median and the LR check
   (one way, and the pair against two launches) also through the designs
   they replaced in turns, with the events and host time of a call, and
   against builds of ``csrc/median.cu`` (pixels a thread, rows a block) and
   ``csrc/lr_check.cu`` (rows a block, threads a row) with one constant
   changed; the 100-iteration ROF solve,
   inpainting and TGV solve against the designs they replaced in turns,
   with device time and the kernel launches a solve (torch.profiler;
   ceil(100 / ROF_STEPS) and ceil(100 / TGV_STEPS) required), and the ROF
   and TGV solves against builds of ``csrc/rof.cu`` and ``csrc/tgv.cu``
   with their tile, their iterations a launch or their threads a block
   changed, and ROF builds cut short (no steps; inexact divisions) that say
   where its time goes; the fuse kernel (the
   frame's window and every plane), also against the voxel design in turns
   with device time, and against builds of ``csrc/separable_fuse.cu`` with
   its chunk, blocks an SM or rows a block changed and builds cut
   short after the projection and after the taps; one
   KinectFusion frame against the frame of plain
   versions, the sequence replay per frame, the frame's host
   synchronisations and its device time by stage (torch.profiler); the
   segment kernels (a wavefront row segment, a diagonal segment, the seam
   pass of 4 frames, a column shard's vertical pair), each also through
   the warp-per-line design in turns (old, new, new, old), the batch of 4
   against 4 frames, the multi-device aggregations on a 1-shard mesh
   (bench.py's sharded configs) and on the virtual 4-shard mesh, and the
   4-shard frames, against the single-device aggregation and frame (a
   virtual mesh runs its shards one after another on one card, so these
   times say nothing of scaling over cards); the filters of phase 3 (median
   of 20 runs, with their launches and device time), the bilateral frames
   at size 18 and 3 against the unfiltered frame and the plain bilateral
   frame in turns (median of 3 runs), the volume filter alone (median of 3,
   its launches, device time and busy share) and the 4-path SGM call on the
   filtered float32 volume against the bf16 census volume;
   and KinectFusion's leftover paths' frames (guided, exact, colour,
   moving) on a running model: events (two rounds of 5), kernel launches
   and device busy share (torch.profiler), host synchronisations by site
   and peak memory, the exact and guided voxel fuses alone with their peak
   memory, and a one-voxel roll; the output side at 256^3: the mesh's copy
   to the host and each extraction apart, both ``save_mesh`` calls,
   ``save_volume`` and ``load_volume`` (host clock, host synchronisations),
   and ``render_textured`` and each solver call (events, launches, device
   time and host synchronisations); the host side: the loader's decode rate
   of VGA 16-bit PGMs with 1 and 4 threads and the NumPy reader (host
   clock), the upload of a frame, the file-fed KinectFusion frame against
   the memory-fed one in turns (events), ``sum_speed_demo``'s LSS reduction
   (``time_fn_stats``) and each demo's wall time.

The line before the last is a JSON object with each kernel's route,
source, launches on its main path and on the host side's runs, error,
times and bound (the larger of
the bytes its call must move over 3.35 TB/s and its float32 operations
over 67 TFLOP/s, the H100 SXM's published peaks); the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
import traceback
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
SHAPES = (("vga", 480, 640, 64), ("kitti", 375, 1242, 128))
# (H, W) of the solver checks: VGA, KITTI-sized, and KITTI-sized standing up
SOLVER_SHAPES = ((480, 640), (375, 1242), (1242, 375))
FRAMES = 3
SOLVER_ITERS = 100
# TGV's iteration counts held against the replaced design: none, counts that
# TGV_STEPS (4) does not divide, and the solve; the images smaller than a
# 32x16 tile (and one a pixel past it each way)
TGV_ITERS = (0, 9, 37, SOLVER_ITERS)
TGV_SMALL_SHAPES = ((1, 1), (1, 19), (19, 1), (3, 5), (17, 33))
# (H, W) of the median's checks against the replaced design: VGA, KITTI-sized
# both ways, and images narrower than a 64x4 tile or smaller than a 7x7 window
MEDIAN_SHAPES = ((480, 640), (375, 1242), (1242, 375), (1, 1), (1, 19), (19, 1), (3, 5), (5, 3),
                 (17, 33))
# the segment checks split VGA 4 ways and KITTI-sized 3 ways (3 divides 375
# and 1242); the main paths' virtual mesh has 4 shards, the batch 4 frames
SEGMENT_SHARDS = {"vga": 4, "kitti": 3}
MESH_SHARDS, BATCH = 4, 4
# path steps (sx, sy) in the plain version's sum order
STEPS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, 1), (1, -1), (-1, -1))

# kernel -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "sgm": ("kangaroo_tpu_torch/csrc/sgm_path.cu", "kangaroo_tpu/stereo/sgm_pallas.py:36"),
    "sgm_8path": ("kangaroo_tpu_torch/csrc/sgm_path.cu",
                  "kangaroo_tpu/stereo/sgm_pallas.py:504"),
    # kernel 1's lane-offset, seam and carry variants, and the diagonal segment
    "sgm_segment": ("kangaroo_tpu_torch/csrc/sgm_path.cu",
                    "kangaroo_tpu/stereo/sgm_pallas.py:36"),
    "sgm_diag_segment": ("kangaroo_tpu_torch/csrc/sgm_path.cu",
                         "kangaroo_tpu/stereo/sgm_pallas.py:397"),
    "wta": ("kangaroo_tpu_torch/csrc/wta.cu", "kangaroo_tpu/stereo/wta_pallas.py:25"),
    "median": ("kangaroo_tpu_torch/csrc/median.cu", "kangaroo_tpu/ops/median_pallas.py:70"),
    "lr_check": ("kangaroo_tpu_torch/csrc/lr_check.cu", "kangaroo_tpu/stereo/lr_pallas.py:37"),
    "rof": ("kangaroo_tpu_torch/csrc/rof.cu",
            "kangaroo_tpu/variational/pallas_solvers.py:55"),
    "tgv": ("kangaroo_tpu_torch/csrc/tgv.cu",
            "kangaroo_tpu/variational/pallas_solvers.py:120"),
    "wta_sq": ("kangaroo_tpu_torch/csrc/wta_sq.cuh", "kangaroo_tpu/stereo/wta_pallas.py:82"),
    "dtam": ("kangaroo_tpu_torch/csrc/dtam.cu", "kangaroo_tpu/stereo/dtam_pallas.py:71"),
    "separable_fuse": ("kangaroo_tpu_torch/csrc/separable_fuse.cu",
                       "kangaroo_tpu/fusion/separable_pallas.py:39"),
}
# stated tolerances of kernel vs plain on the card (max abs error); the fuse:
# val 1e-5 and weight 1e-4 where both updated (tests/test_separable.py's own
# for the Pallas kernel against the XLA scan), voxels updated on one side
# only counted and held to 1e-5 of the volume
ATOL = {"sgm": 1e-4, "sgm_8path": 1e-4, "sgm_segment": 1e-4, "sgm_diag_segment": 1e-4,
        "wta": 1e-5, "median": 0.0, "lr_check": 0.0,
        "rof": 1e-4, "tgv": 1e-4, "wta_sq": 1e-5, "dtam": 1e-4, "separable_fuse": 1e-5}
FUSE_WEIGHT_ATOL, FUSE_MAX_FLIP_SHARE = 1e-4, 1e-5
GRAD_ATOL = 1e-4
# lam, sigma_q, sigma_d, huber_alpha: the StereoConfig defaults
DTAM_ARGS = (20.0, 0.7, 0.7, 0.002)
# quality limits of both frames on stereo_pair(640, 480, 64, seed=0): the JAX
# package reaches invalid 0.0206 / median error 0.0091 px with 4 paths and
# 0.0206 / 0.0091 px with 8 (CPU-JAX), so the limits catch a broken port
MAX_INVALID, MAX_MEDIAN_ERR = 0.03, 0.02
# DTAM on the same pair, StereoConfig(max_disp=64, census_window="16x16",
# dtam_iterations=50): the JAX package's CPU-JAX figures (invalid fraction,
# median error px; `PYTHONPATH=. python tests/test_torch_dtam.py`) for the
# cold solve and for the incremental schedule after 10 frames of 5
# iterations. The limits allow 0.01 over each, so they catch a broken port,
# not a last-bit flip.
DTAM_JAX = {"cold50": {"invalid_frac": 0.05723907019704433,
                       "median_err_px": 0.03482341766357422},
            "incremental_10": {"invalid_frac": 0.05726600985221675,
                               "median_err_px": 0.03482389450073242}}
DTAM_SLACK = 0.01
DTAM_FRAMES, DTAM_INCR_FRAMES, DTAM_ITERS = 3, 10, 50
# KinectFusion at bench.py's config (256^3 TSDF, 640x480, its=(1, 0, 2, 3))
# on synthetic.depth_sequence(9, ...): frame 0 seeded at the true pose, the
# other 8 tracked. The JAX package's CPU-JAX ATE (m) and final ICP rmse for
# the frame loop and the sequence replay
# (`PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_kinectfusion.py`);
# the limits allow 1 mm of ATE (a tenth of a voxel) and 0.001 of rmse over
# each, so they catch a broken port, not a last-bit flip
KF_JAX = {"loop": {"ate_rmse_m": 0.0043184165842831135, "final_rmse": 0.0006290000164881349},
          "sequence": {"ate_rmse_m": 0.004318505525588989,
                       "final_rmse": 0.0006289670709520578}}
KF_ATE_SLACK, KF_RMSE_SLACK = 0.001, 0.001
KF_FRAMES = 8
# the KinectFusion leftovers on the same orbit and config: the guided and
# exact engines, colour fusion on the separable engine (every frame with
# synthetic.colour_texture(640, 480, seed=0); the default rgb camera, focal
# 535.7 and an 8 cm baseline) and the moving workspace (threshold 2 voxels,
# look-at point 2 m ahead: about a voxel of drift a frame on the orbit). The
# JAX package's CPU-JAX figures for the frame loop (and the colour sequence
# replay): ATE and final rmse, held to the slacks above; the colour volume's
# share of touched voxels and their median grey, held to KF_COLOUR_ATOL; the
# rolls (`PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_kinectfusion.py
# engine=guided`, `engine=exact`, `use_colour=1`, `moving_threshold_voxels=2
# moving_lead_m=2.0`)
KF_PATHS = {"guided": {"engine": "guided"}, "exact": {"engine": "exact"},
            "colour": {"use_colour": True},
            "moving": {"moving_threshold_voxels": 2, "moving_lead_m": 2.0}}
KF_JAX_PATHS = {
    "guided": {"ate_rmse_m": 0.0029607980977743864, "final_rmse": 0.004345808643847704},
    "exact": {"ate_rmse_m": 0.0006475798436440527, "final_rmse": 0.0014537276001647115},
    "colour": {"ate_rmse_m": 0.0043184165842831135, "final_rmse": 0.0006290000164881349,
               "touched_share": 0.06816285848617554, "median_grey": 0.4900343120098114},
    "colour sequence": {"ate_rmse_m": 0.004318505525588989,
                        "final_rmse": 0.0006289670709520578},
    "moving": {"ate_rmse_m": 0.0043544890359044075, "final_rmse": 0.0006073150434531271,
               "rolls": 4},
}
KF_COLOUR_ATOL = 1e-3
# BASELINE config 1 (bench.py bench_filters): one 640x480 float32 frame of
# numpy's default_rng(0).random, gaussian_blur(img, 2.0, rad=10) and
# bilateral(img, 2.0, 0.1, 5); beside them blur, a 4-level blur_reduce and
# box_filter_integral_image (rad 9). Each is held to the same call on the CPU:
# float outputs within 1e-5 relative and 1e-6 absolute (the image lies in
# [0, 1]; exp and the scans differ in the last bits), uint8 within 1 LSB
FILTER_RTOL, FILTER_ATOL = 1e-5, 1e-6
# the SGM frame with the cost-volume bilateral filter (SgmConfig's default
# window: size 18, gs 10, gr 6, gc 0.01) on the same pair: 2 frames, each a
# disparity map and not noise (tests/test_torch_pipeline.py's bar: invalid
# <= 0.2, median error <= 0.5 px); and one frame at bilateral_size=3 within
# 0.01 of the JAX package's CPU-JAX figures
# (`PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_filters.py`)
BILATERAL_FRAMES = 2
BILATERAL_MAX_INVALID, BILATERAL_MAX_MEDIAN_ERR = 0.2, 0.5
BILATERAL_JAX = {"size3": {"invalid_frac": 0.021086052955665013,
                           "median_err_px": 0.006374359130859375}}
BILATERAL_SLACK = 0.01
# the stereo apps' remaining entry points at VGA/64. MultiViewStereo on
# synthetic.multiview_track(640, 480, 64, seed=0) (focal 0.9 W, baseline 0.1):
# the keyframe seeded from the pair it makes with the f = 1 view, the 3 views
# added, then DTAM (50 iterations) and WTA; the coarse_init cold frame (16x16
# census, 50 coarse and 50 fine iterations) on the stereo pair; Stereo2App
# (focal 500, baseline 0.08: the background at 2.5 m; default SgmConfig, an 8 m
# heightmap of 0.1 m cells) for a reset and a steady frame. The JAX package's
# CPU-JAX figures (`PYTHONPATH=. JAX_PLATFORMS=cpu python
# tests/test_torch_stereo_apps.py` and `tests/test_torch_stereo2.py`); the
# limits allow 0.01 over each (invalid fraction, median error px, plane depth
# m) and 1e-3 on each component of the fitted normal n_c
MVS_FOCAL, MVS_BASELINE = 0.9, 0.1
STEREO2_FOCAL, STEREO2_BASELINE, STEREO2_HM, STEREO2_CELL = 500.0, 0.08, (8.0, 8.0), 0.1
MVS_JAX = {"dtam50": {"invalid_frac": 0.0, "median_err_px": 0.035797119140625},
           "wta": {"invalid_frac": 0.0, "median_err_px": 0.03580284118652344}}
COARSE_JAX = {"invalid_frac": 0.23609913793103443, "median_err_px": 0.1609201431274414}
STEREO2_JAX = {
    "reset": {"invalid_frac": 0.02055110837438423, "median_err_px": 0.0091400146484375,
            "n_c": [-2.681128535186872e-05, 2.659362507984042e-06, -0.4000094532966614],
            "plane_depth_m": 2.499940918292159},
    "steady": {"invalid_frac": 0.02055110837438423, "median_err_px": 0.0091400146484375,
            "n_c": [-2.687088999664411e-05, 2.659362507984042e-06, -0.4000093936920166],
            "plane_depth_m": 2.4999412908036365},
}
APPS_SLACK, STEREO2_NC_ATOL = 0.01, 1e-3
# the output side and the remaining solvers (no kernel: plain PyTorch on the
# card, the meshing on the host). synthetic.sphere_scene's three spheres
# (centre, radius): the fused orbit's mesh vertices are held to
# tests/test_apps.py's bounds in voxels, the median |sdf| < 0.15 to the
# analytic spheres and the p99 < 0.5 to the scene the depth frames were
# rendered from (sphere_scene(128)'s trilinear field: its interpolation where
# the spheres meet puts the analytic p99 at 0.50-0.54 voxels even when the
# frames fuse at their true poses, on the CPU); the native meshers against their NumPy extractors on
# sphere_scene(128); the keyframe-textured render at pyramid level 2 against a
# CPU copy of the state; each solver against the same call on a CPU copy of its
# inputs: the LSS fields within 1e-4 of the field's largest entry, GN_STEPS
# steps of the depth ESM builder from GN_PERTURB off the true pose between orbit
# frames 0 and GN_LIVE_FRAME within the CPU run's error + GN_SLACK, the
# Manhattan system within 1e-4 and its rotation after MANHATTAN_STEPS steps
# within 1e-5, the rectification tables within 1e-4 px, and
# a pose graph of 100 keyframes within 1e-4 relative of the final residual
SCENE_SPHERES = (((0.25, 0.0, 0.0), 0.6), ((-0.45, 0.35, 0.3), 0.4), ((-0.2, -0.5, -0.3), 0.3))
MESH_MEDIAN_VOXELS, MESH_P99_VOXELS, MESH_NUMPY_RES = 0.15, 0.5, 128
TEXTURE_LEVEL = 2
SOLVER_LSS_RTOL = 1e-4
GN_STEPS, GN_SLACK, GN_LIVE_FRAME, GN_BASELINE = 10, 1e-5, 2, 0.1
GN_PERTURB = (0.01, -0.008, 0.006, 0.004, -0.005, 0.003)
TEX_FREQ = (30.0, 25.0, 35.0)
MANHATTAN_ATOL, MANHATTAN_STEPS, RECTIFY_ATOL = 1e-5, 3, 1e-4
POSE_GRAPH_KEYFRAMES, POSE_GRAPH_RTOL = 100, 1e-4
# the host side: the KinectFusion phase's 9 orbit frames as 16-bit PGM files in
# millimetres (NaN -> 0), read by FrameLoader into KinectFusion(front_volume=True,
# depth_scale=1e-3), poses relative to frame 0 and frame 0 seeded at the identity
# (where a file-fed run starts). The JAX package's CPU-JAX ATE and final rmse on
# the same quantised frames (`PYTHONPATH=. JAX_PLATFORMS=cpu python
# tests/test_torch_examples.py`), held to the KinectFusion slacks above; the roo
# calls on the card against their CPU copies (floats within 1e-5 relative to the
# largest entry and 1e-5 absolute: the plain ops' reductions and exp may differ
# in the last bits between the card and the CPU); the loader's decode rate over
# LOADER_FRAMES files
KF_FILE_JAX = {"ate_rmse_m": 0.017294295132160187, "final_rmse": 0.0005691859987564385}
ROO_RTOL, ROO_ATOL = 1e-5, 1e-5
LOADER_FRAMES = 64
# fuse checks: (tag, (D, H, W) volume, (W, H) depth, focal length)
FUSE_SHAPES = (("vga", (256, 256, 256), (640, 480), 550.0),
               ("kitti", (200, 136, 248), (1242, 375), 1068.0))
# cameras whose views pick the z, y and x sweeps
SWEEP_EYES = {0: (0.3, -0.2, -3.0), 1: (0.2, 3.0, 0.4), 2: (-3.0, 0.3, -0.2)}
# H100 SXM published peaks: HBM bytes/s, float32 operations/s outside the
# tensor cores
HBM_BPS, F32_OPS = 3.35e12, 67e12


def die(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


class Smoke:
    """Runs the phases, collecting failures instead of stopping at the first."""

    def __init__(self, torch, np):
        self.torch, self.np = torch, np
        self.failures: list[str] = []
        self.max_err = {k: 0.0 for k in KERNELS}

    def phase(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:  # a phase's failure is recorded, later phases still run
            self.failures.append(f"{name}: exception")
            traceback.print_exc()
            return None
        finally:  # where the run's 1200 s go
            print(f"  ({name}: {time.perf_counter() - t0:.1f} s)")

    def compare(self, kernel, what, got, want, atol, mask=None):
        """Max abs error of got vs want where both are finite; NaN (and
        infinity) positions must agree exactly."""
        torch = self.torch
        g, w = got.detach().float(), want.detach().float()
        if mask is not None:
            g, w = g[mask], w[mask]
        fin_g, fin_w = torch.isfinite(g), torch.isfinite(w)
        same_nonfinite = torch.equal(fin_g, fin_w) and torch.equal(g[~fin_g].nan_to_num(7.0),
                                                                   w[~fin_w].nan_to_num(7.0))
        both = fin_g & fin_w
        err = (g[both] - w[both]).abs().max().item() if bool(both.any()) else 0.0
        ok = same_nonfinite and err <= atol
        if kernel in self.max_err:
            self.max_err[kernel] = max(self.max_err[kernel], err)
        print(f"  {'ok  ' if ok else 'FAIL'} {kernel:9s} {what}: max_abs_err {err:.3g} "
              f"(atol {atol:g}), non-finite positions {'equal' if same_nonfinite else 'DIFFER'}")
        if not ok:
            self.failures.append(f"{kernel} {what}")
        return ok


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


# --- the output side and the remaining solvers (phase 3 checks, phase 4 times) ---------
# None of these paths launches a kernel: they are plain PyTorch on the card,
# and the meshing runs on the host. ``ctx`` carries what main() made: the
# device, the Smoke, the KinectFusion runs, the Stereo2App, the launch
# counters and the timing helpers.


def _no_launches(ctx, name, fn):
    """Run ``fn()`` with the launch counts set to 0 just before and read just
    after: these paths launch no kernel, and the smoke says so."""
    ctx.reset_counts()
    out = fn()
    ctx.sync()
    launched = {k: v for k, v in ctx.read_counts().items() if v}
    print(f"  {'ok  ' if not launched else 'FAIL'} {name}: kernel launches "
          f"{launched or 'none'}")
    if launched:
        ctx.smoke.failures.append(f"phase 3 {name}: launched {launched}")
    return out


def _check(ctx, ok, name, msg):
    print(f"  {'ok  ' if ok else 'FAIL'} {name}: {msg}")
    if not ok:
        ctx.smoke.failures.append(f"phase 3 {name}: {msg}")


def volume_io_checks(ctx):
    """save_volume of the 8-frame separable run, then load_volume into a
    second app: val, weight and the box bit-equal."""
    import tempfile

    torch, pipe = ctx.torch, ctx.kf_pipe
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/save.vol"

        def round_trip():
            pipe.save_volume(path)
            other = ctx.kf.KinectFusion(ctx.kf_K, ctx.kf_cfg, device=ctx.dev)
            other.load_volume(path)
            return other

        other = _no_launches(ctx, "save_volume + load_volume", round_trip)
        size = Path(path).stat().st_size
    pairs = ((other.vol.val, pipe.vol.val), (other.vol.weight, pipe.vol.weight),
             (other.vol.bbox.lo, pipe.vol.bbox.lo), (other.vol.bbox.hi, pipe.vol.bbox.hi))
    same = all(a.device == b.device and torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in pairs)
    _check(ctx, same, "volume files", f"{size} bytes written; loaded val, weight and box "
           f"{'bit-equal' if same else 'DIFFER'} on {other.vol.val.device}")


def mesh_checks(ctx):
    """save_mesh ("tet" and "mc") of the 8-frame separable run: triangle
    counts, the vertices against the analytic scene, the .ply read back;
    native against NumPy on sphere_scene(128) for both meshers."""
    import tempfile

    from kangaroo_tpu_torch.fusion import marching_cubes as mc
    from kangaroo_tpu_torch.fusion import marching_cubes256 as mc256

    np, pipe = ctx.np, ctx.kf_pipe
    voxel = float(pipe.vol.voxel_size_units().mean())
    scene = ctx.synthetic.sphere_scene(ctx.scene_res, device=ctx.dev)
    for method in ("tet", "mc"):
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/mesh.ply"
            tris = _no_launches(ctx, f"save_mesh {method}",
                                lambda: pipe.save_mesh(path, method=method))
            verts, faces = mc.load_ply(path)
        v = tris.reshape(-1, 3).astype(np.float64)
        analytic = np.abs(np.min([np.linalg.norm(v - np.asarray(c), axis=1) - r
                                  for c, r in SCENE_SPHERES], axis=0)) / voxel
        pts = ctx.torch.from_numpy(v.astype(np.float32)).to(ctx.dev)
        sampled = np.abs(scene.sample_trilinear_world(pts).cpu().numpy()) / voxel
        q = {f"{name} {k}": float(np.percentile(e, p)) for name, e in (("analytic", analytic),
                                                                     ("scene", sampled))
             for k, p in (("median", 50), ("p99", 99))}
        ctx.mesh_triangles[method] = len(tris)
        ctx.mesh_quality[method] = q
        ply_ok = np.array_equal(verts.reshape(-1, 3, 3), tris) and len(faces) == len(tris)
        ok = (len(tris) > 10000 and q["analytic median"] < MESH_MEDIAN_VOXELS
              and q["scene p99"] < MESH_P99_VOXELS and ply_ok)
        _check(ctx, ok, f"save_mesh {method}", f"{len(tris)} triangles; |sdf| of the vertices in "
               f"voxels ({voxel:.6f} m) {json.dumps({k: round(x, 4) for k, x in q.items()})}: "
               f"analytic median limit {MESH_MEDIAN_VOXELS}, scene p99 limit {MESH_P99_VOXELS}; "
               f".ply read back {'equal' if ply_ok else 'DIFFERENT'}")
    arrays = mc.volume_arrays(ctx.synthetic.sphere_scene(ctx.numpy_res, device=ctx.dev))
    for name, mod in (("tet", mc), ("mc", mc256)):
        native, numpy_ = (mod.extract_arrays(*arrays, use_native=n) for n in (True, False))
        if name == "mc":  # the same triangles in another order
            ok = np.array_equal(_canonical(np, native), _canonical(np, numpy_))
            how = "equal as sorted triangle sets"
        else:  # the NumPy extractor forms the corners' positions in float64
            err = (float(np.abs(np.sort(native.reshape(-1, 3), 0)
                                - np.sort(numpy_.reshape(-1, 3), 0)).max())
                   if len(native) == len(numpy_) else float("inf"))
            ok = err <= 1e-5
            how = f"sorted coordinates within {err:.3g} (limit 1e-5)"
        _check(ctx, ok and len(native) == len(numpy_) > 0,
               f"native vs NumPy {name} on sphere_scene({ctx.numpy_res})",
               f"{len(native)} vs {len(numpy_)} triangles, {how}")


def _canonical(np, tris):
    flat = tris.reshape(len(tris), 9)
    return flat[np.lexsort(flat.T[::-1])]


def _cpu_copy(ctx, pipe):
    """The same app on the CPU holding a copy of ``pipe``'s state."""
    from kangaroo_tpu_torch.containers import BoundedVolume, BoundingBox, TsdfVolume

    box = lambda b: BoundingBox(b.lo.cpu(), b.hi.cpu())  # noqa: E731
    cpu = ctx.kf.KinectFusion(pipe.K, pipe.cfg, device="cpu")
    cpu.vol = TsdfVolume(pipe.vol.val.cpu(), pipe.vol.weight.cpu(), box(pipe.vol.bbox))
    if pipe.color_vol is not None:
        cpu.color_vol = BoundedVolume(pipe.color_vol.data.cpu(), box(pipe.color_vol.bbox))
    cpu.T_wl = pipe.T_wl.cpu()
    cpu.keyframes = [(img.cpu(), K, T.cpu()) for img, K, T in pipe.keyframes]
    return cpu


def _compare_renders(ctx, name, got, want):
    """tests/test_torch_kinectfusion_engines.py's render tolerances: NaN
    masks within 0.5 % of the pixels, depth within 1e-4 and the other
    outputs within 1e-3 elsewhere."""
    np = ctx.np
    gd, wd = got[0].cpu().numpy(), want[0].cpu().numpy()
    gn, wn = np.isnan(gd), np.isnan(wd)
    both = ~gn & ~wn
    mask_share = float((gn != wn).mean())
    derr = float(np.abs(gd - wd)[both].max()) if both.any() else float("inf")
    errs = [float(np.abs(g.cpu().numpy()[both] - w.cpu().numpy()[both]).max())
            for g, w in zip(got[1:], want[1:])]
    ok = mask_share <= 0.005 and both.sum() > 100 and derr <= 1e-4 and max(errs) <= 1e-3
    _check(ctx, ok, name, f"{int(both.sum())} pixels hit; NaN masks differ on "
           f"{100 * mask_share:.3f} % (limit 0.5 %), depth {derr:.3g} (limit 1e-4), normals "
           f"and rgba {max(errs):.3g} (limit 1e-3)")


def texture_checks(ctx):
    """save_keyframe on two frames of the colour run, then render_textured
    at level TEXTURE_LEVEL against the same call on a CPU copy."""
    torch, pipe = ctx.torch, ctx.kf_colour_pipe
    img = ctx.kf_data["rgb"]
    T_last = pipe.T_wl
    pipe.keyframes.clear()
    for T in (ctx.kf_colour_poses[1], ctx.kf_colour_poses[-2]):
        pipe.T_wl = T
        pipe.save_keyframe(img)
    pipe.T_wl = T_last
    got = _no_launches(ctx, "render_textured",
                       lambda: pipe.render_textured(level=TEXTURE_LEVEL))
    want = _cpu_copy(ctx, pipe).render_textured(level=TEXTURE_LEVEL)
    alpha = bool((got[2][..., 3] == 1).all())
    lit = got[2][..., :3][torch.isfinite(got[0])]
    _check(ctx, alpha and float(lit.std()) > 0.01, "render_textured image",
           f"{tuple(got[2].shape)}, alpha 1 {alpha}, textured grey std {float(lit.std()):.4f}")
    _compare_renders(ctx, f"render_textured level {TEXTURE_LEVEL} card vs CPU", got, want)


def heightmap_mesh_checks(ctx):
    """HeightmapFusion.save_mesh after Stereo2App's steady frame: the .ply's
    vertices are world_vbo's."""
    import tempfile

    from kangaroo_tpu_torch.fusion import marching_cubes as mc

    np, hm = ctx.np, ctx.stereo2_app.hm
    with tempfile.TemporaryDirectory() as tmp:
        n = _no_launches(ctx, "HeightmapFusion.save_mesh", lambda: hm.save_mesh(f"{tmp}/hm.ply"))
        verts, faces = mc.load_ply(f"{tmp}/hm.ply")
    vbo = hm.world_vbo()[0][..., :3].reshape(-1, 3).cpu().numpy()
    same = (np.isfinite(vbo).all()
            and np.array_equal(np.unique(verts, axis=0), np.unique(vbo, axis=0)))
    _check(ctx, same and n == len(faces) > 0, "heightmap mesh",
           f"{n} triangles on a {hm.w}x{hm.h} grid; the .ply's vertices "
           f"{'are' if same else 'are NOT'} world_vbo's")


def _texture(ctx, T_wc, depth, K, channels=1):
    """A procedural texture on the world surface seen in a depth frame, per
    channel c 127.5 + 60 sin(a x + 2c) sin(b y + 1) + 40 sin(c z) with
    (a, b, c) = TEX_FREQ (a wavelength of 18-25 cm: enough gradient for the
    photometric GN to converge), 0 where the depth is missing: (H, W) or
    (H, W, 3)."""
    torch = ctx.torch
    P = ctx.se3.transform(T_wc, K.unproject_grid(depth.shape[1], depth.shape[0], depth))
    x, y, z = P[..., 0], P[..., 1], P[..., 2]
    chans = [127.5 + 60.0 * torch.sin(TEX_FREQ[0] * x + 2.0 * c) * torch.sin(TEX_FREQ[1] * y + 1.0)
             + 40.0 * torch.sin(TEX_FREQ[2] * z) for c in range(channels)]
    img = torch.stack(chans, -1) if channels > 1 else chans[0]
    ok = torch.isfinite(depth) & (depth > 0)
    return torch.where(ok[..., None] if channels > 1 else ok, img, 0.0)


def solver_inputs(ctx):
    """VGA inputs of the solver checks, on the card: the orbit's frames 0
    (reference) and GN_LIVE_FRAME (live) textured, their depth and points,
    the true reference -> live pose, a perturbed start, a colour rig."""
    torch, se3, K = ctx.torch, ctx.se3, ctx.kf_K
    poses, depths = ctx.kf_data["poses"], ctx.kf_data["depths"]
    d_ref = torch.where(depths[0] > 0, depths[0], float("nan"))
    d_live = torch.where(depths[GN_LIVE_FRAME] > 0, depths[GN_LIVE_FRAME], float("nan"))
    T_lr = se3.compose(se3.inverse(poses[GN_LIVE_FRAME]), poses[0])
    s = types.SimpleNamespace(
        K=K, Km=K.matrix(device=ctx.dev).clone(), depth=d_ref, T_lr=T_lr,
        ref=_texture(ctx, poses[0], d_ref, K), live=_texture(ctx, poses[GN_LIVE_FRAME], d_live, K),
        ref3=_texture(ctx, poses[0], d_ref, K, 3),
        live3=_texture(ctx, poses[GN_LIVE_FRAME], d_live, K, 3),
        points=ctx.depth_mod.depth_to_vbo(d_ref, K),
        disp=torch.where(torch.isfinite(d_ref), K.fu * GN_BASELINE / d_ref, 0.0),
        start=se3.compose(T_lr, se3.exp(torch.tensor(GN_PERTURB, device=ctx.dev))),
        T_cd=se3.exp(torch.tensor([0.03, 0.002, -0.001, 0.004, -0.003, 0.002], device=ctx.dev)))
    return s


def _four(torch, T):
    """(3, 4) -> (4, 4), the last row made on the device (no host copy)."""
    return torch.cat([T, torch.eye(4, device=T.device)[3:]], 0)


def solver_calls(ctx, s):
    """name -> fn(inputs) -> LSS, for the four photometric builders and both
    calibration builders."""
    torch = ctx.torch
    from kangaroo_tpu_torch.solvers import calibration, photometric

    def esm(x, disparity=False):
        T4 = _four(torch, x.T_lr)
        args = (x.Km, x.Km, x.Km, torch.eye(4, device=x.Km.device), T4, x.Km @ x.T_lr, 40.0)
        if disparity:
            return photometric.pose_refinement_from_disparity_esm(x.live, x.ref, x.disp,
                                                                  GN_BASELINE, *args)
        return photometric.pose_refinement_from_depth_esm(x.live, x.ref, x.depth, *args)

    return {
        "pose_refinement_from_points": lambda x: photometric.pose_refinement_from_points(
            x.live, x.ref, x.points, x.Km @ x.T_lr, 40.0),
        "pose_refinement_from_disparity": lambda x: photometric.pose_refinement_from_disparity(
            x.live, x.ref, x.disp, x.Km @ x.T_lr, 40.0, GN_BASELINE, x.K, 8.0),
        "pose_refinement_from_depth_esm": esm,
        "pose_refinement_from_disparity_esm": lambda x: esm(x, disparity=True),
        "calibration_rgbd_from_depth_esm": lambda x: calibration.calibration_rgbd_from_depth_esm(
            x.live, x.ref, x.points, x.Km, x.T_cd, x.T_lr, 40.0),
        "kinect_calibration": lambda x: calibration.kinect_calibration(
            x.points, x.live3, x.points, x.ref3, x.Km @ x.T_cd, x.T_lr, 40.0),
    }


def _cpu_inputs(s):
    """A copy of the inputs on the CPU (the Intrinsics as they are)."""
    return types.SimpleNamespace(**{k: v.cpu() if hasattr(v, "cpu") else v
                                    for k, v in vars(s).items()})


def _gauss_newton(ctx, x, steps):
    """``steps`` damped GN steps of pose_refinement_from_depth_esm from
    x.start: the pose reference grey -> live grey."""
    torch, se3 = ctx.torch, ctx.se3
    from kangaroo_tpu_torch.solvers import photometric

    T = x.start
    eye4 = torch.eye(4, device=T.device)
    for _ in range(steps):
        sys_ = photometric.pose_refinement_from_depth_esm(
            x.live, x.ref, x.depth, x.Km, x.Km, x.Km, eye4, _four(torch, T), x.Km @ T, 40.0)
        T = se3.compose(T, se3.exp(-sys_.solve(damping=1e-3)))
    return T


def manhattan_inputs(ctx, device):
    """A VGA image of stripes along both image axes over seeded noise, and a
    tilted start rotation."""
    np, torch = ctx.np, ctx.torch
    img = np.random.default_rng(16).uniform(0, 20, (ctx.H, ctx.W)).astype(np.float32)
    img[:, ::16] = 255.0
    img[::16, :] = 255.0
    R0 = ctx.se3.exp(torch.tensor([0.0, 0.0, 0.0, 0.02, -0.015, 0.03]))[:, :3]
    return torch.from_numpy(img).to(device), R0.to(device)


def rectify_rig(ctx):
    torch, se3 = ctx.torch, ctx.se3
    R = se3.exp(torch.tensor([0.0, 0.0, 0.0, 0.02, 0.03, 0.01]))[:, :3]
    T_rl = torch.cat([R, (R @ torch.tensor([-0.1, 0.004, 0.002]))[:, None]], 1)
    K = ctx.kf_K
    K_r = ctx.Intrinsics.create(K.fu + 1.0, K.fv + 0.5, K.u0 + 1.5, K.v0 - 1.5)
    return T_rl, ctx.kf_K, K_r, (-0.05, 0.01, 0.03, -0.002)


def pose_graph_inputs(ctx, seed=0):
    """A loop of n keyframes (a 2 pi turn), noisy starts, odometry edges, a
    loop edge every 10 keyframes and one closing the loop, all measured with
    noise (so the optimum keeps a residual), and a prior on keyframe n / 2:
    (starts, edges, priors) as float32 NumPy."""
    np, torch, se3, n = ctx.np, ctx.torch, ctx.se3, ctx.keyframes
    rng = np.random.default_rng(seed)
    exp = lambda xi: se3.exp(torch.tensor(np.asarray(xi, np.float32)))  # noqa: E731
    true = [se3.identity(device="cpu")]
    for _ in range(n - 1):
        true.append(se3.compose(true[-1], exp([0.1, 0.0, 0.01, 0.0, 0.01, 2 * np.pi / n])))
    starts = [true[0]] + [se3.compose(T, exp(rng.normal(0, 0.01, 6))) for T in true[1:]]
    pairs = [(k, k + 1) for k in range(n - 1)] + [(k, k + 10) for k in range(0, n - 10, 10)]
    pairs.append((0, n - 1))
    edges = [(i, j, se3.compose(se3.compose(se3.inverse(true[j]), true[i]),
                                exp(rng.normal(0, 0.002, 6))).numpy()) for i, j in pairs]
    return [T.numpy() for T in starts], edges, [(n // 2, true[n // 2].numpy())]


def _graph(ctx, starts, edges, priors):
    from kangaroo_tpu_torch.geometry import pose_graph

    g = pose_graph.PoseGraph()
    for T in starts:
        g.add_keyframe(T)
    for i, j, T in edges:
        g.add_relative_edge(i, j, T)
    for i, T in priors:
        g.add_prior(i, T)
    return g


def solver_checks(ctx):
    """Each solver on the card against the same call on a CPU copy of its
    inputs: the six LSS builders at VGA, GN_STEPS steps of the depth ESM
    builder from a perturbed pose, the Manhattan rotation, the rectification
    tables of a tilted rig, and a pose graph of ctx.keyframes."""
    np, torch = ctx.np, ctx.torch
    from kangaroo_tpu_torch.geometry import rectify
    from kangaroo_tpu_torch.solvers import manhattan

    s = solver_inputs(ctx)
    cpu = _cpu_inputs(s)
    for name, call in solver_calls(ctx, s).items():
        got = _no_launches(ctx, name, lambda: call(s))
        want = call(cpu)
        errs = {f: float((getattr(got, f).cpu() - getattr(want, f)).abs().max())
                / max(float(getattr(want, f).abs().max()), 1e-30)
                for f in ("JTJ", "JTy", "sqErr", "obs")}
        ok = max(errs.values()) <= SOLVER_LSS_RTOL and float(want.obs) > 1000
        _check(ctx, ok, f"{name} card vs CPU", f"obs {float(got.obs):.0f} / "
               f"{float(want.obs):.0f}; errors of the largest entry "
               f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} (limit "
               f"{SOLVER_LSS_RTOL:g})")
    err = lambda T, x: float((T.cpu() - x.T_lr.cpu()).abs().max())  # noqa: E731
    T_card = _no_launches(ctx, f"depth ESM Gauss-Newton ({GN_STEPS} steps)",
                          lambda: _gauss_newton(ctx, s, GN_STEPS))
    T_cpu = _gauss_newton(ctx, cpu, GN_STEPS)
    e0, e_card, e_cpu = err(s.start, s), err(T_card, s), err(T_cpu, cpu)
    _check(ctx, e_card <= e_cpu + GN_SLACK and e_card < e0,
           f"depth ESM Gauss-Newton ({GN_STEPS} steps)",
           f"max pose error {e0:.4g} -> {e_card:.4g} on the card, {e_cpu:.4g} on the CPU "
           f"(limit the CPU's + {GN_SLACK:g})")
    img, R0 = manhattan_inputs(ctx, ctx.dev)
    got = _no_launches(ctx, "manhattan_line_cost",
                       lambda: manhattan.manhattan_line_cost(img, R0, ctx.kf_K))
    want = manhattan.manhattan_line_cost(img.cpu(), R0.cpu(), ctx.kf_K)
    errs = {f: float((getattr(got, f).cpu() - getattr(want, f)).abs().max())
            / max(float(getattr(want, f).abs().max()), 1e-30) for f in ("JTJ", "JTy", "sqErr", "obs")}
    _check(ctx, max(errs.values()) <= SOLVER_LSS_RTOL and float(want.obs) > 1000,
           "manhattan_line_cost card vs CPU", f"obs {float(got.obs):.0f} / {float(want.obs):.0f}; "
           f"errors of the largest entry {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}"
           f" (limit {SOLVER_LSS_RTOL:g})")
    # MANHATTAN_STEPS, not 10: the reference's update moves away from the
    # rotation (each step doubles the error, ROADMAP Queue 3), so its
    # rounding differences double a step too
    R_card = _no_launches(ctx, f"estimate_manhattan_rotation ({MANHATTAN_STEPS} steps)",
                          lambda: manhattan.estimate_manhattan_rotation(
                              img, ctx.kf_K, R0, iterations=MANHATTAN_STEPS))
    R_cpu = manhattan.estimate_manhattan_rotation(img.cpu(), ctx.kf_K, R0.cpu(),
                                                  iterations=MANHATTAN_STEPS)
    d = float((R_card.cpu() - R_cpu).abs().max())
    moved = float((R_cpu - R0.cpu()).abs().max())
    _check(ctx, d <= MANHATTAN_ATOL and moved > 1e-3,
           f"estimate_manhattan_rotation ({MANHATTAN_STEPS} steps) card vs CPU",
           f"max difference {d:.3g} (limit {MANHATTAN_ATOL:g}); moved {moved:.4f} from R0")
    T_rl, K_l, K_r, dist = rectify_rig(ctx)
    got = _no_launches(ctx, "create_scanline_rectified_lookup",
                       lambda: rectify.create_scanline_rectified_lookup(
                           ctx.W, ctx.H, T_rl, K_l, K_r, *dist, device=ctx.dev))
    want = rectify.create_scanline_rectified_lookup(ctx.W, ctx.H, T_rl, K_l, K_r, *dist,
                                                    device="cpu")
    d = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    _check(ctx, d <= RECTIFY_ATOL, "create_scanline_rectified_lookup card vs CPU",
           f"tables and rig within {d:.3g} px (limit {RECTIFY_ATOL:g})")
    starts, edges, priors = pose_graph_inputs(ctx)
    g_card, g_cpu = _graph(ctx, starts, edges, priors), _graph(ctx, starts, edges, priors)
    name = (f"PoseGraph.optimize ({ctx.keyframes} keyframes, {len(edges)} edges, 1 prior, "
            "10 iterations)")
    r_card = _no_launches(ctx, name, lambda: g_card.optimize(iterations=10, device=ctx.dev))
    r_cpu = g_cpu.optimize(iterations=10, device="cpu")
    rel = abs(r_card - r_cpu) / r_cpu
    dp = max(float(np.abs(a - b).max()) for a, b in zip(g_card.poses, g_cpu.poses))
    _check(ctx, rel <= POSE_GRAPH_RTOL and r_cpu > 0, f"{name} card vs CPU",
           f"final residual {r_card!r} vs {r_cpu!r}: {rel:.3g} relative (limit "
           f"{POSE_GRAPH_RTOL:g}); poses within {dp:.3g}")


def output_checks(ctx):
    """Phase 3 of the output side and the remaining solvers."""
    for name, fn in (("volume I/O", volume_io_checks), ("meshes", mesh_checks),
                     ("keyframe texturing", texture_checks),
                     ("heightmap mesh", heightmap_mesh_checks), ("solvers", solver_checks)):
        print(f"phase 3 output side and solvers: {name}")
        ctx.smoke.phase(f"phase 3 {name}", fn, ctx)


def _host_ms(ctx, run, runs=3):
    """Host clock (the work ends in a synchronise): median, min and max ms."""
    import statistics

    ms = []
    for _ in range(runs):
        ctx.sync()
        t0 = time.perf_counter()
        run()
        ctx.sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms)}


def output_times(ctx):
    """Phase 4 of the output side and the solvers: host-clock times of the
    mesh (the copy to the host and each extraction apart) and of the volume
    files; CUDA-event times, launches and host synchronisations of the
    textured render and of each solver call."""
    import tempfile

    from kangaroo_tpu_torch.fusion import marching_cubes as mc
    from kangaroo_tpu_torch.fusion import marching_cubes256 as mc256
    from kangaroo_tpu_torch.geometry import rectify
    from kangaroo_tpu_torch.solvers import manhattan

    pipe, card, out = ctx.kf_pipe, ctx.card, ctx.times

    def host(name, run, runs=3):
        out[name] = _host_ms(ctx, run, runs)
        syncs = ctx.host_syncs(run)
        out[name]["host_syncs"] = sum(syncs.values())
        print(f"  {name:44s} {out[name]['median_ms']:.3f} ms (min {out[name]['min_ms']:.3f}, "
              f"max {out[name]['max_ms']:.3f}, {runs} runs, host clock); "
              f"{sum(syncs.values())} host synchronisations [{card}]")

    def events(name, run, runs=10):
        out[name] = dict(ctx.timed(name, run, runs=runs))
        out[name]["host_syncs"] = sum(ctx.host_syncs(run).values())
        print(f"  {'':34s} {out[name]['host_syncs']} host synchronisations a call")

    vol = pipe.vol
    arrays = mc.volume_arrays(vol)
    res = "x".join(str(n) for n in vol.val.shape)
    host(f"mesh copy to host (volume_arrays, {res})", lambda: mc.volume_arrays(vol))
    host("mesh extraction tet (native, host)", lambda: mc.extract_arrays(*arrays))
    host("mesh extraction mc (native, host)", lambda: mc256.extract_arrays(*arrays))
    with tempfile.TemporaryDirectory() as tmp:
        for method in ("tet", "mc"):
            host(f"save_mesh {method} ({res}, whole call)",
                 lambda: pipe.save_mesh(f"{tmp}/m.ply", method=method))
        host(f"save_volume ({res})", lambda: pipe.save_volume(f"{tmp}/v.vol"))
        other = ctx.kf.KinectFusion(ctx.kf_K, ctx.kf_cfg, device=ctx.dev)
        host(f"load_volume ({res})", lambda: other.load_volume(f"{tmp}/v.vol"))
    events(f"render_textured ({ctx.W}x{ctx.H}, 2 keyframes)",
           lambda: ctx.kf_colour_pipe.render_textured())
    s = solver_inputs(ctx)
    for name, call in solver_calls(ctx, s).items():
        events(name, lambda: call(s))
    events(f"depth ESM Gauss-Newton ({GN_STEPS} steps)",
           lambda: _gauss_newton(ctx, s, GN_STEPS), runs=3)
    img, R0 = manhattan_inputs(ctx, ctx.dev)
    events("estimate_manhattan_rotation (10 steps)",
           lambda: manhattan.estimate_manhattan_rotation(img, ctx.kf_K, R0), runs=3)
    T_rl, K_l, K_r, dist = rectify_rig(ctx)
    events("create_scanline_rectified_lookup", lambda: rectify.create_scanline_rectified_lookup(
        ctx.W, ctx.H, T_rl, K_l, K_r, *dist, device=ctx.dev))
    starts, edges, priors = pose_graph_inputs(ctx)
    events(f"PoseGraph.optimize ({ctx.keyframes} keyframes, 10 its)",
           lambda: _graph(ctx, starts, edges, priors).optimize(iterations=10, device=ctx.dev),
           runs=3)
    print("  output-side and solver times: " + json.dumps(
        {k: {m: round(v, 4) for m, v in d.items()} for k, d in out.items()}) + f" [{card}]")


# --- the host side (phase 3 checks, phase 4 times) -----------------------------------------
# The frame loader, the rig files, the roo names, the debug, profiling and
# timing helpers and the demo programs. The file-fed KinectFusion frame and the
# demos launch the kernels of their paths, counted into ``ctx.host_launches``;
# the rest launches none. ``ctx`` is the output side's, with the stereo pair,
# the SGM frame and a scratch directory added.


def _same(torch, a, b):
    """Bit-equal, NaN at the same places."""
    return (a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0)))


def orbit_pgms(ctx):
    """The KinectFusion phase's orbit frames as 16-bit PGM depth files in
    millimetres (NaN -> 0): (paths, the raw uint16 frames, the true poses
    relative to frame 0, float32 (3, 4))."""
    from kangaroo_tpu_torch.io import pxm

    np = ctx.np
    T0 = np.vstack([ctx.kf_data["poses"][0].cpu().numpy().astype(np.float64), [0, 0, 0, 1]])
    paths, raws, rel = [], [], []
    for i, (T, d) in enumerate(zip(ctx.kf_data["poses"], ctx.kf_data["depths"])):
        raw = np.rint(np.nan_to_num(d.cpu().numpy(), nan=0.0) * np.float32(1000)).astype(np.uint16)
        paths.append(f"{ctx.tmp}/orbit/depth_{i:05d}.pgm")
        Path(paths[-1]).parent.mkdir(exist_ok=True)
        pxm.save_pxm(paths[-1], raw)
        raws.append(raw)
        T = np.vstack([T.cpu().numpy().astype(np.float64), [0, 0, 0, 1]])
        rel.append((np.linalg.inv(T0) @ T)[:3].astype(np.float32))
    return paths, raws, rel


def _count_launches(ctx, launched):
    for k, n in launched.items():
        ctx.host_launches[k] += n


def file_fed_checks(ctx):
    """KinectFusion(front_volume=True, depth_scale=1e-3) at 256^3/VGA fed
    16-bit PGM files through FrameLoader: frame indices in order, the fuse
    kernel once a frame, poses bit-equal to the same frames fed from memory,
    ATE and final rmse within the JAX package's CPU-JAX figures + slack, and
    4 loader threads bit-equal to 1."""
    from kangaroo_tpu_torch.io.frame_loader import FrameLoader

    torch, np = ctx.torch, ctx.np
    paths, raws, rel = ctx.orbit = orbit_pgms(ctx)
    raw0 = torch.from_numpy(raws[0])
    _check(ctx, torch.equal(raw0.to(ctx.dev).to(torch.float32).cpu(), raw0.to(torch.float32)),
           "uint16 on the card", "a uint16 tensor on the card converts to float32 exactly")

    def run(frames):
        cfg = dataclasses.replace(ctx.kf_cfg, front_volume=True)
        pipe = ctx.kf.KinectFusion(ctx.kf_K, cfg, device=ctx.dev)
        cfg.depth_scale = 1e-3  # after construction, as the demo sets it
        pipe.T_wl = torch.from_numpy(rel[0]).to(ctx.dev)
        ctx.sync()
        ctx.reset_counts()
        prev = ctx.read_counts()
        indices, poses, launches = [], [], []
        for i, raw in frames:
            indices.append(i)
            poses.append(pipe.process_frame(torch.from_numpy(raw)).clone())
            ctx.sync()
            now = ctx.read_counts()
            launches.append({k: now[k] - prev[k] for k in now if now[k] != prev[k]})
            prev = now
        return pipe, indices, poses, launches

    pipe, indices, poses, launches = run(FrameLoader(paths, n_threads=1))
    ctx.file_pipe = pipe
    for f, (T, n) in enumerate(zip(poses, launches)):
        print(f"  frame {f}: kernel launches {n or 'none'}, t {T[:, 3].tolist()}")
    _count_launches(ctx, {k: sum(n.get(k, 0) for n in launches) for k in ctx.host_launches})
    _check(ctx, indices == list(range(len(paths))), "file-fed frames",
           f"indices {indices} in order")
    _check(ctx, all(n == {"separable_fuse": 1} for n in launches), "file-fed fuse",
           f"the fuse kernel once a frame and nothing else, frame 0 too (front_volume=True): "
           f"{launches}")
    _, _, mem_poses, _ = run(enumerate(raws))
    _check(ctx, all(torch.equal(a, b) for a, b in zip(poses, mem_poses)), "file vs memory",
           "poses bit-equal to the same uint16 frames fed from memory")
    est = torch.stack(poses[1:])[:, :, 3].cpu().numpy()
    ref = np.stack(rel[1:])[:, :, 3]
    q = {"ate_rmse_m": float(np.sqrt(np.mean(np.sum((est - ref) ** 2, axis=1)))),
         "final_rmse": pipe.rmse}
    lim = {"ate_rmse_m": KF_FILE_JAX["ate_rmse_m"] + KF_ATE_SLACK,
           "final_rmse": KF_FILE_JAX["final_rmse"] + KF_RMSE_SLACK}
    _check(ctx, all(np.isfinite(q[k]) and q[k] <= lim[k] for k in lim), "file-fed quality",
           f"{json.dumps(q)}; the JAX package on CPU-JAX: {json.dumps(KF_FILE_JAX)}; limits "
           f"{json.dumps(lim)}")
    one = dict(FrameLoader(paths, n_threads=1))
    four = dict(FrameLoader(paths, n_threads=4))
    _check(ctx, sorted(four) == sorted(one) and all(np.array_equal(four[i], one[i]) for i in one),
           "loader threads", f"4 threads yield all {len(one)} frames bit-equal to 1 thread")


RIG_JSON = {"cameras": [
    {"name": "left", "width": 1280, "height": 960, "fu": 1152.0, "fv": 1152.0, "u0": 639.5,
     "v0": 479.5},
    {"name": "right", "width": 1280, "height": 960, "fu": 1152.0, "fv": 1152.0, "u0": 639.5,
     "v0": 479.5, "T_wc": [0.08, 0.0, 0.0, 0.0, 0.0, 0.0]}]}


def rig_checks(ctx):
    """save_rig, then load_rig, of a two-camera rig with a 0.08 m baseline
    (at twice VGA, scaled to it); depth_and_cloud of the VGA/64 SGM frame
    with the rig's K and baseline equal to the call with them given."""
    from kangaroo_tpu_torch.apps import stereo
    from kangaroo_tpu_torch.io import rig as rig_mod

    torch = ctx.torch
    src, path = Path(ctx.tmp) / "rig_in.json", Path(ctx.tmp) / "rig.json"
    src.write_text(json.dumps(RIG_JSON))
    rig_mod.save_rig(str(path), rig_mod.load_rig(str(src)))
    rig = rig_mod.load_rig(str(path))
    ctx.rig_path = str(path)
    _check(ctx, abs(rig.baseline() - 0.08) <= 1e-6, "rig baseline",
           f"baseline() {rig.baseline()!r} (0.08 within 1e-6)")
    K = rig["left"].scaled_to(ctx.W, ctx.H).intrinsics()
    given = ctx.Intrinsics.create(576.0, 576.0, 319.5, 239.5)
    got = _no_launches(ctx, "depth_and_cloud with the rig",
                       lambda: stereo.depth_and_cloud(ctx.sgm_disp, K, rig.baseline(), 1.0))
    want = stereo.depth_and_cloud(ctx.sgm_disp, given, 0.08, 1.0)
    _check(ctx, K == given and all(_same(torch, a, b) for a, b in zip(got, want)), "rig path",
           f"K {K}; depth and cloud bit-equal to the call with K and 0.08 given")


# (run, demo module, arguments, kernels it must launch, kernels it may launch,
# the files the JAX demo writes); "{input}" and "{rig}" are filled in
_SGM4 = {"sgm", "wta", "median", "lr_check"}
_DTAM = {"wta", "median", "lr_check", "wta_sq", "dtam"}
_KF_FILES = ("kf_render.png", "kf_depth.png", "kf_mesh.ply", "kf_save.vol")


def _stereo_files(mode, extra=()):
    return ("left.png", "gt_disp.png", f"disp_{mode}.png", f"depth_{mode}.png",
            f"cloud_{mode}.ply") + extra


DEMO_RUNS = (
    ("kinectfusion", "kinectfusion_demo", [], {"separable_fuse"}, {"separable_fuse"}, _KF_FILES),
    ("kinectfusion --input", "kinectfusion_demo", ["--input", "{input}"], {"separable_fuse"},
     {"separable_fuse"}, _KF_FILES),
    ("kinectfusion --sequence", "kinectfusion_demo", ["--sequence"], {"separable_fuse"},
     {"separable_fuse"}, _KF_FILES),
    # the colour fuse is plain PyTorch: no kernel
    ("kinectfusion --colour", "kinectfusion_demo", ["--colour"], set(), set(), _KF_FILES),
    ("stereo sgm", "stereo_demo", [], _SGM4, _SGM4, _stereo_files("sgm")),
    ("stereo sgm --heightmap", "stereo_demo", ["--heightmap"], _SGM4, _SGM4,
     _stereo_files("sgm", ("heightmap_sgm.ply",))),
    ("stereo sgm --rig", "stereo_demo", ["--rig", "{rig}"], _SGM4, _SGM4, _stereo_files("sgm")),
    ("stereo dtam", "stereo_demo", ["--mode", "dtam"], _DTAM, _DTAM, _stereo_files("dtam")),
    ("stereo wta", "stereo_demo", ["--mode", "wta"], {"wta"}, {"wta", "median", "lr_check"},
     _stereo_files("wta")),
    ("stereo multiview", "stereo_demo", ["--mode", "multiview"], {"wta", "wta_sq", "dtam"},
     _DTAM, _stereo_files("multiview")),
    ("denoising", "denoising_demo", [], {"rof", "tgv"}, {"rof", "tgv"},
     ("noisy.png", "denoised_rof.png", "denoised_tgv.png", "blurry.png", "deconvolved.png",
      "corrupted.png", "inpainted.png")),
    ("filters", "filters_demo", [], set(), set(), ("anaglyph.png", "bilateral.png", "guided.png")),
    ("features", "features_demo", [], set(), set(), ("fast.png", "harris_nms.png")),
    ("raycast", "raycast_demo", [], set(), set(),
     tuple(f"raycast_{k}_{i}.png" for k in ("shaded", "depth", "normals", "sweep")
           for i in range(3))),
    ("sdf_fusion", "sdf_fusion_demo", [], set(), set(),
     ("raycast_primitives.png", "sdf_fusion_render.png", "sdf_fusion_gt_diff.png", "save.vol",
      "fused.ply")),
    ("sdf_difference", "sdf_difference_demo", [], set(), set(),
     ("sdf_diff.png", "sdf_diff_shaded.png")),
    ("sum_speed", "sum_speed_demo", [], set(), set(), ()),
)


def demo_input(ctx):
    """The kinectfusion demo's --input: 8 frames of its default camera
    (160x120, focal 144) on an orbit of radius 2 m, as 16-bit PGM files."""
    from kangaroo_tpu_torch.io import pxm

    torch, np, syn = ctx.torch, ctx.np, ctx.synthetic
    d = Path(ctx.tmp) / "demo_input"
    d.mkdir(exist_ok=True)
    K = ctx.Intrinsics.centered(144.0, 160, 120)
    scene = syn.sphere_scene(res=128, device=ctx.dev)
    for i, (_, depth) in enumerate(syn.depth_sequence(8, K, 160, 120, scene=scene, step=0.02,
                                                      radius=2.0)):
        raw = torch.round(torch.nan_to_num(depth, nan=0.0) * 1000.0).cpu().numpy()
        pxm.save_pxm(str(d / f"depth_{i:05d}.pgm"), raw.astype(np.uint16))
    return str(d)


def demo_checks(ctx):
    """Each demo's main at its defaults, in this process, with the launch
    counts set to 0 just before and read just after: the kernels of its
    path launched, no other, and the JAX demo's files written."""
    import importlib
    import io
    import os

    fill = {"{input}": demo_input(ctx), "{rig}": ctx.rig_path}
    ctx.demo_times = {}
    for name, module, args, must, may, files in DEMO_RUNS:
        demo = importlib.import_module(f"kangaroo_tpu_torch.examples.{module}")
        out = Path(ctx.tmp) / "demos" / name.replace(" ", "_").replace("-", "")
        out.mkdir(parents=True)
        argv = [fill.get(a, a) for a in args]
        prev_out = os.environ.get("KANGAROO_OUT")
        os.environ["KANGAROO_OUT"] = str(out)
        log = io.StringIO()
        try:
            ctx.sync()
            ctx.reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                result = demo.main(argv)
            ctx.sync()
            ctx.demo_times[name] = time.perf_counter() - t0
        finally:
            if prev_out is None:
                del os.environ["KANGAROO_OUT"]
            else:
                os.environ["KANGAROO_OUT"] = prev_out
        launched = {k: v for k, v in ctx.read_counts().items() if v}
        _count_launches(ctx, launched)
        missing = [f for f in files if not (out / f).is_file() or (out / f).stat().st_size == 0]
        ok = set(must) <= set(launched) <= set(may) and not missing
        last = log.getvalue().strip().splitlines()[-1:] or [""]
        _check(ctx, ok, f"demo {name}",
               f"{ctx.demo_times[name]:.2f} s, kernel launches {launched or 'none'}, "
               f"{len(files) - len(missing)} of {len(files)} files (missing {missing}); "
               f"{last[0][:120]}")
        if name == "sum_speed":
            ctx.lss_stats = result


def roo_checks(ctx):
    """The reference-namespace shim's representative calls on CUDA tensors
    against the same calls on CPU copies, with no kernel launched: floats
    within ROO_RTOL relative and ROO_ATOL absolute (SGM within the kernels'
    1e-4), integers exactly, NaN at the same places."""
    from kangaroo_tpu_torch import BoundingBox, TsdfVolume
    from kangaroo_tpu_torch import roo

    torch, np = ctx.torch, ctx.np
    rng = np.random.default_rng(0)
    right = rng.random((48, 96)).astype(np.float32)
    host = {"img": rng.random((120, 160)).astype(np.float32), "left": np.roll(right, 3, axis=1),
            "right": right, "J": rng.random((120, 160, 6)).astype(np.float32),
            "y": rng.random((120, 160)).astype(np.float32),
            "p": rng.random((120, 160, 2)).astype(np.float32)}

    def calls(dev):
        a = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        vol = roo.CensusStereoVolume(roo.Census(a["left"], window="9x7"),
                                     roo.Census(a["right"], window="9x7"), max_disp=16).float()
        dl = roo.CostVolMinimumSubpix(vol, -1)
        sgm = roo.SemiGlobalMatching(vol, a["left"], 0.01, 0.02)
        box = BoundingBox.create((-1.0,) * 3, (1.0,) * 3, device=dev)
        sphere = roo.SdfSphere(TsdfVolume.create(32, 32, 32, box, trunc_dist=0.2),
                               torch.zeros(3, device=dev), 0.5)
        lss = roo.SumSpeedTest(a["J"], a["y"])
        return {"GaussianBlur": roo.GaussianBlur(a["img"], 2.0, rad=3),
                "MedianFilter3x3": roo.MedianFilter3x3(a["img"]),
                "CostVolMinimum": roo.CostVolMinimum(vol),
                "CostVolMinimumSubpix": dl,
                "LeftRightCheck": roo.LeftRightCheck(dl, roo.CostVolMinimumSubpix(vol, 1), -1,
                                                     0.5, 16),
                "SemiGlobalMatching": sgm,
                "SdfSphere": sphere.val,
                "GradU": roo.GradU(a["img"]), "Divergence": roo.Divergence(a["p"]),
                "SumSpeedTest JTJ": lss.JTJ, "SumSpeedTest JTy": lss.JTy,
                "DenseStereoSubpix": roo.DenseStereoSubpix(a["left"], a["right"], 6),
                "ConvertImage uint8": roo.ConvertImage(a["img"], "uint8")}

    got = _no_launches(ctx, "roo calls on the card", lambda: calls(ctx.dev))
    want = calls("cpu")
    bad = []
    for name, g in got.items():
        g, w = g.cpu(), want[name]
        if not g.is_floating_point():
            ok = torch.equal(g, w)
        else:
            atol = ATOL["sgm"] if name == "SemiGlobalMatching" else ROO_ATOL
            scale = float(w[torch.isfinite(w)].abs().max()) if bool(torch.isfinite(w).any()) else 0
            fin = torch.isfinite(g) & torch.isfinite(w)
            err = float((g[fin] - w[fin]).abs().max()) if bool(fin.any()) else 0.0
            ok = torch.equal(torch.isnan(g), torch.isnan(w)) and err <= atol + ROO_RTOL * scale
        if not ok:
            bad.append(name)
    _check(ctx, not bad, "roo card vs CPU", f"{len(got)} calls agree with their CPU copies"
           + (f"; differ: {bad}" if bad else ""))


def debug_profiling_checks(ctx):
    """debug_mode raising on a NaN made on the card, checked recording a
    division by zero there; device_memory_report naming the card; Timer."""
    from kangaroo_tpu_torch.apps import stereo_sgm
    from kangaroo_tpu_torch.utils import debug, profiling, timing

    torch = ctx.torch
    x = torch.tensor([-1.0, 1.0], device=ctx.dev)
    try:
        with debug.debug_mode():
            torch.log(x)
        raised = None
    except FloatingPointError as exc:
        raised = str(exc)
    with debug.debug_mode():
        torch.exp(x)  # finite: no raise
    err, _ = debug.checked(lambda v: 1.0 / (v + 1.0))(x)
    _check(ctx, raised == "invalid value (nan) encountered in log"
           and err.get() == "division by zero", "debug on the card",
           f"debug_mode raised {raised!r}; checked recorded {err.get()!r}")
    report = profiling.device_memory_report()
    _check(ctx, ctx.kind in report, "device_memory_report", report.replace("\n", "; "))
    timer = timing.Timer("sgm")
    timer.start()
    disp = stereo_sgm.sgm_pipeline(ctx.left, ctx.right, ctx.sgm_cfg)
    _check(ctx, timer.stop({"disp": [disp]}) > 0 and len(timer.times) == 1, "Timer",
           f"one interval of {1e3 * timer.times[0]:.3f} ms ending in a synchronise")


def trace_check(ctx):
    """A profiling.trace of one SGM frame: its Chrome trace names the path
    kernels. Run after phase 4, so that no profile that phase 4 counts
    launches in follows this profile."""
    import os

    from kangaroo_tpu_torch.apps import stereo_sgm
    from kangaroo_tpu_torch.utils import profiling

    logdir = Path(ctx.tmp) / "trace"
    with profiling.trace(str(logdir)):
        stereo_sgm.sgm_pipeline(ctx.left, ctx.right, ctx.sgm_cfg)
    traces = os.listdir(logdir)
    text = (logdir / traces[0]).read_text() if len(traces) == 1 else ""
    _check(ctx, "sgm_rows_kernel" in text and "sgm_cols_kernel" in text, "profiling.trace",
           f"{traces}: {len(text)} bytes naming sgm_rows_kernel and sgm_cols_kernel")


def host_side_checks(ctx):
    """Phase 3 of the host side (``trace_check`` runs after phase 4)."""
    for name, fn in (("file-fed KinectFusion", file_fed_checks), ("rig", rig_checks),
                     ("demos", demo_checks), ("roo", roo_checks),
                     ("debug, memory report, timing", debug_profiling_checks)):
        print(f"phase 3 host side: {name}")
        ctx.smoke.phase(f"phase 3 {name}", fn, ctx)


def host_side_times(ctx):
    """Phase 4 of the host side: the loader's decode rate (host clock), the
    file-fed frame against the memory-fed frame in turns (events), the
    upload's host time, the LSS reduction of sum_speed_demo and each demo's
    wall time."""
    import statistics

    from kangaroo_tpu_torch.io.frame_loader import FrameLoader
    from kangaroo_tpu_torch.io import pxm

    torch, np, card, out = ctx.torch, ctx.np, ctx.card, ctx.times
    paths, raws, _ = ctx.orbit
    many = [f"{ctx.tmp}/decode/depth_{i:05d}.pgm" for i in range(LOADER_FRAMES)]
    Path(many[0]).parent.mkdir(exist_ok=True)
    for i, p in enumerate(many):
        pxm.save_pxm(p, raws[i % len(raws)])
    for label, kw in (("1 thread", {"n_threads": 1}), ("4 threads", {"n_threads": 4}),
                      ("NumPy reader", {"use_native": False})):
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            n = sum(1 for _ in FrameLoader(many, **kw))
            rates.append(n / (time.perf_counter() - t0))
        out[f"decode {label}"] = {"median_fps": statistics.median(rates), "min_fps": min(rates),
                                  "max_fps": max(rates)}
        print(f"  decode VGA 16-bit PGM, {label}: {statistics.median(rates):.1f} frames/s (min "
              f"{min(rates):.1f}, max {max(rates):.1f}; {LOADER_FRAMES} files, 3 runs, host "
              f"clock) [{card}]")
    raw = raws[-1]
    out["upload (host clock)"] = _host_ms(ctx, lambda: torch.from_numpy(raw).to(ctx.dev), runs=20)
    print(f"  upload of a 640x480 uint16 frame: {out['upload (host clock)']['median_ms']:.4f} ms "
          f"(20 runs, host clock, ends in a synchronise) [{card}]")
    pipe = ctx.file_pipe  # a stationary camera on the last frame: the same work each call

    def file_fed():
        it = iter(FrameLoader([paths[-1]] * 24, n_threads=1))
        return lambda: pipe.process_frame(torch.from_numpy(next(it)[1]))

    for k, turn in enumerate(("file-fed", "memory-fed", "memory-fed", "file-fed")):
        run = file_fed() if turn == "file-fed" else (
            lambda: pipe.process_frame(torch.from_numpy(raw)))
        out[f"KinectFusion frame {turn} {k}"] = ctx.timed(f"KinectFusion frame, {turn}", run,
                                                          runs=10, warmup=2)
    s = ctx.lss_stats
    n = 480 * 640
    out["LSS reduction"] = {"median_ms": 1e3 * s["median"], "min_ms": 1e3 * s["min"],
                            "max_ms": 1e3 * s["max"], "gobs_per_s": n / s["median"] / 1e9}
    print(f"  sum_speed_demo LSS<float,6> over {n} obs: {1e3 * s['median']:.4f} ms (min "
          f"{1e3 * s['min']:.4f}, max {1e3 * s['max']:.4f}; time_fn_stats, 3 x 2000 calls, "
          f"events), {n / s['median'] / 1e9:.2f} Gobs/s [{card}]")
    for name, t in ctx.demo_times.items():
        out[f"demo {name}"] = {"wall_s": t}
    print("  demo wall times (host clock, first call in this process, the kernels already "
          "built): " + json.dumps({k: round(v, 3) for k, v in ctx.demo_times.items()})
          + f" [{card}]")
    print("  host-side times: " + json.dumps(
        {k: {m: round(v, 4) for m, v in d.items()} for k, d in out.items()
         if k.startswith(("decode", "upload", "KinectFusion frame", "LSS"))}) + f" [{card}]")


def main() -> int:
    if not (HERE / "kangaroo_tpu_torch").is_dir():
        die("the kangaroo_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < 1:
        die("no CUDA device")

    from kangaroo_tpu_torch import _build
    from kangaroo_tpu_torch.apps import kinectfusion as kf
    from kangaroo_tpu_torch.apps import stereo, stereo_sgm, synthetic
    from kangaroo_tpu_torch.containers import BoundingBox, Intrinsics, TsdfVolume, pyramid
    from kangaroo_tpu_torch.core import se3
    from kangaroo_tpu_torch.fusion import raycast, rolling, sdf, separable, separable_cuda
    from kangaroo_tpu_torch.fusion import marching_cubes, marching_cubes256
    from kangaroo_tpu_torch.io import frame_loader
    from kangaroo_tpu_torch.ops import bilateral, blur, integral_image, resample
    from kangaroo_tpu_torch.ops import median as median_plain
    from kangaroo_tpu_torch.ops import median_cuda
    from kangaroo_tpu_torch.parallel import mesh as mesh_mod
    from kangaroo_tpu_torch.parallel import sharding
    from kangaroo_tpu_torch.solvers import plane_fit
    from kangaroo_tpu_torch.geometry import depth as depth_mod
    from kangaroo_tpu_torch.geometry import heightmap
    from kangaroo_tpu_torch.stereo import census, costvolume, dense_stereo, dispatch, lr_cuda
    from kangaroo_tpu_torch.stereo import sgm as sgm_plain
    from kangaroo_tpu_torch.stereo import dtam_cuda, sgm_cuda, wta_cuda
    from kangaroo_tpu_torch.utils import timing
    from kangaroo_tpu_torch.variational import deconvolution, rof, solvers_cuda, tgv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)  # exactly as nvidia-smi gives it: name, power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"capability {torch.cuda.get_device_capability(0)}")

    # --- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    try:
        lib = _build.library()
    except Exception as exc:  # the build's own message says what failed
        die(f"kernel build failed: {exc}")
    build_s = time.perf_counter() - t0
    print(f"phase 1 build: {build_s:.3f} s for {len(KERNELS)} kernels "
          f"({lib._name.rsplit('/', 1)[-1]}) [{card}]")
    ptxas = Path(lib._name).with_suffix(".log")
    if ptxas.exists():
        print(ptxas.read_text(), file=sys.stderr)
    t0 = time.perf_counter()
    try:
        marching_cubes.native_library()
        marching_cubes256.native_library()
        frame_loader.native_library()
    except Exception as exc:  # g++'s own message says what failed
        die(f"host core build failed: {exc}")
    print(f"phase 1 build: {time.perf_counter() - t0:.3f} s for the 3 host cores (the 2 meshing "
          f"cores and the frame loader; g++, kangaroo_tpu_torch/native/*.cpp) [{card}]")

    smoke = Smoke(torch, np)
    rng = np.random.default_rng(0)
    # kernel -> (module, attribute) of its launch count
    counters = {"sgm": (sgm_cuda, "launches"), "sgm_8path": (sgm_cuda, "diagonal_launches"),
                "sgm_segment": (sgm_cuda, "segment_launches"),
                "sgm_diag_segment": (sgm_cuda, "diag_segment_launches"),
                "wta": (wta_cuda, "launches"), "median": (median_cuda, "launches"),
                "lr_check": (lr_cuda, "launches"), "rof": (solvers_cuda, "rof_launches"),
                "tgv": (solvers_cuda, "tgv_launches"), "wta_sq": (wta_cuda, "sq_launches"),
                "dtam": (dtam_cuda, "launches"), "separable_fuse": (separable_cuda, "launches")}

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    @contextlib.contextmanager
    def lines_design():
        """Inside, the segment wrappers launch ``csrc/sgm.cu``'s
        ``kt_sgm_segment_lines`` (the warp-per-line design) in place of
        ``kt_sgm_segment``."""
        launch = sgm_cuda._launch
        sgm_cuda._launch = sgm_cuda._launch_lines
        try:
            yield
        finally:
            sgm_cuda._launch = launch

    def lattice(D, W, sd):
        d = torch.arange(D, device=dev)[:, None]
        x = torch.arange(W, device=dev)[None, :]
        m = (d <= x) if sd < 0 else (x + d < W)
        return m[:, None, :]

    def with_bad(a, frac, inf_frac=0.0):
        a = a.clone()
        a[torch.from_numpy(rng.random(a.shape) < frac).to(dev)] = float("nan")
        if inf_frac:
            a[torch.from_numpy(rng.random(a.shape) < inf_frac).to(dev)] = float("inf")
        return a

    def noisy_image(H, W, seed):
        """A bright rectangle on black with Gaussian noise, and a mask that
        keeps four pixels in five."""
        r = np.random.default_rng(seed)
        clean = np.zeros((H, W), np.float32)
        clean[H // 4:H // 2, W // 4:W // 2] = 0.8
        noisy = clean + 0.15 * r.standard_normal((H, W)).astype(np.float32)
        keep = (r.random((H, W)) > 0.2).astype(np.float32)
        return tuple(torch.from_numpy(a).to(dev) for a in (clean, noisy, keep))

    def host_syncs(run):
        """The host synchronisations of ``run()``: torch's sync debug mode
        warns on each; the innermost lines of the port on the stack say
        where."""
        import collections
        import warnings

        sites = collections.Counter()

        def record(*_args, **_kwargs):
            stack = [f for f in traceback.extract_stack() if "kangaroo_tpu_torch" in f.filename]
            sites[" <- ".join(f"{Path(f.filename).name}:{f.lineno}"
                              for f in stack[::-1][:2]) or "(outside the port)"] += 1

        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return sites

    def device_us(run, reps=1):
        """Device time by kernel of ``reps`` runs of ``run()`` (torch.profiler):
        {name: (launches, us)}, and the wall time in us. The stream is
        drained first; a profile that recorded no device activity (a short
        one now and then does) is taken again, up to three times."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    run()
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
            kernels = {e.key: (e.count, e.self_device_time_total)
                       for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
            if kernels:
                break
        return kernels, wall_us

    def per_launch(run, part, reps=100):
        """Device us a launch of the kernels named ``part`` over ``reps``
        calls of ``run()`` back to back (torch.profiler), their launches, and
        the other device work {name: (launches, us)}."""
        run()
        kernels, _ = device_us(run, reps)
        named = lambda k: part + "<" in k or part + "(" in k  # noqa: E731
        n = sum(v[0] for k, v in kernels.items() if named(k))
        us = sum(v[1] for k, v in kernels.items() if named(k))
        return (us / n if n else 0.0), n, {k: v for k, v in kernels.items() if not named(k)}

    def host_us(run, reps=100):
        """Host us a call of ``run()``: a host clock over ``reps`` calls
        without a synchronise (what a caller's thread spends)."""
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        us = 1e6 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        return us

    # --- phase 2: each kernel against its plain version -----------------------
    def kernels_vs_plain(tag, H, W, D):
        left, right, _ = synthetic.stereo_pair(W, H, D, seed=0, device=dev)
        cl, cr = census.census(left, "16x16"), census.census(right, "16x16")
        bits = census.norm_bits("16x16")
        imgs = {-1: stereo_sgm._intensity(left), 1: stereo_sgm._intensity(right)}
        vols = {-1: census.census_cost_volume(cl, cr, D, -1, bits, dtype=torch.bfloat16),
                1: census.census_cost_volume(cr, cl, D, 1, bits, dtype=torch.bfloat16)}
        rand_vol = torch.from_numpy(rng.random((D, H, W), dtype=np.float32)).to(dev)
        rand_img = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
        disps = {}
        for sd in (-1, 1):
            m = lattice(D, W, sd)
            for src, vol, img in (("census-bf16", vols[sd], imgs[sd]),
                                  ("random-f32", rand_vol, rand_img)):
                agg = sgm_cuda.semi_global_matching(vol, img, 0.01, 0.02, sd=sd)
                ref = sgm_plain.semi_global_matching(vol, img, 0.01, 0.02, sd=sd)
                smoke.compare("sgm", f"{tag} {src} sd={sd:+d}", agg, ref, ATOL["sgm"],
                              m.expand_as(agg))
                smoke.compare("sgm_8path", f"{tag} {src} sd={sd:+d}",
                              sgm_cuda.semi_global_matching(vol, img, 0.01, 0.02,
                                                            do_diagonal=True, sd=sd),
                              sgm_plain.semi_global_matching(vol, img, 0.01, 0.02,
                                                             do_diagonal=True, sd=sd),
                              ATOL["sgm_8path"], m.expand_as(agg))
                for vsrc, v in ((src, vol), (f"{src}-aggregate", agg)):
                    got = wta_cuda.cost_vol_minimum_subpix(v, sd)
                    smoke.compare("wta", f"{tag} {vsrc} sd={sd:+d}", got,
                                  costvolume.cost_vol_minimum_subpix(v, sd), ATOL["wta"])
                    if src == "census-bf16" and vsrc != src:
                        disps[sd] = got
        # the DTAM auxiliary search around the volume's WTA disparity, each
        # case also through kt_wta_sq_pixel (the one-thread-per-pixel
        # design, exactly); the census volume also as a view at an odd
        # element offset (element loads)
        for sd in (-1, 1):
            odd = torch.empty(vols[sd].numel() + 1, dtype=vols[sd].dtype, device=dev)
            odd[1:] = vols[sd].flatten()
            for src, vol in (("census-bf16", vols[sd]), ("random-f32", rand_vol),
                             ("census-bf16-odd-view", odd[1:].view(D, H, W))):
                noise = torch.from_numpy(rng.normal(0, 1.5, (H, W)).astype(np.float32)).to(dev)
                last = costvolume.cost_vol_minimum_subpix(vol, sd) + noise
                for theta in (100.0, 1.0, 1e-3):
                    what = f"{tag} {src} sd={sd:+d} theta={theta:g}"
                    got = wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, last, 20.0, theta,
                                                                          sd)
                    smoke.compare("wta_sq", what, got,
                                  costvolume.cost_vol_minimum_square_penalty_subpix(
                                      vol, last, 20.0, theta, sd), ATOL["wta_sq"])
                    smoke.compare("wta_sq", f"{what} vs kt_wta_sq_pixel", got,
                                  wta_cuda._square_penalty_pixel(vol, last, 20.0, theta, sd), 0.0)
        # the DTAM alternation on the census volumes (and the same volumes
        # as float32): the cold solve, and 3 + 3 incremental steps against
        # 6 (beta 1e-3 makes the anneal show); each also through
        # kt_dtam_run_split (three launches an iteration, exactly)
        for sd in (-1, 1):
            g = costvolume.exponential_edge_weight(imgs[sd], 14.0, 2.5)
            d0 = costvolume.cost_vol_minimum_subpix(vols[sd], sd)
            q0 = torch.zeros((H, W, 2), device=dev)
            cold = (100.0, 1.0, *DTAM_ARGS, 1e-5, DTAM_ITERS, sd)
            for src, vol in (("census-bf16", vols[sd]), ("census-f32", vols[sd].float())):
                got = dtam_cuda.dtam_run(vol, g, d0, d0, q0, *cold)
                old = dtam_cuda._dtam_run_split(vol, g, d0, d0, q0, *cold)
                what = f"{tag} {src} sd={sd:+d} cold {DTAM_ITERS} it"
                for name, a, b, c in zip(("d", "a", "q", "theta"), got,
                                         stereo.dtam_iterate_plain(vol, g, d0, d0, q0, *cold), old):
                    smoke.compare("dtam", f"{what} {name}", a, b, ATOL["dtam"])
                    smoke.compare("dtam", f"{what} {name} vs kt_dtam_run_split", a, c, 0.0)
            state = (d0, d0, q0, 100.0, 7.0)
            six = dtam_cuda.dtam_step(vols[sd], g, *state, *DTAM_ARGS, 1e-3, iterations=6, sd=sd)
            s1 = dtam_cuda.dtam_step(vols[sd], g, *state, *DTAM_ARGS, 1e-3, iterations=3, sd=sd)
            s2 = dtam_cuda.dtam_step(vols[sd], g, *s1, *DTAM_ARGS, 1e-3, iterations=3, sd=sd)
            plain = stereo.dtam_increment(vols[sd], g, *state, *DTAM_ARGS, 1e-3, iterations=6,
                                          sd=sd)
            old = dtam_cuda._dtam_run_split(vols[sd], g, d0, d0, q0, 100.0, 7.0, *DTAM_ARGS,
                                            1e-3, 6, sd)
            for name, a, b, p in zip(("d", "a", "q", "theta", "n"), six, s2, plain):
                smoke.compare("dtam", f"{tag} sd={sd:+d} steps 3+3 vs 6 {name}", b, a, 0.0)
                smoke.compare("dtam", f"{tag} sd={sd:+d} steps 6 vs plain {name}", a, p,
                              ATOL["dtam"])
            for name, a, c in zip(("d", "a", "q", "theta"), s2, old):
                smoke.compare("dtam", f"{tag} sd={sd:+d} steps 3+3 vs 6 through "
                              f"kt_dtam_run_split {name}", a, c, 0.0)
        # median: the frame's disparities and a random image, with bad taps
        med_in = {"disparity": with_bad(disps[-1], 0.1),
                  "random": with_bad(rand_img, 0.05, inf_frac=0.02)}
        for src, img in med_in.items():
            for rad, max_bad in ((2, 12),) if src == "disparity" else ((1, 4), (2, 12), (3, 20)):
                smoke.compare("median", f"{tag} {src} rad={rad} max_bad={max_bad}",
                              median_cuda.median_filter_reject_invalid(img, max_bad, rad),
                              median_plain.median_filter_reject_invalid(img, max_bad, rad),
                              ATOL["median"])
        # LR: the frame's disparities, and random ones spilling past the sweep
        rnd = [with_bad(torch.from_numpy(rng.uniform(-3, D + 3, (H, W)).astype(np.float32))
                        .to(dev), 0.05) for _ in range(2)]
        for src, (a, b) in (("disparity", (disps[-1], disps[1])), ("random", rnd),
                            ("random W=1", [t[:, :1].contiguous() for t in rnd])):
            for sd, (dl, dr) in ((-1, (a, b)), (1, (b, a))):
                got = lr_cuda.left_right_check(dl, dr, sd, 1.0, max_disp=D)
                smoke.compare("lr_check", f"{tag} {src} sd={sd:+d}", got,
                              costvolume.left_right_check(dl, dr, sd, 1.0, max_disp=D),
                              ATOL["lr_check"])
                smoke.compare("lr_check", f"{tag} {src} sd={sd:+d} vs kt_lr_check_pixel", got,
                              lr_cuda._check_pixel(dl, dr, sd, 1.0, D), 0.0)
            # both directions in one launch against two launches of the
            # replaced design in the reference's order, and the plain pair
            got_l, got_r = lr_cuda.left_right_check_pair(a, b, 1.0, max_disp=D)
            old_r = lr_cuda._check_pixel(b, a, 1, 1.0, D)
            old_l = lr_cuda._check_pixel(a, old_r, -1, 1.0, D)
            plain_l, plain_r = costvolume.left_right_check_pair(a, b, 1.0, D)
            for side, g, o, pl in (("right", got_r, old_r, plain_r), ("left", got_l, old_l,
                                                                       plain_l)):
                smoke.compare("lr_check", f"{tag} {src} pair {side}", g, pl, ATOL["lr_check"])
                smoke.compare("lr_check", f"{tag} {src} pair {side} vs two kt_lr_check_pixel",
                              g, o, 0.0)

    def median_vs_pixel_design():
        """The median on tiles against ``kt_median_reject_invalid_pixel`` and
        plain, exactly (+0 and -0 equal), on inputs with NaN, +inf and -inf at
        10 %, a bad row and a bad column, and +0 and -0 taps: every radius
        and max_bad 0, 1, 12, K and K + 5 at each shape, and a stack of 4
        VGA frames against 4 single launches."""
        def bad_input(shape, seed):
            r = np.random.default_rng(seed)
            a = r.uniform(0, 64, shape).astype(np.float32)
            for v in (np.nan, np.inf, -np.inf):
                a[r.random(shape) < 0.1 / 3] = v
            a[r.random(shape) < 0.1] = 0.0
            a[r.random(shape) < 0.1] = -0.0
            a[..., shape[-2] // 2, :] = np.nan
            a[..., :, shape[-1] // 3] = np.inf
            return torch.from_numpy(a).to(dev)

        for k, shape in enumerate(MEDIAN_SHAPES):
            img = bad_input(shape, 100 + k)
            for rad in median_cuda.RADII:
                bads = (0, 1, 12, (2 * rad + 1) ** 2, (2 * rad + 1) ** 2 + 5)
                got = torch.stack([median_cuda.median_filter_reject_invalid(img, b, rad)
                                   for b in bads])
                what = f"{shape[1]}x{shape[0]} rad={rad} max_bad {bads}"
                smoke.compare("median", what, got, torch.stack(
                    [median_plain.median_filter_reject_invalid(img, b, rad) for b in bads]),
                    ATOL["median"])
                smoke.compare("median", f"{what} vs kt_median_reject_invalid_pixel", got,
                              torch.stack([median_cuda._median_pixel(img, b, rad) for b in bads]),
                              0.0)
        stack = bad_input((BATCH, 480, 640), 99)
        for rad in median_cuda.RADII:
            got = median_cuda.median_filter_reject_invalid(stack, 12, rad)
            what = f"stack of {BATCH} 640x480 rad={rad}"
            smoke.compare("median", what, got,
                          median_plain.median_filter_reject_invalid(stack, 12, rad), ATOL["median"])
            smoke.compare("median", f"{what} vs {BATCH} kt_median_reject_invalid_pixel", got,
                          torch.stack([median_cuda._median_pixel(f.contiguous(), 12, rad)
                                       for f in stack]), 0.0)

    def segments_vs_plain(tag, H, W, D, n):
        """The segment kernels against their plain versions on an n-way
        split, on the synthetic pair's census volumes and on random ones:
        the column shards' vertical pairs at their lattice offsets; the
        last column block's row segments chained down and up through their
        carries; the four diagonals' row segments likewise; each chain also
        against one pass through the same kernel (exactly). At VGA, the
        seam pass of 4 stacked frames against 4 single passes (exactly)
        and against the plain seam pass. Every case also runs through the
        warp-per-line design, which it equals exactly."""
        left, right, _ = synthetic.stereo_pair(W, H, D, seed=0, device=dev)
        cl, cr = census.census(left, "16x16"), census.census(right, "16x16")
        bits = census.norm_bits("16x16")
        imgs = {-1: stereo_sgm._intensity(left), 1: stereo_sgm._intensity(right)}
        vols = {-1: census.census_cost_volume(cl, cr, D, -1, bits, dtype=torch.bfloat16),
                1: census.census_cost_volume(cr, cl, D, 1, bits, dtype=torch.bfloat16)}
        rand_vol = torch.from_numpy(rng.random((D, H, W), dtype=np.float32)).to(dev)
        rand_img = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
        Hs, Ws = H // n, W // n

        def flat(x):
            return [x] if isinstance(x, torch.Tensor) else [t for y in x for t in flat(y)]

        def both(kernel, what, run):
            """run() through kt_sgm_segment, held exactly against the same
            run through kt_sgm_segment_lines (every tensor it returns);
            returns the former."""
            got = run()
            with lines_design():
                old = run()
            cat = lambda x: torch.cat([t.float().reshape(-1) for t in flat(x)])
            smoke.compare(kernel, f"{what} vs kt_sgm_segment_lines", cat(got), cat(old), 0.0)
            return got

        def chain(fn, vol, img, mode, rev, dx=None, c0=0):
            """Segments over the n row shards, downward or upward, through
            their carries, into one accumulator; returns it and the last
            carry."""
            acc = torch.zeros((D, H, vol.shape[2]), device=dev)
            N = vol.shape[2]
            if dx is None:
                carry = (None, None, None)
            else:
                zero = torch.zeros(N, device=dev)
                carry = (torch.full((D, N), 1e30, device=dev), zero, zero, zero)
            for k in (range(n - 1, -1, -1) if rev else range(n)):
                rows = slice(k * Hs, (k + 1) * Hs)
                if dx is None:
                    _, *carry = fn(vol[:, rows], img[rows], 0.01, 0.02, mode, width=W,
                                   seed=carry[0] is None, carry_prev=carry[0],
                                   carry_best=carry[1], last_img=carry[2], lane_offset=c0,
                                   acc=acc[:, rows], reverse=rev)
                else:
                    _, cp, cb, li, ch = fn(vol[:, rows], img[rows], *carry, 0.01, 0.02, mode,
                                           dx=dx, acc=acc[:, rows], reverse=rev)
                    carry = (cp, cb, ch, li)
            return acc, carry

        for sd in (-1, 1):
            mode = "left" if sd < 0 else "right"
            m = lattice(D, W, sd)
            for src, vol, img in (("census-bf16", vols[sd], imgs[sd]),
                                  ("random-f32", rand_vol, rand_img)):
                what = f"{tag} {src} sd={sd:+d}"
                for k in range(n):
                    cols = slice(k * Ws, (k + 1) * Ws)
                    args = (vol[:, :, cols], img[:, cols], 0.01, 0.02, True, mode)
                    label = f"{what} column shard {k}/{n} vertical pair"
                    got = both("sgm_segment", label, lambda: sgm_cuda.sgm_aggregate_scan(
                        *args, width=W, lane_offset=k * Ws))
                    smoke.compare("sgm_segment", label,
                                  got, sgm_plain.sgm_aggregate_scan(*args, width=W,
                                                                    lane_offset=k * Ws),
                                  ATOL["sgm_segment"], m[:, :, cols].expand_as(got))
                c0 = (n - 1) * Ws
                cols = slice(c0, W)
                for rev in (False, True):
                    sense = "up" if rev else "down"
                    acc_k, ck = both("sgm_segment", f"{what} {n} row segments {sense} and carry",
                                     lambda: chain(sgm_cuda.sgm_aggregate_block, vol[:, :, cols],
                                                   img[:, cols], mode, rev, c0=c0))
                    acc_p, cp = chain(sgm_plain.sgm_aggregate_block, vol[:, :, cols],
                                      img[:, cols], mode, rev, c0=c0)
                    mm = m[:, :, cols].expand_as(acc_k)
                    smoke.compare("sgm_segment", f"{what} {n} row segments {sense}, columns "
                                  f"{c0}..{W - 1}", acc_k, acc_p, ATOL["sgm_segment"], mm)
                    smoke.compare("sgm_segment", f"{what} {n} row segments {sense} carry best",
                                  ck[1], cp[1], ATOL["sgm_segment"])
                    one = both("sgm_segment", f"{what} one pass {sense}",
                               lambda: sgm_cuda.sgm_aggregate_block(
                                   vol[:, :, cols], img[:, cols], 0.01, 0.02, mode, width=W,
                                   lane_offset=c0, reverse=rev)[:3])[0]
                    smoke.compare("sgm_segment", f"{what} {n} row segments {sense} vs one pass",
                                  acc_k, one, 0.0, mm)
                for dx, rev in ((1, False), (-1, False), (1, True), (-1, True)):
                    sense = f"dx={dx:+d} {'up' if rev else 'down'}"
                    acc_k, ck = both("sgm_diag_segment", f"{what} {n} diagonal segments {sense} "
                                     "and carry", lambda: chain(sgm_cuda.sgm_aggregate_diag_block,
                                                                vol, img, mode, rev, dx))
                    acc_p, cp = chain(sgm_plain.sgm_aggregate_diag_block, vol, img, mode, rev, dx)
                    smoke.compare("sgm_diag_segment", f"{what} {n} diagonal segments {sense}",
                                  acc_k, acc_p, ATOL["sgm_diag_segment"], m.expand_as(acc_k))
                    smoke.compare("sgm_diag_segment", f"{what} {n} diagonal segments {sense} "
                                  "carry best", ck[1], cp[1], ATOL["sgm_diag_segment"])
                    zero = torch.zeros(W, device=dev)
                    one = both("sgm_diag_segment", f"{what} one diagonal pass {sense}",
                               lambda: sgm_cuda.sgm_aggregate_diag_block(
                                   vol, img, torch.full((D, W), 1e30, device=dev), zero, zero,
                                   zero, 0.01, 0.02, mode, dx=dx, reverse=rev)[:3])[0]
                    smoke.compare("sgm_diag_segment", f"{what} {n} diagonal segments {sense} "
                                  "vs one pass", acc_k, one, 0.0, m.expand_as(acc_k))
        if tag != "vga":
            return
        # the seam pass of 4 stacked frames (the batch's census volumes)
        pairs = [synthetic.stereo_pair(W, H, D, seed=k, device=dev) for k in range(BATCH)]
        vol4 = census.census_cost_volume(
            torch.cat([census.census(p[0], "16x16") for p in pairs]),
            torch.cat([census.census(p[1], "16x16") for p in pairs]), D, -1, bits,
            dtype=torch.bfloat16)
        img4 = stereo_sgm._intensity(torch.cat([p[0] for p in pairs]))
        seam = both("sgm_segment", f"{tag} seam pass of {BATCH} frames",
                    lambda: sgm_cuda.semi_global_matching(vol4, img4, seam_period=H))
        for k in range(BATCH):
            rows = slice(k * H, (k + 1) * H)
            smoke.compare("sgm_segment", f"{tag} seam pass of {BATCH} frames, frame {k} vs its "
                          "own pass", seam[:, rows],
                          sgm_cuda.semi_global_matching(vol4[:, rows].contiguous(),
                                                        img4[rows].contiguous()), 0.0)
        smoke.compare("sgm_segment", f"{tag} seam pass of {BATCH} frames vs plain", seam,
                      sgm_plain.semi_global_matching(vol4, img4, seam_period=H),
                      ATOL["sgm_segment"], lattice(D, W, -1).expand_as(seam))

    def path_vs_segment(tag, H, W, D):
        """The whole-image path kernel (``kt_sgm_path``) against the
        warp-per-line design (``kt_sgm_segment_lines``, no lattice offset,
        seam or carry) over the same image: each of the 8 steps alone on
        random bf16 and
        float32 volumes, both lattices, Lr written and added onto an
        accumulator; equal exactly (the same operations per element in
        the same order)."""
        vol32 = torch.from_numpy(rng.random((D, H, W), dtype=np.float32)).to(dev)
        img = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
        acc = torch.from_numpy(rng.random((D, H, W), dtype=np.float32)).to(dev)
        for src, vol in (("random-bf16", vol32.to(torch.bfloat16)), ("random-f32", vol32)):
            for sd in (-1, 1):
                for accumulate in (False, True):
                    for kernel, steps in (("sgm", STEPS[:4]), ("sgm_8path", STEPS[4:])):
                        got, want = [], []
                        for step in steps:
                            a = acc.clone() if accumulate else None
                            got.append(sgm_cuda.aggregate_direction(vol, img, step, 0.01, 0.02,
                                                                    sd, acc=a))
                            w = acc.clone() if accumulate else torch.empty_like(acc)
                            sgm_cuda._launch_lines(vol, img, w, w if accumulate else None, step,
                                                   sd, 0, W, 0, 0.01, 0.02, "sgm_segment")
                            want.append(w)
                        smoke.compare(kernel, f"{tag} {src} sd={sd:+d} steps {steps} "
                                      f"{'added onto acc' if accumulate else 'written'} vs "
                                      "kt_sgm_segment_lines", torch.stack(got), torch.stack(want),
                                      0.0)

    def solvers_vs_plain(H, W):
        """The solves on a noisy image and on uniform noise (bench.py's input);
        each ROF solve, inpaint through its public entry, and Huber solves
        of iteration counts that ROF_STEPS does not divide, also through the
        design it replaced (``kt_rof_denoise_steps``, exactly); TGV at
        ``TGV_ITERS`` (0, and counts that TGV_STEPS does not divide) and on
        the noisy image with NaN and infinity, also through the design it
        replaced (``kt_tgv_denoise_steps``, exactly)."""
        _, noisy, keep = noisy_image(H, W, seed=1)
        uniform = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
        for src, g in (("noisy", noisy), ("uniform", uniform)):
            for mode in ("tv", "huber", "lambda-weight"):
                args = dict(iterations=SOLVER_ITERS, model="tv" if mode == "tv" else "huber",
                            lam_weight=keep if mode == "lambda-weight" else None)
                what = f"{W}x{H} {src} {mode} {SOLVER_ITERS} it"
                got = solvers_cuda.rof_denoise(g, 8.0, **args)
                smoke.compare("rof", what, got, rof.denoise_plain(g, 8.0, **args), ATOL["rof"])
                smoke.compare("rof", f"{what} vs kt_rof_denoise_steps", got,
                              solvers_cuda._rof_denoise_steps(g, 8.0, **args), 0.0)
            masked = g * keep
            got = deconvolution.inpaint(masked, keep, iterations=SOLVER_ITERS)
            what = f"{W}x{H} {src} inpaint {SOLVER_ITERS} it"
            smoke.compare("rof", what, got, rof.denoise_plain(masked, 10.0,
                                                              iterations=SOLVER_ITERS,
                                                              lam_weight=keep), ATOL["rof"])
            smoke.compare("rof", f"{what} vs kt_rof_denoise_steps", got,
                          solvers_cuda._rof_denoise_steps(masked, 10.0, iterations=SOLVER_ITERS,
                                                          lam_weight=keep), 0.0)
            for its in (solvers_cuda.ROF_STEPS + 1, 37):
                smoke.compare("rof", f"{W}x{H} {src} huber {its} it vs kt_rof_denoise_steps",
                              solvers_cuda.rof_denoise(g, 8.0, iterations=its),
                              solvers_cuda._rof_denoise_steps(g, 8.0, iterations=its), 0.0)
            solve = solvers_cuda.tgv_denoise(g, iterations=SOLVER_ITERS)
            smoke.compare("tgv", f"{W}x{H} {src} {SOLVER_ITERS} it", solve,
                          tgv.denoise_plain(g, iterations=SOLVER_ITERS), ATOL["tgv"])
            for its in TGV_ITERS:
                got = solve if its == SOLVER_ITERS else solvers_cuda.tgv_denoise(g, iterations=its)
                smoke.compare("tgv", f"{W}x{H} {src} {its} it vs kt_tgv_denoise_steps", got,
                              solvers_cuda._tgv_denoise_steps(g, iterations=its), 0.0)
        bad = with_bad(noisy, 2e-5, 1e-5)
        bad[H // 2, W // 3] = float("-inf")
        for its in (9, SOLVER_ITERS):
            smoke.compare("tgv", f"{W}x{H} noisy with NaN and inf {its} it vs "
                          "kt_tgv_denoise_steps", solvers_cuda.tgv_denoise(bad, iterations=its),
                          solvers_cuda._tgv_denoise_steps(bad, iterations=its), 0.0)

    def small_tgv_vs_steps():
        """TGV on images smaller than a tile (and one a pixel past a tile
        each way) through both designs, exactly."""
        for H_, W_ in TGV_SMALL_SHAPES:
            g = torch.from_numpy(rng.standard_normal((H_, W_)).astype(np.float32)).to(dev)
            for its in TGV_ITERS:
                smoke.compare("tgv", f"{W_}x{H_} {its} it vs kt_tgv_denoise_steps",
                              solvers_cuda.tgv_denoise(g, iterations=its),
                              solvers_cuda._tgv_denoise_steps(g, iterations=its), 0.0)

    def backward_vs_plain():
        D, H, W = 16, 40, 72
        vol = torch.from_numpy(rng.random((D, H, W), dtype=np.float32)).to(dev)
        img = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
        disp = torch.from_numpy(rng.uniform(0, D, (H, W)).astype(np.float32)).to(dev)
        disp_r = disp + torch.from_numpy(rng.normal(0, 0.5, (H, W)).astype(np.float32)).to(dev)
        cases = {
            "sgm": (lambda v, i: dispatch.semi_global_matching(v, i),
                    lambda v, i: sgm_plain.semi_global_matching(v, i), (vol, img)),
            "sgm_8path": (lambda v, i: dispatch.semi_global_matching(v, i, do_diagonal=True),
                          lambda v, i: sgm_plain.semi_global_matching(v, i, do_diagonal=True),
                          (vol, img)),
            "wta": (lambda v: dispatch.cost_vol_minimum_subpix(v, -1),
                    lambda v: costvolume.cost_vol_minimum_subpix(v, -1), (vol,)),
            "median": (lambda d: dispatch.median_filter_reject_invalid(d, 12, 2),
                       lambda d: median_plain.median_filter_reject_invalid(d, 12, 2),
                       (with_bad(disp, 0.1),)),
            "lr_check": (lambda a, b: dispatch.left_right_check(a, b, -1, 1.0, D),
                         lambda a, b: costvolume.left_right_check(a, b, -1, 1.0, D),
                         (disp, disp_r)),
            # both outputs, each weighted (the stack is differentiable)
            "lr_pair": (lambda a, b: torch.stack(dispatch.left_right_check_pair(a, b, 1.0, D)),
                        lambda a, b: torch.stack(costvolume.left_right_check_pair(a, b, 1.0, D)),
                        (disp, disp_r)),
            "wta_sq": (lambda v, d: dispatch.cost_vol_minimum_square_penalty_subpix(v, d, 2.0, 0.5),
                       lambda v, d: costvolume.cost_vol_minimum_square_penalty_subpix(v, d, 2.0,
                                                                                      0.5),
                       (vol, disp)),
        }
        for name, (op, plain, inputs) in cases.items():
            grads = []
            for fn in (op, plain):
                xs = [t.clone().requires_grad_(True) for t in inputs]
                y = fn(*xs)
                weight = torch.linspace(0.5, 1.5, y.numel(), device=dev).reshape(y.shape)
                (y.nan_to_num(0.0) * weight).sum().backward()
                grads.append([x.grad if x.grad is not None else torch.zeros_like(x) for x in xs])
            for k, (g_op, g_plain) in enumerate(zip(*grads)):
                smoke.compare(f"{name}.grad", f"backward d/d(input {k})", g_op, g_plain,
                              GRAD_ATOL)

    for tag, H, W, D in SHAPES:
        print(f"phase 2 kernel vs plain at {tag} {W}x{H}/{D}:")
        smoke.phase(f"phase 2 {tag}", kernels_vs_plain, tag, H, W, D)
        torch.cuda.synchronize()
        n = SEGMENT_SHARDS[tag]
        print(f"phase 2 SGM segment kernels vs plain at {tag} {W}x{H}/{D}, {n}-way split:")
        smoke.phase(f"phase 2 segments {tag}", segments_vs_plain, tag, H, W, D, n)
        torch.cuda.synchronize()
        print(f"phase 2 SGM path kernel vs the warp-per-line design at {tag} {W}x{H}/{D}:")
        smoke.phase(f"phase 2 path {tag}", path_vs_segment, tag, H, W, D)
        torch.cuda.synchronize()
    for H, W in SOLVER_SHAPES:
        print(f"phase 2 solver kernels vs plain at {W}x{H}, {SOLVER_ITERS} iterations:")
        smoke.phase(f"phase 2 solvers {W}x{H}", solvers_vs_plain, H, W)
    print("phase 2 TGV on images smaller than a tile vs kt_tgv_denoise_steps:")
    smoke.phase("phase 2 tgv small", small_tgv_vs_steps)
    print("phase 2 median on tiles vs the one-thread-per-pixel design and plain:")
    smoke.phase("phase 2 median", median_vs_pixel_design)
    print("phase 2 backward through each autograd op vs the plain gradient:")
    smoke.phase("phase 2 backward", backward_vs_plain)

    def look_at(eye):
        """T_wc of a camera at ``eye`` looking at the origin (y down)."""
        z = -np.asarray(eye, np.float64)
        z /= np.linalg.norm(z)
        x = np.cross(z, [0.0, -1.0, 0.0])
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z], 1)
        return torch.from_numpy(np.concatenate([R, np.asarray(eye)[:, None]], 1)
                                .astype(np.float32)).to(dev)

    def fuse_vs_plain(tag, vol_shape, wh, f):
        """The fuse kernel against fuse_planes_plain on the three sweep axes,
        an empty and a fused volume, the full window, the frame's near/far
        window and a tight one, and enable=False."""
        Wi, Hi = wh
        K = Intrinsics.centered(f, Wi, Hi)
        cfg = kf.KinectFusionConfig(w=Wi, h=Hi)
        scene = synthetic.sphere_scene(res=128, device=dev)
        D, Hv, Wv = vol_shape
        bbox = BoundingBox.create((-1.2,) * 3, (1.2,) * 3, device=dev)
        vol = TsdfVolume.create(Wv, Hv, D, bbox, trunc_dist=float("nan"))
        trunc = 2.0 * float(np.linalg.norm(vol.voxel_size_units().cpu().numpy()))
        views = {}
        for axis, eye in SWEEP_EYES.items():
            T_wc = look_at(eye)
            depth, _, _ = raycast.raycast_sdf(scene, T_wc, K, Wi, Hi, 0.5, 8.0)
            _, v, n = kf.preprocess_depth(torch.nan_to_num(depth, 0.0), K, cfg)
            views[axis] = (v[0][..., 2], n[0], se3.inverse(T_wc))
        fused = TsdfVolume(vol.val.clone(), vol.weight.clone(), bbox)
        for axis in (0, 2):
            d, n, T_cw = views[axis]
            fused = separable.sdf_fuse_separable(fused, d, n, T_cw, K, trunc, inplace=True)
        for axis, (d, n, T_cw) in views.items():
            if separable._view_axis_index(T_cw) != axis:
                smoke.failures.append(f"phase 2 fuse {tag}: the pose for axis {axis} sweeps "
                                      f"{separable._view_axis_index(T_cw)}")
            for state, v in (("empty", vol), ("fused", fused)):
                for win, nf in (("full", None), ("near-far", (0.5, 6.0)),
                                ("tight", (2.2, 3.2))):
                    near, far = nf or (None, None)
                    gmd, gct, params, window = separable.fuse_inputs(
                        v, d, n, T_cw, K, trunc, 1000.0, 0.1, axis, clip_planes=nf is not None,
                        near=near, far=far)
                    got = (v.val.clone(), v.weight.clone())
                    want = (v.val.clone(), v.weight.clone())
                    old = (v.val.clone(), v.weight.clone())
                    separable_cuda.fuse_planes(*got, gmd, gct, params, window, axis, Wi, Hi)
                    separable.fuse_planes_plain(*want, gmd, gct, params, window, axis, Wi, Hi)
                    separable_cuda._fuse_planes_voxel(*old, gmd, gct, params, window, axis, Wi,
                                                      Hi)
                    what = f"{tag} axis {axis} {state} window {win} {window.tolist()}"
                    for k, part in enumerate(("val", "weight")):
                        smoke.compare("separable_fuse", f"{what} {part} vs "
                                      "kt_separable_fuse_voxel", got[k], old[k], 0.0)
                    gu, wu = got[1] > 0, want[1] > 0
                    flips = int((gu != wu).sum())
                    both = gu & wu
                    ok = flips <= FUSE_MAX_FLIP_SHARE * gu.numel() and int(both.sum()) > 1000
                    print(f"  {'ok  ' if ok else 'FAIL'} separable_fuse {what}: {int(wu.sum())} "
                          f"voxels updated, {flips} updated on one side only (limit "
                          f"{FUSE_MAX_FLIP_SHARE * gu.numel():.0f})")
                    if not ok:
                        smoke.failures.append(f"separable_fuse {what}: flips {flips}")
                    smoke.compare("separable_fuse", f"{what} val", got[0], want[0],
                                  ATOL["separable_fuse"], both)
                    smoke.compare("separable_fuse", f"{what} weight", got[1], want[1],
                                  FUSE_WEIGHT_ATOL, both)
                    smoke.compare("separable_fuse", f"{what} untouched val", got[0], want[0],
                                  0.0, ~gu & ~wu)
            # enable=False passes the volume through bit for bit
            gmd, gct, params, window = separable.fuse_inputs(
                fused, d, n, T_cw, K, trunc, 1000.0, 0.1, axis, enable=False, near=0.5, far=6.0)
            got = (fused.val.clone(), fused.weight.clone())
            separable_cuda.fuse_planes(*got, gmd, gct, params, window, axis, Wi, Hi)
            smoke.compare("separable_fuse", f"{tag} axis {axis} enable=False val", got[0],
                          fused.val, 0.0)
            smoke.compare("separable_fuse", f"{tag} axis {axis} enable=False weight", got[1],
                          fused.weight, 0.0)
            # an empty window touches nothing; both designs, enable=False too
            empty = torch.tensor([5, 5], dtype=torch.int32, device=dev)
            for win, w in (("enable=False", window), ("empty window", empty)):
                new_, old_ = ((fused.val.clone(), fused.weight.clone()) for _ in range(2))
                separable_cuda.fuse_planes(*new_, gmd, gct, params, w, axis, Wi, Hi)
                separable_cuda._fuse_planes_voxel(*old_, gmd, gct, params, w, axis, Wi, Hi)
                for k, part in enumerate(("val", "weight")):
                    smoke.compare("separable_fuse", f"{tag} axis {axis} {win} {part} vs "
                                  "kt_separable_fuse_voxel", new_[k], old_[k], 0.0)
                    if w is empty:
                        smoke.compare("separable_fuse", f"{tag} axis {axis} {win} {part}",
                                      new_[k], (fused.val, fused.weight)[k], 0.0)

    for tag, vol_shape, wh, f in FUSE_SHAPES:
        print(f"phase 2 separable_fuse vs plain at {tag}: volume {vol_shape}, depth "
              f"{wh[0]}x{wh[1]}:")
        smoke.phase(f"phase 2 fuse {tag}", fuse_vs_plain, tag, vol_shape, wh, f)
        torch.cuda.synchronize()

    # --- phase 3: the main paths ----------------------------------------------
    cfgs = {"4-path": stereo_sgm.SgmConfig(),
            "8-path": stereo_sgm.SgmConfig(do_diagonal=True)}
    H, W, D = 480, 640, cfgs["4-path"].max_disp
    left, right, gt = synthetic.stereo_pair(W, H, D, seed=0, device=dev)
    frame_kernels = {"4-path": ("sgm", "wta", "median", "lr_check"),
                     "8-path": ("sgm", "sgm_8path", "wta", "median", "lr_check")}
    # launches a frame of a single-device SGM frame: a median of each
    # image, one LR launch for both directions
    frame_want = {"median": 2, "lr_check": 1}

    def check_per_frame(name, frame, prev, now, want):
        for k, n in want.items():
            if now[k] - prev[k] != n:
                smoke.failures.append(f"phase 3 {name}: {k} launched {now[k] - prev[k]} times "
                                      f"in frame {frame}, not {n}")

    def plain_frame(left, right, cfg):
        """The frame composed of the plain versions, called by name (the
        volume filter, which has no kernel, as the frame calls it)."""
        bits = census.norm_bits(cfg.census_window)
        vol = census.census_cost_volume(census.census(left, cfg.census_window),
                                        census.census(right, cfg.census_window),
                                        cfg.max_disp, -1, bits,
                                        dtype=stereo_sgm._volume_dtype(cfg, bits))
        if cfg.bilateral_filter:
            vol = bilateral.bilateral_volume(vol, stereo_sgm._intensity(left), cfg.bilateral_gs,
                                             cfg.bilateral_gr, cfg.bilateral_size,
                                             gc=cfg.bilateral_gc)
        agg = sgm_plain.semi_global_matching(vol, stereo_sgm._intensity(left), cfg.p1, cfg.p2,
                                             do_diagonal=cfg.do_diagonal)
        dl = costvolume.cost_vol_minimum_subpix(agg, -1)
        dr = costvolume.cost_vol_minimum_subpix(costvolume.reanchor_right(agg), 1)
        dl = median_plain.median_filter_reject_invalid(dl, cfg.median_max_bad, 2)
        dr = median_plain.median_filter_reject_invalid(dr, cfg.median_max_bad, 2)
        dr = costvolume.left_right_check(dr, dl, 1, cfg.max_disp_diff, cfg.max_disp)
        return costvolume.left_right_check(dl, dr, -1, cfg.max_disp_diff, cfg.max_disp)

    launches = {}

    def frame_phase(name):
        cfg = cfgs[name]
        reset_counts()
        prev = read_counts()
        for f in range(FRAMES):
            disp = stereo_sgm.sgm_pipeline(left, right, cfg)
            torch.cuda.synchronize()
            now = read_counts()
            print(f"  {name} frame {f}: launches so far "
                  f"{ {k: now[k] for k in frame_kernels[name]} }")
            for k in frame_kernels[name]:
                if now[k] <= prev[k]:
                    smoke.failures.append(f"phase 3 {name}: {k} was not launched in frame {f}")
            check_per_frame(name, f, prev, now, frame_want)
            prev = now
        for k in frame_kernels[name]:
            launches.setdefault(k, prev[k])
        if tuple(disp.shape) != (H, W) or disp.dtype != torch.float32:
            smoke.failures.append(f"phase 3 {name}: output {tuple(disp.shape)} {disp.dtype}")
        check_agreement(name, disp, plain_frame(left, right, cfg))
        q = disp_quality(disp)
        print(f"  {name} quality on stereo_pair(640, 480, 64, seed=0): {json.dumps(q)}")
        if not (q["invalid_frac"] <= MAX_INVALID and q["median_err_px"] <= MAX_MEDIAN_ERR):
            smoke.failures.append(f"phase 3 {name}: quality {q}")

    def check_agreement(name, disp, ref, against="kernel path vs plain path"):
        both_nan = torch.isnan(disp) & torch.isnan(ref)
        close = (disp - ref).abs() <= 1e-3
        agree = (both_nan | close).float().mean().item()
        print(f"  {name} {against} on the card: {100 * agree:.3f} % of pixels "
              f"agree (both NaN or |d| <= 1e-3 px; need >= 99.5 %)")
        if agree < 0.995:
            smoke.failures.append(f"phase 3 {name}: agreement {agree:.4f} < 0.995")

    def disp_quality(disp, truth=None):
        """bench.py disp_stats against ``truth`` (the pair's ground truth by
        default): skip the max_disp band and the borders."""
        d, g = disp.cpu().numpy(), (gt if truth is None else truth).cpu().numpy()
        inner = np.zeros(d.shape, bool)
        inner[8:-8, D + 8:-8] = True
        m = np.isfinite(d) & inner
        err = np.abs(d[m] - g[m])
        return {"invalid_frac": float(1.0 - m.sum() / inner.sum()),
                "median_err_px": float(np.median(err)), "mean_err_px": float(err.mean()),
                "bad1px_frac": float((err > 1.0).mean())}

    # the multi-device frames on a virtual mesh of the card, and the batch
    vmesh = mesh_mod.make_mesh(devices=[dev] * MESH_SHARDS)
    mesh_kernels = {"4-path": ("sgm", "sgm_segment", "wta", "median", "lr_check"),
                    "8-path": ("sgm", "sgm_segment", "sgm_diag_segment", "wta", "median",
                               "lr_check")}
    slice_launches = {}
    # every op of the mesh path as its plain version (``plain_mesh_frame``)
    plain_ops = types.SimpleNamespace(
        semi_global_matching=sgm_plain.semi_global_matching,
        sgm_aggregate_scan=sgm_plain.sgm_aggregate_scan,
        sgm_aggregate_block=sgm_plain.sgm_aggregate_block,
        sgm_aggregate_diag_block=sgm_plain.sgm_aggregate_diag_block,
        cost_vol_minimum_subpix=costvolume.cost_vol_minimum_subpix,
        median_filter_reject_invalid=median_plain.median_filter_reject_invalid,
        left_right_check=costvolume.left_right_check,
        left_right_check_pair=costvolume.left_right_check_pair)

    def plain_mesh_frame(left, right, cfg):
        """The mesh frame with every op the sharded code calls swapped for
        its plain version for the call."""
        kernel_ops = sharding.fast
        sharding.fast = plain_ops
        try:
            return stereo_sgm.sgm_pipeline(left, right, cfg, mesh=vmesh)
        finally:
            sharding.fast = kernel_ops

    def aggregation_inputs(cfg):
        bits = census.norm_bits(cfg.census_window)
        vol = census.census_cost_volume(census.census(left, cfg.census_window),
                                        census.census(right, cfg.census_window), D, -1, bits,
                                        dtype=torch.bfloat16)
        return vol, stereo_sgm._intensity(left)

    def mesh_aggregation(cfg, mesh, vol, img):
        """The aggregation ``sgm_pipeline(mesh=)`` runs for ``cfg``."""
        if cfg.do_diagonal:
            return sharding.sharded_semi_global_matching(vol, img, cfg.p1, cfg.p2, mesh,
                                                         do_diagonal=True)
        return sharding.sharded_semi_global_matching_reshard(vol, img, cfg.p1, cfg.p2, mesh)

    def mesh_phase(name):
        cfg = cfgs[name]
        reset_counts()
        prev = read_counts()
        for f in range(FRAMES):
            disp = stereo_sgm.sgm_pipeline(left, right, cfg, mesh=vmesh)
            torch.cuda.synchronize()
            now = read_counts()
            print(f"  {name} mesh frame {f}: launches so far "
                  f"{ {k: now[k] for k in mesh_kernels[name]} }")
            for k in mesh_kernels[name]:
                if now[k] <= prev[k]:
                    smoke.failures.append(f"phase 3 {name} mesh: {k} was not launched in "
                                          f"frame {f}")
            check_per_frame(f"{name} mesh", f, prev, now,
                            {k: n * MESH_SHARDS for k, n in frame_want.items()})
            prev = now
        slice_launches[name] = prev
        if (tuple(disp.shape) != (H, W) or disp.dtype != torch.float32
                or disp.device != vmesh.devices[0]):
            smoke.failures.append(f"phase 3 {name} mesh: output {tuple(disp.shape)} "
                                  f"{disp.dtype} on {disp.device}")
        check_agreement(f"{name} mesh", disp, stereo_sgm.sgm_pipeline(left, right, cfg),
                        "vs the single-device kernel frame")
        check_agreement(f"{name} mesh", disp, plain_mesh_frame(left, right, cfg),
                        "vs the mesh frame of plain versions")
        q = disp_quality(disp)
        print(f"  {name} mesh quality on stereo_pair(640, 480, 64, seed=0): {json.dumps(q)}")
        if not (q["invalid_frac"] <= MAX_INVALID and q["median_err_px"] <= MAX_MEDIAN_ERR):
            smoke.failures.append(f"phase 3 {name} mesh: quality {q}")
        vol, img = aggregation_inputs(cfg)
        torch.cuda.synchronize()
        sites = host_syncs(lambda: mesh_aggregation(cfg, vmesh, vol, img))
        print(f"  {'ok  ' if not sites else 'FAIL'} {name} mesh aggregation host "
              f"synchronisations: {sum(sites.values())} {json.dumps(dict(sites))}")
        if sites:
            smoke.failures.append(f"phase 3 {name} mesh: host synchronisations {dict(sites)}")

    def batched_phase():
        pairs = [synthetic.stereo_pair(W, H, D, seed=k, device=dev) for k in range(BATCH)]
        lefts = torch.stack([p[0] for p in pairs])
        rights = torch.stack([p[1] for p in pairs])
        cfg = cfgs["4-path"]
        reset_counts()
        disp = stereo_sgm.sgm_pipeline_batched(lefts, rights, cfg)
        torch.cuda.synchronize()
        now = read_counts()
        slice_launches["batch"] = now
        print(f"  batch of {BATCH}: launches "
              f"{ {k: now[k] for k in mesh_kernels['4-path']} }")
        for k in mesh_kernels["4-path"]:
            if now[k] == 0:
                smoke.failures.append(f"phase 3 batch: {k} was not launched")
        # one median launch a stack of frames, one LR launch a batch
        check_per_frame("batch", 0, {k: 0 for k in now}, now, frame_want)
        if tuple(disp.shape) != (BATCH, H, W) or disp.dtype != torch.float32:
            smoke.failures.append(f"phase 3 batch: output {tuple(disp.shape)} {disp.dtype}")
        for k in range(BATCH):
            frame = stereo_sgm.sgm_pipeline(lefts[k], rights[k], cfg)
            same = bool(((torch.isnan(disp[k]) & torch.isnan(frame)) | (disp[k] == frame)).all())
            print(f"  {'ok  ' if same else 'FAIL'} batch frame {k} (seed {k}) equal to its "
                  "single-device frame")
            if not same:
                smoke.failures.append(f"phase 3 batch: frame {k} differs from its own frame")
        q = disp_quality(disp[0])
        print(f"  batch frame 0 quality on stereo_pair(640, 480, 64, seed=0): {json.dumps(q)}")
        if not (q["invalid_frac"] <= MAX_INVALID and q["median_err_px"] <= MAX_MEDIAN_ERR):
            smoke.failures.append(f"phase 3 batch: quality {q}")

    dcfg = stereo.StereoConfig(max_disp=D, census_window="16x16", dtam_iterations=DTAM_ITERS)
    dtam_kernels = ("dtam", "wta_sq", "wta", "median", "lr_check")

    def plain_dtam(left, right, cfg, state=None, iterations=None):
        """The DTAM frame composed of the plain versions, called by name:
        the cold solve, or ``iterations`` steps resumed from ``state``."""
        left_p = stereo.preprocess_intensity(left, cfg)
        right_p = stereo.preprocess_intensity(right, cfg)
        vol = stereo.cost_volume(left_p, right_p, cfg, -1)
        g = costvolume.exponential_edge_weight(left_p, cfg.g_alpha, cfg.g_beta)
        if state is None:
            d0 = costvolume.cost_vol_minimum_subpix(vol, -1)
            state = (d0, d0, torch.zeros(d0.shape + (2,), device=d0.device), cfg.theta_start,
                     1.0)
            iterations = cfg.dtam_iterations
        d = stereo.dtam_iterate_plain(vol, g, *state, cfg.lam, cfg.sigma_q, cfg.sigma_d,
                                      cfg.huber_alpha, cfg.beta, iterations)[0]
        disp_r = costvolume.cost_vol_minimum_subpix(stereo.cost_volume(left_p, right_p, cfg, 1),
                                                    1)
        d = median_plain.median_filter_reject_invalid(d, cfg.median_max_bad, 2)
        return costvolume.left_right_check(d, disp_r, -1, cfg.max_disp_diff, cfg.max_disp)

    def check_dtam_quality(name, disp, ref):
        q = disp_quality(disp)
        lim = {k: ref[k] + DTAM_SLACK for k in ("invalid_frac", "median_err_px")}
        ok = all(q[k] <= lim[k] for k in lim)
        print(f"  {'ok  ' if ok else 'FAIL'} {name} quality on stereo_pair(640, 480, 64, seed=0): "
              f"{json.dumps(q)}; the JAX package on CPU-JAX: {json.dumps(ref)}; limits "
              f"{json.dumps(lim)}")
        if not ok:
            smoke.failures.append(f"phase 3 {name}: quality {q}")

    def dtam_launched(name, frame, prev, now, want=None):
        """Every kernel of the DTAM path was launched in this frame; the
        auxiliary search once per iteration."""
        print(f"  {name} frame {frame}: launches so far { {k: now[k] for k in dtam_kernels} }")
        for k in dtam_kernels:
            if now[k] <= prev[k]:
                smoke.failures.append(f"phase 3 {name}: {k} was not launched in frame {frame}")
        if want is not None:
            check_per_frame(name, frame, prev, now, {"wta_sq": want, "median": 1, "lr_check": 1})

    def dtam_phase():
        reset_counts()
        prev = read_counts()
        for f in range(DTAM_FRAMES):
            disp = stereo.stereo_pipeline(left, right, dcfg)
            torch.cuda.synchronize()
            now = read_counts()
            dtam_launched("DTAM cold", f, prev, now, DTAM_ITERS)
            prev = now
        for k in ("dtam", "wta_sq"):
            launches[k] = prev[k]
        if tuple(disp.shape) != (H, W) or disp.dtype != torch.float32:
            smoke.failures.append(f"phase 3 DTAM: output {tuple(disp.shape)} {disp.dtype}")
        check_agreement("DTAM cold", disp, plain_dtam(left, right, dcfg))
        check_dtam_quality(f"DTAM cold {DTAM_ITERS}", disp, DTAM_JAX["cold50"])

    def dtam_incremental_phase():
        vs = stereo.VariationalStereo(dcfg, its_per_frame=5)
        reset_counts()
        prev = read_counts()
        for f in range(DTAM_INCR_FRAMES):
            disp = vs.process_frame(left, right)
            torch.cuda.synchronize()
            now = read_counts()
            dtam_launched("DTAM incremental", f, prev, now, vs.its_per_frame)
            prev = now
        print(f"  theta {vs.theta!r}, n {float(vs.state[4])!r} after {DTAM_INCR_FRAMES} frames")
        check_dtam_quality(f"DTAM incremental after {DTAM_INCR_FRAMES} frames", disp,
                           DTAM_JAX["incremental_10"])

    def denoise_phase():
        clean, noisy, keep = noisy_image(H, W, seed=2)
        reset_counts()
        outs = {"rof": rof.denoise(noisy, 8.0, iterations=SOLVER_ITERS),
                "tgv": tgv.denoise(noisy, iterations=SOLVER_ITERS),
                "inpaint": deconvolution.inpaint(noisy * keep, keep, iterations=SOLVER_ITERS)}
        torch.cuda.synchronize()
        now = read_counts()
        print(f"  solves launched: rof {now['rof']} (denoise + inpaint), tgv {now['tgv']}")
        for k, want in (("rof", 2), ("tgv", 1)):
            if now[k] != want:
                smoke.failures.append(f"phase 3 denoise: {k} launched {now[k]} times, not {want}")
            launches[k] = now[k]
        err_in = (noisy - clean).abs().mean().item()
        for name, out in outs.items():
            err_in_k = ((noisy * keep - clean).abs().mean().item() if name == "inpaint"
                        else err_in)
            err = (out - clean).abs().mean().item()
            ok = tuple(out.shape) == (H, W) and bool(torch.isfinite(out).all()) and err < err_in_k
            print(f"  {'ok  ' if ok else 'FAIL'} {name}: mean error against the clean image "
                  f"{err_in_k:.6f} -> {err:.6f} ({err!r})")
            if not ok:
                smoke.failures.append(f"phase 3 denoise: {name} error {err_in_k} -> {err}")

    for name in cfgs:
        print(f"phase 3 sgm_pipeline ({name}) at {W}x{H}/{D}, {FRAMES} frames:")
        smoke.phase(f"phase 3 {name}", frame_phase, name)
    for name in cfgs:
        print(f"phase 3 sgm_pipeline ({name}, mesh of {MESH_SHARDS} virtual shards of the card) "
              f"at {W}x{H}/{D}, {FRAMES} frames:")
        smoke.phase(f"phase 3 {name} mesh", mesh_phase, name)
    print(f"phase 3 sgm_pipeline_batched ({BATCH} pairs, seeds 0-{BATCH - 1}) at {W}x{H}/{D}:")
    smoke.phase("phase 3 batch", batched_phase)
    if all(k in slice_launches for k in ("4-path", "8-path", "batch")):
        # the segment kernels' launches on this slice's three paths
        launches["sgm_segment"] = sum(slice_launches[k]["sgm_segment"]
                                      for k in ("4-path", "8-path", "batch"))
        launches["sgm_diag_segment"] = slice_launches["8-path"]["sgm_diag_segment"]
    print(f"phase 3 DTAM stereo_pipeline (cold, {DTAM_ITERS} iterations) at {W}x{H}/{D}, "
          f"{DTAM_FRAMES} frames:")
    smoke.phase("phase 3 DTAM cold", dtam_phase)
    print(f"phase 3 DTAM VariationalStereo (5 iterations per frame) at {W}x{H}/{D}, "
          f"{DTAM_INCR_FRAMES} frames:")
    smoke.phase("phase 3 DTAM incremental", dtam_incremental_phase)
    print(f"phase 3 rof / tgv / inpaint at {W}x{H}, {SOLVER_ITERS} iterations:")
    smoke.phase("phase 3 denoise", denoise_phase)

    # KinectFusion at bench.py's config on the synthetic orbit
    kf_K = Intrinsics.centered(550.0, W, H)
    kf_cfg = kf.KinectFusionConfig(w=W, h=H, vol_res=256, vol_extent=1.2, max_levels=4,
                                   its=(1, 0, 2, 3), near=0.5, far=6.0)
    kf_data = {}

    def kf_seeded():
        """A KinectFusion pipeline seeded with frame 0 at the true pose."""
        pipe = kf.KinectFusion(kf_K, kf_cfg, device=dev)
        pipe.T_wl = kf_data["poses"][0].clone()
        pipe.process_frame(kf_data["depths"][0])
        return pipe

    def plain_kf_frame(vol, T_wl, depth, first):
        """The frame composed of the plain versions, called by name; fuses
        into ``vol`` in place and returns (T_wl', rmse)."""
        _, kin_v, kin_n = kf.preprocess_depth(depth, kf_K, kf_cfg)
        trunc = kf_cfg.trunc_dist_factor * float(np.linalg.norm(
            vol.voxel_size_units().cpu().numpy()))
        _, ray_v, ray_n = kf.raycast_model(vol, T_wl, kf_K, kf_cfg, levels=kf_cfg.its,
                                           trunc=trunc, cloud=True)
        T_lp, rmse = kf.icp_refine(kin_v, ray_v, ray_n, kf_K, kf_cfg)
        first = torch.tensor(first, device=dev)
        good = torch.isfinite(rmse) & (rmse < kf_cfg.max_rmse)
        T_new = torch.where(good & ~first, se3.compose(T_wl, se3.inverse(T_lp)), T_wl)
        T_cw = se3.inverse(T_new)
        axis = separable._view_axis_index(T_cw)
        gmd, gct, params, window = separable.fuse_inputs(
            vol, kin_v[0][..., 2], kin_n[0], T_cw, kf_K, trunc, kf_cfg.max_w,
            kf_cfg.min_cos_theta, axis, enable=good | first, near=kf_cfg.near, far=kf_cfg.far)
        separable.fuse_planes_plain(vol.val, vol.weight, gmd, gct, params, window, axis, W, H)
        return T_new, rmse

    def kf_ate(poses):
        """bench.py's ATE: the RMS of the translation errors (float32)."""
        est = torch.stack(list(poses))[:, :, 3].cpu().numpy()
        ref = torch.stack(kf_data["poses"][1:])[:, :, 3].cpu().numpy()
        return float(np.sqrt(np.mean(np.sum((est - ref) ** 2, axis=1))))

    def check_kf_quality(name, ate, rmse, ref):
        lim = {"ate_rmse_m": ref["ate_rmse_m"] + KF_ATE_SLACK,
               "final_rmse": ref["final_rmse"] + KF_RMSE_SLACK}
        q = {"ate_rmse_m": ate, "final_rmse": rmse}
        ok = all(np.isfinite(q[k]) and q[k] <= lim[k] for k in lim)
        print(f"  {'ok  ' if ok else 'FAIL'} KinectFusion {name}: {json.dumps(q)}; the JAX package "
              f"on CPU-JAX: {json.dumps(ref)}; limits {json.dumps(lim)}")
        if not ok:
            smoke.failures.append(f"phase 3 KinectFusion {name}: quality {q}")

    def kf_phase():
        frames = list(synthetic.depth_sequence(
            KF_FRAMES + 1, kf_K, W, H, scene=synthetic.sphere_scene(res=128, device=dev),
            step=0.01))
        kf_data["poses"] = [T for T, _ in frames]
        kf_data["depths"] = [torch.where(torch.isfinite(d), d, 0.0) for _, d in frames]
        pipe = kf_seeded()
        torch.cuda.synchronize()
        reset_counts()
        prev = read_counts()
        loop_poses = []
        for f, depth in enumerate(kf_data["depths"][1:], 1):
            loop_poses.append(pipe.process_frame(depth).clone())
            torch.cuda.synchronize()
            now = read_counts()
            n = now["separable_fuse"] - prev["separable_fuse"]
            print(f"  frame {f}: separable_fuse launched {n}, rmse {pipe.rmse:.6g}, tracking "
                  f"{pipe.tracking_good}")
            if n != 1 or not pipe.tracking_good:
                smoke.failures.append(f"phase 3 KinectFusion frame {f}: fuse launched {n} "
                                      f"times, tracking_good {pipe.tracking_good}")
            prev = now
        launches["separable_fuse"] = prev["separable_fuse"]
        kf_data["pipe"] = pipe  # for the output side's checks
        loop_rmse = pipe.rmse
        if not (bool(torch.isfinite(torch.stack(loop_poses)).all())
                and float(pipe.vol.weight.max()) > 0):
            smoke.failures.append("phase 3 KinectFusion: non-finite poses or an empty volume")
        seq = kf_seeded()
        seq_poses, seq_rmses = seq.run_sequence(torch.stack(kf_data["depths"][1:]))
        err = (seq_poses - torch.stack(loop_poses)).abs().max().item()
        print(f"  {'ok  ' if err <= 1e-4 else 'FAIL'} run_sequence vs the frame loop: max pose "
              f"difference {err:.3g} (limit 1e-4), sweep axis {seq._seq_axis}")
        if not err <= 1e-4:
            smoke.failures.append(f"phase 3 KinectFusion: sequence vs loop {err}")
        # the frame composed of the plain versions, from the same seed
        vol = kf.KinectFusion(kf_K, kf_cfg, device=dev).vol
        T = kf_data["poses"][0].clone()
        T, _ = plain_kf_frame(vol, T, kf_data["depths"][0], True)
        errs = []
        for depth, T_kernel in zip(kf_data["depths"][1:], loop_poses):
            T, _ = plain_kf_frame(vol, T, depth, False)
            errs.append((T - T_kernel).abs().max().item())
        print(f"  {'ok  ' if max(errs) <= 1e-4 else 'FAIL'} kernel path vs plain path on the "
              f"card: max pose difference per frame {[f'{e:.2g}' for e in errs]} (limit 1e-4)")
        if not max(errs) <= 1e-4:
            smoke.failures.append(f"phase 3 KinectFusion: kernel vs plain path {max(errs)}")
        check_kf_quality("frame loop", kf_ate(loop_poses), loop_rmse, KF_JAX["loop"])
        check_kf_quality("sequence", kf_ate(seq_poses), float(seq_rmses[-1]),
                         KF_JAX["sequence"])

    print(f"phase 3 KinectFusion (256^3 TSDF, {W}x{H}, its (1, 0, 2, 3)): frame 0 seeded, "
          f"{KF_FRAMES} frames:")
    smoke.phase("phase 3 KinectFusion", kf_phase)

    # the KinectFusion leftovers on the same orbit and config: the guided and
    # exact engines, colour fusion on the separable engine (a seeded rgb
    # texture) and the moving workspace, each path driven with the counts set
    # to 0 just before and read just after every frame
    kf_paths = {}  # path -> (seeded pipeline after the loop, loop poses)

    def kf_path_cfg(name):
        return dataclasses.replace(kf_cfg, **KF_PATHS[name])

    def kf_path_seeded(name):
        """A pipeline of path ``name`` seeded with frame 0 at the true pose."""
        cfg = kf_path_cfg(name)
        pipe = kf.KinectFusion(kf_K, cfg, device=dev)
        pipe.T_wl = kf_data["poses"][0].clone()
        pipe.process_frame(kf_data["depths"][0], rgb=kf_data["rgb"] if cfg.use_colour else None)
        return pipe

    def kf_path_phase(name):
        if "rgb" not in kf_data:
            kf_data["rgb"] = synthetic.colour_texture(W, H, seed=0, device=dev)
        cfg = kf_path_cfg(name)
        rgb = kf_data["rgb"] if cfg.use_colour else None
        pipe = kf_path_seeded(name)
        want_fuses = 1 if cfg.engine == "separable" and not cfg.use_colour else 0
        torch.cuda.synchronize()
        reset_counts()
        prev = read_counts()
        poses, rolls = [], 0
        for f, depth in enumerate(kf_data["depths"][1:], 1):
            lo = pipe.vol.bbox.lo.clone()
            poses.append(pipe.process_frame(depth, rgb=rgb).clone())
            torch.cuda.synchronize()
            now = read_counts()
            launched = {k: now[k] - prev[k] for k in now if now[k] != prev[k]}
            rolled = not torch.equal(lo, pipe.vol.bbox.lo)
            rolls += rolled
            print(f"  frame {f}: kernel launches {launched or 'none'}, rolled {rolled}, rmse "
                  f"{pipe.rmse:.6g}, tracking {pipe.tracking_good}")
            if (launched.get("separable_fuse", 0) != want_fuses
                    or set(launched) - {"separable_fuse"} or not pipe.tracking_good):
                smoke.failures.append(f"phase 3 KinectFusion {name} frame {f}: launches "
                                      f"{launched}, tracking_good {pipe.tracking_good}")
            prev = now
        kf_paths[name] = (pipe, poses)
        if not (bool(torch.isfinite(torch.stack(poses)).all())
                and float(pipe.vol.weight.max()) > 0):
            smoke.failures.append(f"phase 3 KinectFusion {name}: non-finite poses or an empty "
                                  "volume")
        ref = KF_JAX_PATHS[name]
        check_kf_quality(name, kf_ate(poses), pipe.rmse, ref)
        if cfg.moving_threshold_voxels > 0:
            print(f"  {'ok  ' if rolls >= 1 else 'FAIL'} {rolls} of {KF_FRAMES} frames rolled the "
                  f"volume (the JAX package on CPU-JAX: {ref['rolls']}); box lo "
                  f"{pipe.vol.bbox.lo.tolist()}")
            if rolls < 1:
                smoke.failures.append(f"phase 3 KinectFusion {name}: no roll")
            kf_moving_vs_plain(poses)
        if cfg.use_colour:
            kf_colour_checks(pipe, poses, rgb)

    def kf_moving_vs_plain(loop_poses):
        """The frame of plain versions after the same rolls (recenter_shift
        on the plain path's own pose and volume) from the same seed."""
        cfg = kf_path_cfg("moving")
        vol = kf.KinectFusion(kf_K, kf_cfg, device=dev).vol
        T = kf_data["poses"][0].clone()
        T, _ = plain_kf_frame(vol, T, kf_data["depths"][0], True)
        errs, rolls = [], 0
        for depth, T_kernel in zip(kf_data["depths"][1:], loop_poses):
            shift = rolling.recenter_shift(vol, T, lead=cfg.moving_lead_m,
                                           threshold_voxels=cfg.moving_threshold_voxels)
            if shift != (0, 0, 0):
                vol = rolling.roll_volume(vol, shift)
                rolls += 1
            T, _ = plain_kf_frame(vol, T, depth, False)
            errs.append((T - T_kernel).abs().max().item())
        ok = max(errs) <= 1e-4
        print(f"  {'ok  ' if ok else 'FAIL'} kernel path vs plain path after the same rolls "
              f"({rolls}): max pose difference per frame {[f'{e:.2g}' for e in errs]} (limit "
              f"1e-4)")
        if not ok:
            smoke.failures.append(f"phase 3 KinectFusion moving: kernel vs plain path {max(errs)}")

    def kf_colour_checks(pipe, loop_poses, rgb):
        """The colour volume against the JAX package's figures, the sequence
        replay against the frame loop, and the colour render."""
        ref = KF_JAX_PATHS["colour"]
        touched = pipe.vol.weight > 0
        got = {"touched_share": touched.float().mean().item(),
               "median_grey": pipe.color_vol.data[touched].median().item()}
        ok = all(abs(got[k] - ref[k]) <= KF_COLOUR_ATOL for k in got)
        print(f"  {'ok  ' if ok else 'FAIL'} colour volume {json.dumps(got)}; the JAX package on "
              f"CPU-JAX {json.dumps({k: ref[k] for k in got})} (limit {KF_COLOUR_ATOL:g} each)")
        if not ok:
            smoke.failures.append(f"phase 3 KinectFusion colour: volume {got}")
        seq = kf_path_seeded("colour")
        n = len(loop_poses)
        reset_counts()
        seq_poses, seq_rmses = seq.run_sequence(torch.stack(kf_data["depths"][1:]),
                                                rgbs=torch.stack([rgb] * n))
        torch.cuda.synchronize()
        launched = {k: v for k, v in read_counts().items() if v}
        err = (seq_poses - torch.stack(loop_poses)).abs().max().item()
        cerr = (seq.color_vol.data - pipe.color_vol.data).abs().max().item()
        ok = err <= 1e-4 and cerr <= KF_COLOUR_ATOL and not launched
        print(f"  {'ok  ' if ok else 'FAIL'} run_sequence(rgbs=) vs the frame loop: max pose "
              f"difference {err:.3g} (limit 1e-4), colour {cerr:.3g} (limit "
              f"{KF_COLOUR_ATOL:g}), kernel launches {launched or 'none'}")
        if not ok:
            smoke.failures.append(f"phase 3 KinectFusion colour: sequence vs loop {err} {cerr}")
        check_kf_quality("colour sequence", kf_ate(seq_poses), float(seq_rmses[-1]),
                         KF_JAX_PATHS["colour sequence"])
        d, _, img = pipe.render(show_colour=True)
        hit = torch.isfinite(d)
        vals = img[hit]
        ok = (int(hit.sum()) > 0.05 * hit.numel() and bool(torch.isfinite(vals).all())
              and 0.0 <= float(vals.min()) and float(vals.max()) <= 1.0)
        print(f"  {'ok  ' if ok else 'FAIL'} render(show_colour=True): {int(hit.sum())} pixels "
              f"hit, grey {float(vals.min()):.4f}..{float(vals.max()):.4f}, median "
              f"{float(vals.median()):.4f}")
        if not ok:
            smoke.failures.append("phase 3 KinectFusion colour: render(show_colour=True)")

    for name in KF_PATHS:
        print(f"phase 3 KinectFusion {name} ({json.dumps(KF_PATHS[name])}; 256^3 TSDF, {W}x{H}, "
              f"its (1, 0, 2, 3)): frame 0 seeded, {KF_FRAMES} frames:")
        smoke.phase(f"phase 3 KinectFusion {name}", kf_path_phase, name)

    # BASELINE config 1 and the filters beside it, on the card against the
    # same calls on the CPU (no kernel: plain PyTorch on the tensor's device)
    filt_img = np.random.default_rng(0).random((H, W)).astype(np.float32)
    filt_ii = F.pad(integral_image.integral_image(torch.from_numpy(filt_img)), (1, 0, 1, 0))
    filter_cases = {
        "gaussian_blur": (lambda x: blur.gaussian_blur(x, 2.0, rad=10), filt_img),
        "gaussian_blur_uint8": (lambda x: blur.gaussian_blur(x, 2.0, rad=10),
                                (255.0 * filt_img).astype(np.uint8)),
        "bilateral": (lambda x: bilateral.bilateral(x, 2.0, 0.1, 5), filt_img),
        "blur": (blur.blur, filt_img),
        "blur_reduce": (lambda x: pyramid.blur_reduce(x, 4), filt_img),
        "integral_image": (integral_image.integral_image, filt_img),
        # from the same integral image (made on the CPU): its corner
        # differences would amplify the scans' last bits
        "box_filter_integral_image": (
            lambda ii: integral_image.box_filter_integral_image(ii, 9), filt_ii.numpy()),
    }

    def filters_phase():
        for name, (fn, x) in filter_cases.items():
            got, want = fn(torch.from_numpy(x).to(dev)), fn(torch.from_numpy(x))
            levels = lambda t: (t,) if torch.is_tensor(t) else t  # noqa: E731
            for level, (g, w) in enumerate(zip(levels(got), levels(want))):
                g = g.cpu()
                if w.dtype == torch.uint8:
                    err = (g.int() - w.int()).abs().max().item()
                    ok = g.dtype == w.dtype and err <= 1
                    limit = "1 LSB"
                else:
                    err = ((g - w).abs() / (FILTER_ATOL + FILTER_RTOL * w.abs())).max().item()
                    ok = g.dtype == w.dtype and g.shape == w.shape and err <= 1.0
                    limit = f"|d| / ({FILTER_ATOL:g} + {FILTER_RTOL:g} |cpu|) <= 1"
                print(f"  {'ok  ' if ok else 'FAIL'} {name} level {level} {tuple(g.shape)} "
                      f"{g.dtype} card vs CPU: {err:.3g} ({limit})")
                if not ok:
                    smoke.failures.append(f"phase 3 filters: {name} level {level} {err}")

    bcfgs = {"bilateral": stereo_sgm.SgmConfig(bilateral_filter=True),
             "bilateral size 3": stereo_sgm.SgmConfig(bilateral_filter=True, bilateral_size=3)}

    def census_volume(cfg):
        """The frame's float32 cost volume, before the filter."""
        bits = census.norm_bits(cfg.census_window)
        return census.census_cost_volume(census.census(left, cfg.census_window),
                                         census.census(right, cfg.census_window), D, -1, bits,
                                         dtype=torch.float32)

    def filtered_volume(cfg, vol):
        """``vol`` after the frame's bilateral filter."""
        return bilateral.bilateral_volume(vol, stereo_sgm._intensity(left), cfg.bilateral_gs,
                                          cfg.bilateral_gr, cfg.bilateral_size,
                                          gc=cfg.bilateral_gc)

    def bilateral_phase():
        cfg = bcfgs["bilateral"]
        reset_counts()
        prev = read_counts()
        for f in range(BILATERAL_FRAMES):
            disp = stereo_sgm.sgm_pipeline(left, right, cfg)
            torch.cuda.synchronize()
            now = read_counts()
            print(f"  bilateral frame {f}: launches so far "
                  f"{ {k: now[k] for k in frame_kernels['4-path']} }")
            for k in frame_kernels["4-path"]:
                if now[k] <= prev[k]:
                    smoke.failures.append(f"phase 3 bilateral: {k} was not launched in frame {f}")
            check_per_frame("bilateral", f, prev, now, frame_want)
            prev = now
        if tuple(disp.shape) != (H, W) or disp.dtype != torch.float32:
            smoke.failures.append(f"phase 3 bilateral: output {tuple(disp.shape)} {disp.dtype}")
        check_agreement("bilateral", disp, plain_frame(left, right, cfg))
        q = disp_quality(disp)
        ok = q["invalid_frac"] <= BILATERAL_MAX_INVALID and \
            q["median_err_px"] <= BILATERAL_MAX_MEDIAN_ERR
        print(f"  {'ok  ' if ok else 'FAIL'} bilateral quality on stereo_pair(640, 480, 64, "
              f"seed=0): {json.dumps(q)}; limits invalid <= {BILATERAL_MAX_INVALID}, median "
              f"error <= {BILATERAL_MAX_MEDIAN_ERR} px")
        if not ok:
            smoke.failures.append(f"phase 3 bilateral: quality {q}")
        # the frame's kernels on the filtered float32 volume against plain
        vol, img = filtered_volume(cfg, census_volume(cfg)), stereo_sgm._intensity(left)
        agg = sgm_cuda.semi_global_matching(vol, img)
        smoke.compare("sgm", "bilateral-filtered f32 volume", agg,
                      sgm_plain.semi_global_matching(vol, img), ATOL["sgm"],
                      lattice(D, W, -1).expand_as(agg))
        smoke.compare("wta", "bilateral-filtered f32 aggregate",
                      wta_cuda.cost_vol_minimum_subpix(agg, -1),
                      costvolume.cost_vol_minimum_subpix(agg, -1), ATOL["wta"])
        cfg = bcfgs["bilateral size 3"]
        reset_counts()
        disp = stereo_sgm.sgm_pipeline(left, right, cfg)
        torch.cuda.synchronize()
        now = read_counts()
        print("  bilateral size 3 frame: launches "
              f"{ {k: now[k] for k in frame_kernels['4-path']} }")
        for k in frame_kernels["4-path"]:
            if now[k] == 0:
                smoke.failures.append(f"phase 3 bilateral size 3: {k} was not launched")
        check_per_frame("bilateral size 3", 0, {k: 0 for k in now}, now, frame_want)
        check_agreement("bilateral size 3", disp, plain_frame(left, right, cfg))
        ref = BILATERAL_JAX["size3"]
        q = disp_quality(disp)
        lim = {k: ref[k] + BILATERAL_SLACK for k in ("invalid_frac", "median_err_px")}
        ok = all(q[k] <= lim[k] for k in lim)
        print(f"  {'ok  ' if ok else 'FAIL'} bilateral size 3 quality: {json.dumps(q)}; the JAX "
              f"package on CPU-JAX: {json.dumps(ref)}; limits {json.dumps(lim)}")
        if not ok:
            smoke.failures.append(f"phase 3 bilateral size 3: quality {q}")

    print(f"phase 3 filters of BASELINE config 1 and beside it at {W}x{H}, card vs CPU:")
    smoke.phase("phase 3 filters", filters_phase)
    print(f"phase 3 sgm_pipeline (bilateral_filter=True, size 18) at {W}x{H}/{D}, "
          f"{BILATERAL_FRAMES} frames, and one at size 3:")
    smoke.phase("phase 3 bilateral", bilateral_phase)

    # the stereo apps' remaining entry points at VGA/64: MultiViewStereo on the
    # multi-view track, the coarse_init cold DTAM frame, Stereo2App, and the
    # census and scanline dense stereo against the same calls on the CPU
    mv_key, mv_gt, mv_track = synthetic.multiview_track(W, H, D, seed=0, device=dev)
    mv_K = Intrinsics.centered(MVS_FOCAL * W, W, H)
    mv_cfg = stereo.StereoConfig(max_disp=D, dtam_iterations=DTAM_ITERS)
    coarse_cfg = dataclasses.replace(dcfg, coarse_init=True)
    s2_K = Intrinsics.centered(STEREO2_FOCAL, W, H)
    s2_cfg = stereo_sgm.SgmConfig(max_disp=D)
    apps = {}

    def new_mvs():
        """The keyframe seeded from the pair it makes with the f = 1 view."""
        mvs = stereo.MultiViewStereo(mv_K, MVS_BASELINE, mv_cfg)
        mvs.reset(mv_key.float(), se3.identity(device=dev), right=mv_track[-1][0].float())
        return mvs

    def plain_dtam_solve(vol, img, cfg, d_init=None):
        """``stereo.dtam_solve`` of plain versions: WTA (or ``d_init``), then
        the alternation's transcription."""
        g = costvolume.exponential_edge_weight(stereo_sgm._intensity(img), cfg.g_alpha,
                                               cfg.g_beta)
        d0 = costvolume.cost_vol_minimum_subpix(vol, -1) if d_init is None else d_init
        q0 = torch.zeros(d0.shape + (2,), device=d0.device)
        return stereo.dtam_iterate_plain(vol, g, d0, d0, q0, cfg.theta_start, 1.0, cfg.lam,
                                         cfg.sigma_q, cfg.sigma_d, cfg.huber_alpha, cfg.beta,
                                         cfg.dtam_iterations)[0]

    def plain_coarse(left, right, cfg):
        """The coarse_init frame of plain versions, called by name."""
        left_p = stereo.preprocess_intensity(left, cfg)
        right_p = stereo.preprocess_intensity(right, cfg)
        lh, rh = resample.box_half(left_p), resample.box_half(right_p)
        ccfg = dataclasses.replace(cfg, max_disp=max(cfg.max_disp // 2, 8), coarse_init=False,
                                   dtam_iterations=cfg.coarse_iterations)
        d_c = plain_dtam_solve(stereo.cost_volume(lh, rh, ccfg, -1), lh, ccfg)
        d_init = 2.0 * resample.resample(d_c, W, H, "bilinear")
        d = plain_dtam_solve(stereo.cost_volume(left_p, right_p, cfg, -1), left_p, cfg, d_init)
        disp_r = costvolume.cost_vol_minimum_subpix(stereo.cost_volume(left_p, right_p, cfg, 1),
                                                    1)
        d = median_plain.median_filter_reject_invalid(d, cfg.median_max_bad, 2)
        return costvolume.left_right_check(d, disp_r, -1, cfg.max_disp_diff, cfg.max_disp)

    def check_app_quality(name, disp, truth, ref):
        q = disp_quality(disp, truth)
        lim = {k: ref[k] + APPS_SLACK for k in ("invalid_frac", "median_err_px")}
        ok = all(q[k] <= lim[k] for k in lim)
        print(f"  {'ok  ' if ok else 'FAIL'} {name} quality: {json.dumps(q)}; the JAX package "
              f"on CPU-JAX: {json.dumps({k: ref[k] for k in lim})}; limits {json.dumps(lim)}")
        if not ok:
            smoke.failures.append(f"phase 3 {name}: quality {q}")

    def check_launched(name, now, want_at_least, want_exact=None):
        print(f"  {name}: launches {json.dumps({k: now[k] for k in want_at_least})}")
        for k in want_at_least:
            if now[k] == 0:
                smoke.failures.append(f"phase 3 {name}: {k} was not launched")
        check_per_frame(name, 0, {k: 0 for k in now}, now, want_exact or {})

    def multiview_phase():
        reset_counts()
        mvs = new_mvs()
        for img, T_wc in mv_track:
            mvs.add(img.float(), T_wc)
        disp_dtam = mvs.solve(use_dtam=True)
        disp_wta = mvs.solve(use_dtam=False)
        torch.cuda.synchronize()
        now = read_counts()
        # the DTAM solve: its WTA start, one alternation launch, the search
        # once an iteration; the WTA solve one more WTA launch
        check_launched("multiview", now, ("wta", "dtam", "wta_sq"),
                       {"wta": 2, "dtam": 1, "wta_sq": DTAM_ITERS})
        apps["multiview"] = now
        n_max = mvs.n.max().item()
        print(f"  accumulated {len(mv_track)} views onto the seeded keyframe: max n {n_max!r}, "
              f"counted cells {(mvs.n > 0).float().mean().item():.4f}")
        if n_max != len(mv_track) + 1:
            smoke.failures.append(f"phase 3 multiview: max n {n_max}, not {len(mv_track) + 1}")
        vol = mvs.volume()
        for name, disp, plain in (
                ("multiview DTAM", disp_dtam, plain_dtam_solve(vol, mvs.img_v, mv_cfg)),
                ("multiview WTA", disp_wta, costvolume.cost_vol_minimum_subpix(vol, -1))):
            if tuple(disp.shape) != (H, W) or disp.dtype != torch.float32:
                smoke.failures.append(f"phase 3 {name}: output {tuple(disp.shape)} {disp.dtype}")
            check_agreement(name, disp, plain)
        # the solve's kernels on the running-mean volume (1e6 in empty cells)
        smoke.compare("wta", "multiview running-mean volume",
                      wta_cuda.cost_vol_minimum_subpix(vol, -1),
                      costvolume.cost_vol_minimum_subpix(vol, -1), ATOL["wta"])
        smoke.compare("wta_sq", "multiview running-mean volume, theta 1",
                      wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, disp_wta, 20.0, 1.0),
                      costvolume.cost_vol_minimum_square_penalty_subpix(vol, disp_wta, 20.0,
                                                                        1.0), ATOL["wta_sq"])
        check_app_quality("multiview DTAM 50", disp_dtam, mv_gt, MVS_JAX["dtam50"])
        check_app_quality("multiview WTA", disp_wta, mv_gt, MVS_JAX["wta"])

    def coarse_phase():
        reset_counts()
        disp = stereo.stereo_pipeline(left, right, coarse_cfg)
        torch.cuda.synchronize()
        now = read_counts()
        # two solves (coarse and fine), the coarse one's WTA start and the
        # right disparity's WTA; the fine solve starts from the coarse one
        check_launched("DTAM coarse_init", now, dtam_kernels,
                       {"dtam": 2, "wta_sq": coarse_cfg.coarse_iterations + DTAM_ITERS,
                        "wta": 2, "median": 1,
                        "lr_check": 1})
        apps["coarse"] = now
        if tuple(disp.shape) != (H, W) or disp.dtype != torch.float32:
            smoke.failures.append(f"phase 3 coarse: output {tuple(disp.shape)} {disp.dtype}")
        check_agreement("DTAM coarse_init", disp, plain_coarse(left, right, coarse_cfg))
        check_app_quality("DTAM coarse_init 50 + 50", disp, gt, COARSE_JAX)

    def new_stereo2():
        return stereo_sgm.Stereo2App(s2_K, STEREO2_BASELINE, s2_cfg, hm_size=STEREO2_HM,
                                     hm_cell=STEREO2_CELL)

    def plain_stereo2():
        """The same two frames with the SGM frame of plain versions (the tail
        is plain PyTorch on every device)."""
        app = new_stereo2()
        frame = stereo_sgm.sgm_pipeline
        stereo_sgm.sgm_pipeline = lambda l, r, cfg, mesh=None: plain_frame(l, r, cfg)
        try:
            return app, [app(left, right, image=left)[0] for _ in range(2)]
        finally:
            stereo_sgm.sgm_pipeline = frame

    def stereo2_phase():
        app = new_stereo2()
        plain_app, plain_disps = plain_stereo2()
        for f, name in enumerate(("reset", "steady")):
            reset_counts()
            disp, d3d = app(left, right, image=left)
            torch.cuda.synchronize()
            now = read_counts()
            check_launched(f"Stereo2App {name} frame", now, frame_kernels["4-path"], frame_want)
            kf_data["stereo2"] = app  # for the heightmap mesh check
            apps[f"stereo2 {name}"] = now
            if tuple(d3d.shape) != (H, W, 4) or not app.hm_initialised:
                smoke.failures.append(f"phase 3 Stereo2App {name}: points {tuple(d3d.shape)}")
            check_agreement(f"Stereo2App {name} frame", disp, plain_disps[f])
            check_app_quality(f"Stereo2App {name} frame", disp, gt, STEREO2_JAX[name])
            n_c = app.n_c.double().cpu().numpy()
            ref = np.asarray(STEREO2_JAX[name]["n_c"])
            depth, ref_depth = -1.0 / n_c[2], STEREO2_JAX[name]["plane_depth_m"]
            ok = (np.abs(n_c - ref).max() <= STEREO2_NC_ATOL
                  and abs(depth - ref_depth) <= APPS_SLACK)
            print(f"  {'ok  ' if ok else 'FAIL'} Stereo2App {name} plane: n_c {n_c.tolist()}, "
                  f"depth {depth!r} m; the JAX package on CPU-JAX: n_c {ref.tolist()}, depth "
                  f"{ref_depth!r} m; limits |n_c| {STEREO2_NC_ATOL:g}, depth {APPS_SLACK:g} m")
            if not ok:
                smoke.failures.append(f"phase 3 Stereo2App {name}: plane {n_c.tolist()}")
        diff = (app.n_c - plain_app.n_c).abs().max().item()
        cells = (app.hm.hm[..., 1] == plain_app.hm.hm[..., 1]).float().mean().item()
        hit = int((app.hm.hm[..., 1] > 0).sum().item())
        ok = diff <= 1e-4 and cells >= 0.995 and hit > 0
        print(f"  {'ok  ' if ok else 'FAIL'} Stereo2App vs its plain path after 2 frames: n_c "
              f"within {diff:.3g} (limit 1e-4), heightmap counts equal on {100 * cells:.3f} % of "
              f"cells (need >= 99.5 %), {hit} cells fused")
        if not ok:
            smoke.failures.append(f"phase 3 Stereo2App vs plain: n_c {diff}, cells {cells}")
        torch.cuda.synchronize()
        sites = host_syncs(lambda: plane_fit.fit_plane(d3d, app.Qinv, z0=app.z, iterations=5,
                                                       zmax=app.plane_within, c=app.plane_c))
        print(f"  {'ok  ' if not sites else 'FAIL'} fit_plane (5 steps) host synchronisations: "
              f"{sum(sites.values())} {json.dumps(dict(sites))}")
        if sites:
            smoke.failures.append(f"phase 3 Stereo2App: fit_plane host synchronisations {sites}")

    def scanline_phase():
        """census_stereo and dense_stereo at VGA/64, card against CPU."""
        cpu = [t.cpu() for t in (left, right)]
        words = [census.census(x) for x in (left, right)]
        got = census.census_stereo(*words, D).cpu()
        want = census.census_stereo(*(census.census(x) for x in cpu), D)
        same = torch.equal(got, want)
        hits = (got[8:-8, D + 8:-8].float() == gt.cpu()[8:-8, D + 8:-8]).float().mean().item()
        print(f"  {'ok  ' if same else 'FAIL'} census_stereo (16x16) card vs CPU: "
              f"{'equal' if same else 'DIFFERENT'}; {100 * hits:.2f} % of inner pixels at the "
              "ground truth")
        if not same:
            smoke.failures.append("phase 3 census_stereo: card differs from CPU")
        got = dense_stereo.dense_stereo(left, right, D).cpu()
        want = dense_stereo.dense_stereo(*cpu, D)
        equal = (got == want).float().mean().item()
        hits = (got[8:-8, D + 8:-8].float() == gt.cpu()[8:-8, D + 8:-8]).float().mean().item()
        ok = equal >= 0.999
        print(f"  {'ok  ' if ok else 'FAIL'} dense_stereo (sand, r 1) card vs CPU: "
              f"{100 * equal:.3f} % of pixels equal (need >= 99.9 %); {100 * hits:.2f} % of inner "
              "pixels at the ground truth")
        if not ok:
            smoke.failures.append(f"phase 3 dense_stereo: {equal} equal")

    print(f"phase 3 MultiViewStereo on multiview_track({W}, {H}, {D}): seeded keyframe, "
          f"{len(mv_track)} views, DTAM {DTAM_ITERS} iterations and WTA:")
    smoke.phase("phase 3 multiview", multiview_phase)
    print(f"phase 3 DTAM stereo_pipeline (coarse_init, {coarse_cfg.coarse_iterations} + "
          f"{DTAM_ITERS} iterations) at {W}x{H}/{D}:")
    smoke.phase("phase 3 coarse", coarse_phase)
    print(f"phase 3 Stereo2App at {W}x{H}/{D}: a reset frame and a steady frame:")
    smoke.phase("phase 3 Stereo2App", stereo2_phase)
    print(f"phase 3 census_stereo and dense_stereo at {W}x{H}/{D}, card vs CPU:")
    smoke.phase("phase 3 scanline", scanline_phase)

    # the output side and the remaining solvers: volume files, meshes,
    # keyframe texturing and the heightmap mesh on the runs above, then each
    # solver against a CPU copy of its inputs (no kernel on these paths)
    colour_run = kf_paths.get("colour", (None, None))
    out_ctx = types.SimpleNamespace(
        torch=torch, np=np, smoke=smoke, dev=dev, card=card, kf=kf, kf_K=kf_K, kf_cfg=kf_cfg,
        kf_data=kf_data, kf_pipe=kf_data.get("pipe"), kf_colour_pipe=colour_run[0],
        kf_colour_poses=colour_run[1], stereo2_app=kf_data.get("stereo2"), synthetic=synthetic,
        se3=se3, Intrinsics=Intrinsics, depth_mod=depth_mod, reset_counts=reset_counts,
        read_counts=read_counts, sync=torch.cuda.synchronize, host_syncs=host_syncs,
        numpy_res=MESH_NUMPY_RES, scene_res=128, keyframes=POSE_GRAPH_KEYFRAMES, W=W, H=H,
        mesh_triangles={}, mesh_quality={}, times={})
    output_checks(out_ctx)

    # the host side: the file-fed KinectFusion frame, the rig path, the demos,
    # the roo names, the debug, profiling and timing helpers
    scratch = tempfile.TemporaryDirectory()
    vars(out_ctx).update(
        tmp=scratch.name, kind=kind, left=left, right=right, sgm_cfg=cfgs["4-path"],
        sgm_disp=stereo_sgm.sgm_pipeline(left, right, cfgs["4-path"]),
        host_launches={k: 0 for k in KERNELS})
    host_side_checks(out_ctx)

    # --- phase 4: times -------------------------------------------------------
    times, bound = {}, {}

    def timing_phase():
        cfg = cfgs["4-path"]
        bits = census.norm_bits(cfg.census_window)
        vol = census.census_cost_volume(census.census(left), census.census(right), D, -1, bits,
                                        dtype=torch.bfloat16)
        img = stereo_sgm._intensity(left)
        agg = sgm_cuda.semi_global_matching(vol, img)
        dl = wta_cuda.cost_vol_minimum_subpix(agg, -1)
        dr = wta_cuda.cost_vol_minimum_subpix(costvolume.reanchor_right(agg), 1)
        # bench.py bench_variational's input and parameters; an inpainting
        # mask that keeps four pixels in five
        u01 = torch.from_numpy(np.random.default_rng(0).random((H, W)).astype(np.float32)).to(dev)
        keep01 = torch.from_numpy((np.random.default_rng(1).random((H, W)) > 0.2)
                                  .astype(np.float32)).to(dev)
        # the DTAM solve's inputs as the cold frame makes them
        left_p = stereo.preprocess_intensity(left, dcfg)
        g = costvolume.exponential_edge_weight(left_p, dcfg.g_alpha, dcfg.g_beta)
        d0 = wta_cuda.cost_vol_minimum_subpix(vol, -1)
        q0 = torch.zeros((H, W, 2), device=dev)
        solve = (dcfg.lam, dcfg.theta_start, dcfg.sigma_q, dcfg.sigma_d, dcfg.huber_alpha,
                 dcfg.beta)
        _, state = stereo.dtam_frame(left, right, None, dcfg)  # a running app's state
        cases = {
            "sgm": (lambda: sgm_cuda.semi_global_matching(vol, img),
                    lambda: sgm_plain.semi_global_matching(vol, img)),
            "sgm_8path": (lambda: sgm_cuda.semi_global_matching(vol, img, do_diagonal=True),
                          lambda: sgm_plain.semi_global_matching(vol, img, do_diagonal=True)),
            "wta": (lambda: wta_cuda.cost_vol_minimum_subpix(agg, -1),
                    lambda: costvolume.cost_vol_minimum_subpix(agg, -1)),
            "median": (lambda: median_cuda.median_filter_reject_invalid(dl, 12, 2),
                       lambda: median_plain.median_filter_reject_invalid(dl, 12, 2)),
            "lr_check": (lambda: lr_cuda.left_right_check(dl, dr, -1, 1.0, D),
                         lambda: costvolume.left_right_check(dl, dr, -1, 1.0, D)),
            "rof": (lambda: rof.denoise(u01, 8.0, iterations=SOLVER_ITERS),
                    lambda: rof.denoise_plain(u01, 8.0, iterations=SOLVER_ITERS)),
            "tgv": (lambda: tgv.denoise(u01, iterations=SOLVER_ITERS),
                    lambda: tgv.denoise_plain(u01, iterations=SOLVER_ITERS)),
            "frame": (lambda: stereo_sgm.sgm_pipeline(left, right, cfgs["4-path"]),
                      lambda: plain_frame(left, right, cfgs["4-path"])),
            "frame_8path": (lambda: stereo_sgm.sgm_pipeline(left, right, cfgs["8-path"]),
                            lambda: plain_frame(left, right, cfgs["8-path"])),
            "wta_sq": (lambda: wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, dl, 20.0, 1.0),
                       lambda: costvolume.cost_vol_minimum_square_penalty_subpix(vol, dl, 20.0,
                                                                                 1.0)),
            "dtam": (lambda: dtam_cuda.dtam_solve(vol, g, d0, *solve, iterations=DTAM_ITERS),
                     lambda: stereo.dtam_iterate_plain(vol, g, d0, d0, q0, solve[1], 1.0,
                                                       solve[0], *solve[2:], DTAM_ITERS)[0]),
            "dtam_frame": (lambda: stereo.stereo_pipeline(left, right, dcfg),
                           lambda: plain_dtam(left, right, dcfg)),
            "dtam_incremental": (lambda: stereo.dtam_frame(left, right, state, dcfg, 5),
                                 lambda: plain_dtam(left, right, dcfg, state, 5)),
        }
        # the plain versions loop in Python over the scan axis or the iterations
        slow = {"sgm", "sgm_8path", "frame", "frame_8path", "rof", "tgv", "dtam", "dtam_frame",
                "dtam_incremental"}
        for name, (kern, plain) in cases.items():
            # plain, kernel, kernel, plain: drift over the call shows as a spread
            p1 = timing.time_fn(plain, warmup=1, runs=3 if name in slow else 20)
            k1 = timing.time_fn(kern, warmup=3, runs=20)
            k2 = timing.time_fn(kern, warmup=0, runs=20)
            p2 = timing.time_fn(plain, warmup=0, runs=3 if name in slow else 20)
            times[name] = (min(k1["median_ms"], k2["median_ms"]),
                           min(p1["median_ms"], p2["median_ms"]))
            print(f"  {name:11s} kernel {k1['median_ms']:.4f} / {k2['median_ms']:.4f} ms, "
                  f"plain {p1['median_ms']:.4f} / {p2['median_ms']:.4f} ms "
                  f"(median of runs, at {W}x{H}/{D}) [{card}]")
        # kernels 2-4 (WTA, median, LR check), the median and the LR check also
        # through the designs they replaced, and the LR pair against two
        # launches of the replaced design in the reference's order: each
        # call's events time and host time (a host clock over 100 calls
        # without a synchronise), taken here, before the profiles of this
        # phase
        pair_old = lambda: lr_cuda._check_pixel(  # noqa: E731
            dl, lr_cuda._check_pixel(dr, dl, 1, 1.0, D), -1, 1.0, D)
        device_cases = {
            "wta": ((cases["wta"][0], "wta_kernel"), None),
            "median": ((cases["median"][0], "median_tile_kernel"),
                       (lambda: median_cuda._median_pixel(dl, 12, 2), "median_reject_kernel")),
            "lr_check": ((cases["lr_check"][0], "lr_rows_kernel"),
                         (lambda: lr_cuda._check_pixel(dl, dr, -1, 1.0, D), "lr_check_kernel")),
            "lr_pair": ((lambda: lr_cuda.left_right_check_pair(dl, dr, 1.0, D), "lr_rows_kernel"),
                        (pair_old, "lr_check_kernel")),
        }
        call_us = {}
        for name, (new, old) in device_cases.items():
            for design, case in (("new", new), ("old", old)):
                if case is not None:
                    call_us[name, design] = (
                        [1e3 * timing.time_fn(case[0], warmup=3, runs=20)["median_ms"]
                         for _ in range(2)], host_us(case[0]))
        for name in ("frame", "frame_8path", "dtam_frame", "dtam_incremental"):
            k, p = times[name]
            print(f"  {name}: {1e3 / k:.2f} fps on the kernel path, {1e3 / p:.2f} fps on the "
                  f"plain path [{card}]")
        # each timed kernel call's bound: (bytes, float32 operations), each
        # input read once and each output written once. Operations per
        # element, counted from the kernels' formulas (a min, compare,
        # square root or division counts one): SGM 9 per (d, pixel,
        # direction); WTA 2 per volume element; the median 2 per
        # compare-exchange of its sorting network plus 1 per tap; the LR
        # check 8 per pixel; ROF 27 and TGV 72 per pixel and iteration; the
        # auxiliary search 7 per volume element plus 18 per pixel; DTAM that
        # search plus 30 per pixel (dual 18, primal 12), per iteration.
        def nbytes(*ts):
            return sum(t.numel() * t.element_size() for t in ts)

        HW, DHW = H * W, vol.numel()
        taps = 25  # rad 2
        work = {
            "sgm": (nbytes(vol, img, agg), 4 * 9 * DHW),
            "sgm_8path": (nbytes(vol, img, agg), 8 * 9 * DHW),
            "wta": (nbytes(agg, dl), 2 * DHW),
            "median": (2 * nbytes(dl), (2 * len(median_cuda.batcher_pairs(taps)) + taps) * HW),
            "lr_check": (3 * nbytes(dl), 8 * HW),
            "rof": (2 * nbytes(u01), 27 * HW * SOLVER_ITERS),
            "tgv": (2 * nbytes(u01), 72 * HW * SOLVER_ITERS),
            "wta_sq": (nbytes(vol, dl, dl), 7 * DHW + 18 * HW),
            "dtam": (nbytes(vol, g, d0, d0), DTAM_ITERS * (7 * DHW + 48 * HW)),
        }
        for name, (b, ops) in work.items():
            t_bytes, t_ops = 1e3 * b / HBM_BPS, 1e3 * ops / F32_OPS
            bound[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
            print(f"  bound {name:9s} {b / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP -> "
                  f"{bound[name][0]:.5f} ms ({bound[name][1]}); kernel {times[name][0]:.4f} ms")

        # where the DTAM time goes: device time by kernel (torch.profiler) in
        # one solve (and one through the three-launch design it replaced) and
        # in one cold frame, whose busy share is that time over the frame's
        # wall time under the profiler
        solve_split = lambda: dtam_cuda._dtam_run_split(vol, g, d0, d0, q0, solve[1], 1.0,
                                                        solve[0], *solve[2:], DTAM_ITERS)
        for what, run in (("dtam_solve", cases["dtam"][0]), ("dtam_solve_split", solve_split),
                          ("dtam_frame", cases["dtam_frame"][0])):
            run()
            kernels, wall_us = device_us(run)
            busy = sum(us for _, us in kernels.values())
            n_launches = sum(n for n, _ in kernels.values())
            print(f"  profile {what}: {len(kernels)} kernels, {n_launches} launches, device "
                  f"{busy / 1e3:.4f} ms of {wall_us / 1e3:.4f} ms wall "
                  f"(busy share {busy / wall_us:.3f}) [{card}]")
            for part in ("dtam_dual_kernel", "dtam_primal_search_kernel", "wta_sq_span_kernel",
                         "dtam_primal_kernel", "wta_sq_kernel"):
                hits = [(n, us) for k, (n, us) in kernels.items() if part + "<" in k
                        or part + "(" in k]
                if hits:
                    n, us = sum(h[0] for h in hits), sum(h[1] for h in hits)
                    print(f"    {part}: {n} launches, {us / n:.2f} us each, {us / 1e3:.4f} ms")
        # the search and the alternation against the designs they replaced
        # (kt_wta_sq_pixel, kt_dtam_run_split), in turns (old, new, new,
        # old): the search on the volume as bf16 and as float32 (twice the
        # bytes in the same number of slices), the 50-iteration solve and
        # the 5 iterations of an incremental step (both through the same
        # wrapper code); device time by torch.profiler; the solve's
        # chained byte floor (each iteration reads the volume and 13 (H, W)
        # planes: dual 5 in, 2 out; primal and search 6 in, 2 out)
        vol32 = vol.float()
        state5 = (d0, d0, q0, dcfg.theta_start, 7.0)
        step_args = (dcfg.lam, dcfg.sigma_q, dcfg.sigma_d, dcfg.huber_alpha, dcfg.beta)
        designs = {
            "wta_sq bf16": (lambda: wta_cuda._square_penalty_pixel(vol, dl, 20.0, 1.0),
                            lambda: wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, dl, 20.0,
                                                                                    1.0)),
            "wta_sq f32": (lambda: wta_cuda._square_penalty_pixel(vol32, dl, 20.0, 1.0),
                           lambda: wta_cuda.cost_vol_minimum_square_penalty_subpix(vol32, dl,
                                                                                   20.0, 1.0)),
            "dtam solve": (solve_split, cases["dtam"][0]),
            "dtam 5 it": (lambda: dtam_cuda._dtam_run_split(vol, g, *state5, *step_args, 5),
                          lambda: dtam_cuda.dtam_run(vol, g, *state5, *step_args, 5)),
            # the 100-iteration Huber ROF solve and inpainting (kt_rof_denoise
            # against kt_rof_denoise_steps)
            "rof solve": (lambda: solvers_cuda._rof_denoise_steps(u01, 8.0,
                                                                  iterations=SOLVER_ITERS),
                          cases["rof"][0]),
            "inpaint": (lambda: solvers_cuda._rof_denoise_steps(u01, 10.0,
                                                                iterations=SOLVER_ITERS,
                                                                lam_weight=keep01),
                        lambda: deconvolution.inpaint(u01, keep01, iterations=SOLVER_ITERS)),
            # the 100-iteration TGV solve (kt_tgv_denoise against
            # kt_tgv_denoise_steps)
            "tgv solve": (lambda: solvers_cuda._tgv_denoise_steps(u01, iterations=SOLVER_ITERS),
                          cases["tgv"][0]),
        }
        # kernel launches a 100-iteration solve must take
        launches_per_solve = {"rof solve": -(-SOLVER_ITERS // solvers_cuda.ROF_STEPS),
                              "inpaint": -(-SOLVER_ITERS // solvers_cuda.ROF_STEPS),
                              "tgv solve": -(-SOLVER_ITERS // solvers_cuda.TGV_STEPS)}

        def kernel_launches(kernels):
            """Device time (us) and launches of the kernels, copies and fills
            aside."""
            ks = [v for k, v in kernels.items() if "Memcpy" not in k and "Memset" not in k]
            return sum(us for _, us in ks), sum(n for n, _ in ks)

        for name, (old, new) in designs.items():
            o1 = timing.time_fn(old, warmup=3, runs=20)["median_ms"]
            n1 = timing.time_fn(new, warmup=3, runs=20)["median_ms"]
            n2 = timing.time_fn(new, warmup=0, runs=20)["median_ms"]
            o2 = timing.time_fn(old, warmup=0, runs=20)["median_ms"]
            # launches a call: the most that three one-call profiles record (a
            # profile may miss a launch now and then); device time a call: the
            # time a recorded launch over 5 calls, times those launches
            ln, lo = (max(kernel_launches(device_us(run)[0])[1] for _ in range(3))
                      for run in (new, old))
            (tn, rn), (to, ro) = (kernel_launches(device_us(run, 5)[0]) for run in (new, old))
            dn, do = (t / r * n if r else 0.0 for t, r, n in ((tn, rn, ln), (to, ro, lo)))
            print(f"  design {name:12s} new {n1:.4f} / {n2:.4f} ms (device {dn / 1e3:.4f}, "
                  f"{ln:g} launches), old {o1:.4f} / {o2:.4f} ms (device {do / 1e3:.4f}, {lo:g} "
                  f"launches); {min(o1, o2) / min(n1, n2):.2f}x [{card}]")
            if name in launches_per_solve and ln != launches_per_solve[name]:
                smoke.failures.append(f"phase 4 {name}: {ln:g} kernel launches a solve, not "
                                      f"{launches_per_solve[name]}")
            if name.startswith("wta_sq") and dn and do:
                v = vol32 if name.endswith("f32") else vol
                print(f"    {name}: {nbytes(v) / 1e6:.1f} MB volume, new {nbytes(v) / dn / 1e6:.3f} "
                      f"TB/s by device time, {nbytes(v) / min(n1, n2) / 1e9:.3f} TB/s by events; "
                      f"old {nbytes(v) / do / 1e6:.3f} TB/s by device time")
        bound["lr_pair"] = (1e3 * 4 * nbytes(dl) / HBM_BPS, "bytes")
        # their device time a launch over 100 calls back to back
        # (torch.profiler), new and old in turns (old, new, new, old), beside
        # the events and host time of a call, the bound (the pair's its own 4
        # images) and launches x (device - bound) on the main path
        for name, (new, old) in device_cases.items():
            turns = [old, new, new, old] if old else [new]
            got = [per_launch(*t) for t in turns]
            if any(n == 0 for _, n, _ in got):
                smoke.failures.append(f"phase 4 device time {name}: a kernel was not recorded")
                continue
            us_new = [u for (u, _, _), t in zip(got, turns) if t is new]
            n_new, other = got[turns.index(new)][1:]
            ev, host = call_us[name, "new"]
            line = (f"  device {name:8s} {' / '.join(f'{u:.3f}' for u in us_new)} us a launch "
                    f"({n_new // 100} a call; other device work {other}); events "
                    f"{' / '.join(f'{e:.2f}' for e in ev)} us a call, host {host:.2f} us a call; "
                    f"bound {1e3 * bound[name][0]:.3f} us")
            if old:
                us_old = [u for (u, _, _), t in zip(got, turns) if t is old]
                n_old = got[0][1] // 100
                ev, host = call_us[name, "old"]
                line += (f"; old {' / '.join(f'{u:.3f}' for u in us_old)} us a launch, "
                         f"{n_old} a call ({n_old * min(us_old):.3f} us of device time a call), "
                         f"events {' / '.join(f'{e:.2f}' for e in ev)} us a call, host "
                         f"{host:.2f} us")
            if name in launches:
                line += (f"; main-path launches {launches[name]} x (device - bound) = "
                         f"{launches[name] * (min(us_new) / 1e3 - bound[name][0]):.5f} ms")
            print(line + f" [{card}]")
        median_lr_alternatives(dl, dr)
        search_alternatives(vol, vol32, dl)
        solver_alternatives(u01)
        chained = DTAM_ITERS * (nbytes(vol) + 13 * nbytes(d0))
        print(f"  dtam solve {times['dtam'][0]:.4f} ms: chained byte floor {chained / 1e6:.1f} MB "
              f"-> {1e3 * chained / HBM_BPS:.4f} ms ({DTAM_ITERS} x the volume alone "
              f"{1e3 * DTAM_ITERS * nbytes(vol) / HBM_BPS:.4f} ms), the table's bound "
              f"{bound['dtam'][0]:.5f} ms [{card}]")
        # one direction of each class added onto the aggregate: the path
        # kernel and the warp-per-line design over the whole image in turns
        # (old, path, path, old), beside the chained byte floor
        # (the volume, the intensities, the aggregate read and written)
        acc = agg.clone()
        chained = nbytes(vol, img) + 2 * nbytes(acc)
        for cls, step in (("horizontal", (1, 0)), ("vertical", (0, 1)), ("diagonal", (1, 1))):
            path = lambda: sgm_cuda.aggregate_direction(vol, img, step, acc=acc)
            seg = lambda: sgm_cuda._launch_lines(vol, img, acc, acc, step, -1, 0, W, 0, 0.01,
                                                 0.02, "sgm_segment")
            s1 = timing.time_fn(seg, warmup=3, runs=20)["median_ms"]
            p1 = timing.time_fn(path, warmup=3, runs=20)["median_ms"]
            p2 = timing.time_fn(path, warmup=0, runs=20)["median_ms"]
            s2 = timing.time_fn(seg, warmup=0, runs=20)["median_ms"]
            print(f"  direction {cls:10s} {step}: path kernel {p1:.4f} / {p2:.4f} ms, "
                  f"warp-per-line {s1:.4f} / {s2:.4f} ms ({min(s1, s2) / min(p1, p2):.2f}x); "
                  f"chained floor {chained / 1e6:.1f} MB -> {1e3 * chained / HBM_BPS:.4f} ms "
                  f"[{card}]")
            # the same launch with every disparity plane of the volume and
            # of the aggregate aliased onto one (d-stride 0): the data fits
            # in L2, the output is garbage; were device memory the bound,
            # this would run faster
            v1, a1 = vol[:1].expand_as(vol), torch.zeros_like(acc[:1]).expand_as(acc)
            l2 = timing.time_fn(lambda: sgm_cuda._path(v1, img, a1, step, -1, 0.01, 0.02, True,
                                                       "sgm"), warmup=3, runs=20)["median_ms"]
            print(f"  direction {cls:10s} {step}: path kernel, planes aliased (in L2) "
                  f"{l2:.4f} ms [{card}]")
        first = nbytes(vol, img, agg)
        for name, n in (("sgm", 4), ("sgm_8path", 8)):
            floor = first + (n - 1) * chained
            print(f"  {name:9s} {n}-path call {times[name][0]:.4f} ms: chained byte floor "
                  f"{floor / 1e6:.1f} MB -> {1e3 * floor / HBM_BPS:.4f} ms, the table's bound "
                  f"{bound[name][0]:.5f} ms [{card}]")


    def search_alternatives(vol, vol32, last):
        """The search's compile-time configuration against alternatives:
        builds of ``csrc/wta_sq.cu`` with one constant of ``wta_sq.cuh``
        changed (8 or 2 pixels a thread, 4 slices a group, 128 threads a
        block), all compiled together, and the replaced design
        (``kt_wta_sq_pixel``). ``kt_wta_sq`` of each on the VGA/64 volume
        as bf16 and float32, 100 launches back to back under CUDA events,
        in turns (the repo's build, the variant, the variant, the repo's
        build), each variant's result equal to the repo's."""
        import ctypes
        import shutil
        import tempfile

        header = (_build.CSRC_DIR / "wta_sq.cuh").read_text()
        variants = {"8 pixels a thread": ("constexpr int kPixels = 4;",
                                          "constexpr int kPixels = 8;"),
                    "2 pixels a thread": ("constexpr int kPixels = 4;",
                                          "constexpr int kPixels = 2;"),
                    "4 slices a group": ("constexpr int kUnroll = 8;",
                                         "constexpr int kUnroll = 4;"),
                    "128 threads a block": ("constexpr int kSpanThreads = 64;",
                                            "constexpr int kSpanThreads = 128;")}
        tmp = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
        try:
            procs = {}
            for i, (name, (a, b)) in enumerate(variants.items()):
                if a not in header:
                    raise RuntimeError(f"search variant {name}: {a!r} not in wta_sq.cuh")
                src = tmp / str(i)
                src.mkdir()
                (src / "wta_sq.cuh").write_text(header.replace(a, b))
                shutil.copy(_build.CSRC_DIR / "wta_sq.cu", src)
                procs[name] = (src / "lib.so", subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(src / "lib.so"),
                     str(src / "wta_sq.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            libs = {}
            for name, (so, proc) in procs.items():
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    raise RuntimeError(f"search variant {name}: nvcc failed\n{log}")
                libs[name] = ctypes.CDLL(str(so)).kt_wta_sq
                libs[name].argtypes = _build.SIGNATURES["kt_wta_sq"]
            # and the replaced design, timed the same way (no wrapper's host
            # time in the way)
            libs["old kt_wta_sq_pixel"] = lib.kt_wta_sq_pixel
            H_, W_ = last.shape
            stream = torch.cuda.current_stream().cuda_stream

            def us_per_launch(fn, v, out, n=100):
                args = (v.data_ptr(), int(v.dtype == torch.bfloat16), last.data_ptr(),
                        out.data_ptr(), v.shape[0], H_, W_, -1, 20.0, 1.0, stream)
                for _ in range(3):
                    fn(*args)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(n):
                    if fn(*args) != 0:
                        raise RuntimeError("search variant: launch failed")
                e1.record()
                torch.cuda.synchronize()
                return 1e3 * e0.elapsed_time(e1) / n

            for tag, v in (("bf16", vol), ("f32", vol32)):
                ref, out = torch.empty_like(last), torch.empty_like(last)
                for name, fn in libs.items():
                    r1 = us_per_launch(lib.kt_wta_sq, v, ref)
                    a1 = us_per_launch(fn, v, out)
                    a2 = us_per_launch(fn, v, out)
                    r2 = us_per_launch(lib.kt_wta_sq, v, ref)
                    same = torch.equal(out, ref)
                    if not same:
                        smoke.failures.append(f"phase 4 search variant {name} {tag}: differs")
                    print(f"  search variant {tag} {name:20s} {a1:.2f} / {a2:.2f} us a launch, "
                          f"the repo's build {r1:.2f} / {r2:.2f} us; equal {same} [{card}]")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    @contextlib.contextmanager
    def variant_builds(*specs):
        """For each (source, names, variants, entry) of ``specs``: builds of
        ``csrc/<source>`` alone with its compile-time constants ``names``
        changed, those of every spec compiled together; yields for each spec
        {variant: (its constants, its ``entry``)}, the repo's own build first
        as "repo". A variant given as a list of (text, replacement) pairs is
        the source edited so (its constants the repo's)."""
        import ctypes
        import re
        import shutil
        import tempfile

        tmp = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
        try:
            started = []
            for k, (source, names, variants, entry) in enumerate(specs):
                text = (_build.CSRC_DIR / source).read_text()
                repo = {n: int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
                        for n in names}
                configs = {"repo": repo}
                configs.update({name: {**repo, **change} for name, change in variants.items()
                                if isinstance(change, dict) and {**repo, **change} != repo})
                configs.update({name: repo for name, change in variants.items()
                                if isinstance(change, list)})
                procs = {}
                for i, (name, cfg) in enumerate(configs.items()):
                    if name == "repo":
                        continue
                    changed = text
                    for n in names:
                        changed = changed.replace(f"constexpr int {n} = {repo[n]};",
                                                  f"constexpr int {n} = {cfg[n]};")
                    for a, b in variants[name] if isinstance(variants[name], list) else ():
                        if a not in changed:
                            raise RuntimeError(f"{source} variant {name}: {a!r} not in the source")
                        changed = changed.replace(a, b)
                    src = tmp / f"{k}-{i}"
                    src.mkdir()
                    (src / source).write_text(changed)
                    for header, generated in _build.generated_headers().items():
                        (src / header).write_text(generated)
                    procs[name] = (src / "lib.so", subprocess.Popen(
                        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(src / "lib.so"),
                         str(src / source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True))
                started.append((source, entry, configs, procs))
            out = []
            for source, entry, configs, procs in started:
                fns = {"repo": (configs["repo"], getattr(lib, entry))}
                for name, (so, proc) in procs.items():
                    log = proc.communicate()[0]
                    if proc.returncode != 0:
                        raise RuntimeError(f"{source} variant {name}: nvcc failed\n{log}")
                    fn = getattr(ctypes.CDLL(str(so)), entry)
                    fn.argtypes = _build.SIGNATURES[entry]
                    fns[name] = (configs[name], fn)
                out.append(fns)
            yield out
        finally:
            for _, _, _, procs in started:
                for _, proc in procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            shutil.rmtree(tmp, ignore_errors=True)

    def median_lr_alternatives(dl, dr):
        """The median's pixels a thread and rows a block, and the LR check's
        rows a block and threads a row, against alternatives: builds of
        ``csrc/median.cu`` and ``csrc/lr_check.cu`` with one constant changed,
        all compiled together; each build's output against plain on the
        frame's disparities, and its device time a launch over 100 calls
        (torch.profiler), the repo's build beside it."""
        median_variants = {"1 pixel a thread": {"kPix": 1}, "4 pixels a thread": {"kPix": 4},
                           "2 rows a block": {"kRows": 2}, "8 rows a block": {"kRows": 8},
                           "16 rows a block": {"kRows": 16}}
        lr_variants = {"1 row a block": {"kRows": 1}, "4 rows a block": {"kRows": 4},
                       "256 threads a row": {"kThreads": 256}}
        stream = torch.cuda.current_stream().cuda_stream
        Hd, Wd = dl.shape
        want = median_plain.median_filter_reject_invalid(dl, 12, 2)
        want_l, want_r = costvolume.left_right_check_pair(dl, dr, 1.0, D)
        out, out_l, out_r = (torch.empty_like(dl) for _ in range(3))
        with variant_builds(("median.cu", ("kPix", "kRows"), median_variants,
                             "kt_median_reject_invalid"),
                            ("lr_check.cu", ("kRows", "kThreads"), lr_variants,
                             "kt_lr_check")) as (med, lr):
            for tag, fns, part, args, check in (
                    ("median", med, "median_tile_kernel",
                     (dl.data_ptr(), out.data_ptr(), 1, Hd, Wd, 2, 12, stream),
                     lambda n: smoke.compare("median", f"build {n} vs plain", out, want, 0.0)),
                    ("lr pair", lr, "lr_rows_kernel",
                     (dl.data_ptr(), dr.data_ptr(), out_l.data_ptr(), out_r.data_ptr(), Hd, Wd, 0,
                      1.0, D, stream),
                     lambda n: smoke.compare("lr_check", f"pair build {n} vs plain",
                                             torch.stack([out_l, out_r]),
                                             torch.stack([want_l, want_r]), 0.0))):
                repo = fns["repo"][1]
                for name, (cfg, fn) in fns.items():
                    if fn(*args) != 0:
                        raise RuntimeError(f"{tag} variant {name}: launch failed")
                    torch.cuda.synchronize()
                    same = check(name)
                    r1 = per_launch(lambda: repo(*args), part)[0]
                    a1 = per_launch(lambda: fn(*args), part)[0]
                    a2 = per_launch(lambda: fn(*args), part)[0]
                    r2 = per_launch(lambda: repo(*args), part)[0]
                    print(f"  {tag} variant {name:18s} {cfg}: {a1:.3f} / {a2:.3f} us a launch, the "
                          f"repo's build {r1:.3f} / {r2:.3f}; equal {same} [{card}]")

    def ms_per_call(fn, args, n=20):
        """CUDA-event ms a call of a C entry, ``n`` calls back to back."""
        for _ in range(2):
            fn(*args)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            if fn(*args) != 0:
                raise RuntimeError("variant: launch failed")
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    def solver_alternatives(g):
        """The ROF and TGV solves' tile, iterations a launch (kSteps) and
        threads a block against alternatives (``variant_builds`` of
        ``csrc/rof.cu`` and ``csrc/tgv.cu``, all compiled together) and the
        replaced designs (``kt_rof_denoise_steps``, ``kt_tgv_denoise_steps``).
        A 100-iteration solve (ROF: Huber) of each on ``g``, 20 solves back to
        back under CUDA events, in turns (the repo's build, the variant, the
        variant, the repo's build), each variant's result equal to the
        repo's; beside each, its launches a solve and the bound of the cells
        it computes (the tiles and their halos clipped to the image, 27 (ROF)
        or 72 (TGV) float32 operations a cell and iteration: the cone's
        savings not counted)."""
        H_, W_ = g.shape
        stream = torch.cuda.current_stream().cuda_stream
        rof_variants = {
            "K = 8": {"kSteps": 8}, "K = 3": {"kSteps": 3},
            "256 threads": {"kThreads": 256}, "1024 threads": {"kThreads": 1024},
            "tile 40x16": {"kTileX": 40}, "tile 32x20": {"kTileY": 20},
            "tile 64x32, 1024 threads": {"kTileX": 64, "kTileY": 32, "kThreads": 1024},
            # where the time goes (results not the solve's): the launches
            # without their steps, and the steps with inexact divisions
            "cut: no steps": [("  for (int m = 0; m < steps; ++m) {",
                               "  for (int m = 0; m < 0; ++m) {")],
            "cut: fast divisions": [
                ("n0 = n0 / shrink;", "n0 = __fdividef(n0, shrink);"),
                ("n1 = n1 / shrink;", "n1 = __fdividef(n1, shrink);"),
                ("p0[r] = n0 / d;", "p0[r] = __fdividef(n0, d);"),
                ("p1[r] = n1 / d;", "p1[r] = __fdividef(n1, d);"),
                ("u[r] = (u[r] + fmul(tau, divp + lg[r])) / den[r];",
                 "u[r] = __fdividef(u[r] + fmul(tau, divp + lg[r]), den[r]);")]}
        tgv_variants = {"K = 2": {"kSteps": 2}, "K = 3": {"kSteps": 3}, "K = 8": {"kSteps": 8},
                        "tile 32x8": {"kTileY": 8}, "256 threads": {"kThreads": 256}}
        rof_scratch = torch.empty((5, H_, W_), device=dev)
        tgv_scratch = torch.empty((17, H_, W_), device=dev)
        solvers = {
            "rof": ("rof.cu", "kt_rof_denoise", rof_variants, 27,
                    lambda o: (g.data_ptr(), None, o.data_ptr(), rof_scratch.data_ptr(), H_, W_,
                               8.0, 0.5, 0.25, 0.002, 1, SOLVER_ITERS, stream)),
            "tgv": ("tgv.cu", "kt_tgv_denoise", tgv_variants, 72,
                    lambda o: (g.data_ptr(), o.data_ptr(), tgv_scratch.data_ptr(), H_, W_, 2.0,
                               1.0, 0.5, 0.25, 0.1, SOLVER_ITERS, stream)),
        }

        def work(cfg):
            """(launches, cells a launch) of a tile configuration."""
            tx, ty, k = cfg["kTileX"], cfg["kTileY"], cfg["kSteps"]
            cols = sum(min(x + tx + k, W_) - max(x - k, 0) for x in range(0, W_, tx))
            rows = sum(min(y + ty + k, H_) - max(y - k, 0) for y in range(0, H_, ty))
            return -(-SOLVER_ITERS // k), cols * rows

        names = ("kTileX", "kTileY", "kSteps", "kThreads")
        with variant_builds(*((source, names, variants, entry) for source, entry, variants, _, _
                              in solvers.values())) as builds:
            for (tag, (_, entry, _, ops, args)), fns in zip(solvers.items(), builds):
                fns[f"old {entry}_steps"] = (None, getattr(lib, f"{entry}_steps"))
                repo = fns["repo"][1]
                table = 1e3 * ops * H_ * W_ * SOLVER_ITERS / F32_OPS
                ref, out = torch.empty_like(g), torch.empty_like(g)
                for name, (cfg, fn) in fns.items():
                    r1 = ms_per_call(repo, args(ref))
                    a1 = ms_per_call(fn, args(out))
                    a2 = ms_per_call(fn, args(out))
                    r2 = ms_per_call(repo, args(ref))
                    same = torch.equal(out, ref)
                    if not same and not name.startswith("cut"):
                        smoke.failures.append(f"phase 4 {tag} variant {name}: differs")
                    n_launch, cells = work(cfg) if cfg else (2 * SOLVER_ITERS, H_ * W_)
                    what = (f"{cfg['kTileX']}x{cfg['kTileY']} K={cfg['kSteps']} "
                            f"{cfg['kThreads']} threads" if cfg else "one thread a pixel")
                    print(f"  {tag} variant {name:24s} ({what}) {a1:.4f} / {a2:.4f} ms a solve, "
                          f"the repo's build {r1:.4f} / {r2:.4f}; {n_launch} launches, {cells} "
                          f"cells a step -> bound {1e3 * ops * cells * SOLVER_ITERS / F32_OPS:.5f}"
                          f" ms (the table's {table:.5f}); equal {same} [{card}]")

    print(f"phase 4 CUDA-event times at {W}x{H}/{D}:")
    smoke.phase("phase 4", timing_phase)

    def mesh_timing_phase():
        """The segment kernels at the main paths' shapes (a 4-shard
        wavefront's row segment of a column block, with its carry and
        accumulator; a row shard's diagonal segment; the seam pass of 4
        frames; a column shard's vertical pair), their plain versions and
        bounds, and the warp-per-line design (``kt_sgm_segment_lines``)
        timed in turns with them (old, new, new, old); the batch of 4
        against 4 frames; the multi-device
        aggregations on 1 and 4 virtual shards against the single-device
        one, and the 4-shard frames against the single-device frames."""
        cfg4, cfg8 = cfgs["4-path"], cfgs["8-path"]
        vol, img = aggregation_inputs(cfg4)
        n = MESH_SHARDS
        Hs, Ws = H // n, W // n
        rows, cols = slice(Hs, 2 * Hs), slice(Ws, 2 * Ws)
        carry = sgm_cuda.sgm_aggregate_block(vol[:, :Hs, cols], img[:Hs, cols], width=W,
                                             lane_offset=Ws)[1:]
        zero = torch.zeros(W, device=dev)
        dcarry = sgm_cuda.sgm_aggregate_diag_block(vol[:, :Hs], img[:Hs],
                                                   torch.full((D, W), 1e30, device=dev), zero,
                                                   zero, zero)[1:]
        acc_blk = torch.zeros((D, Hs, Ws), device=dev)
        acc_row = torch.zeros((D, Hs, W), device=dev)
        pairs = [synthetic.stereo_pair(W, H, D, seed=k, device=dev) for k in range(BATCH)]
        lefts = torch.stack([p[0] for p in pairs])
        rights = torch.stack([p[1] for p in pairs])
        bits = census.norm_bits(cfg4.census_window)
        vol4 = census.census_cost_volume(
            torch.cat([census.census(p[0], "16x16") for p in pairs]),
            torch.cat([census.census(p[1], "16x16") for p in pairs]), D, -1, bits,
            dtype=torch.bfloat16)
        img4 = stereo_sgm._intensity(lefts.reshape(BATCH * H, W))

        def block(fn, acc):
            return fn(vol[:, rows, cols], img[rows, cols], width=W, seed=False,
                      carry_prev=carry[0], carry_best=carry[1], last_img=carry[2],
                      lane_offset=Ws, acc=acc)

        def diag(fn, acc):
            return fn(vol[:, rows], img[rows], dcarry[0], dcarry[1], dcarry[3], dcarry[2],
                      acc=acc)

        cases = {
            "sgm_segment": (lambda: block(sgm_cuda.sgm_aggregate_block, acc_blk),
                            lambda: block(sgm_plain.sgm_aggregate_block, acc_blk)),
            "sgm_diag_segment": (lambda: diag(sgm_cuda.sgm_aggregate_diag_block, acc_row),
                                 lambda: diag(sgm_plain.sgm_aggregate_diag_block, acc_row)),
            "seam_pass": (lambda: sgm_cuda.semi_global_matching(vol4, img4, seam_period=H),
                          lambda: sgm_plain.semi_global_matching(vol4, img4, seam_period=H)),
            "column_shard": (
                lambda: sgm_cuda.sgm_aggregate_scan(vol[:, :, cols], img[:, cols], width=W,
                                                    lane_offset=Ws),
                lambda: sgm_plain.sgm_aggregate_scan(vol[:, :, cols], img[:, cols], width=W,
                                                     lane_offset=Ws)),
            # against 4 single-device frames through the kernels
            "batch4": (lambda: stereo_sgm.sgm_pipeline_batched(lefts, rights, cfg4),
                       lambda: [stereo_sgm.sgm_pipeline(a, b, cfg4)
                                for a, b in zip(lefts, rights)]),
        }
        def sgm_device_ms(run, reps=10):
            """The SGM kernels' device time in one ``run()``, apart from the
            host's (torch.profiler over ``reps`` runs): the time recorded
            per launch times the launches the wrappers made per run; and
            the launches recorded and made."""
            sgm = ("sgm", "sgm_8path", "sgm_segment", "sgm_diag_segment")
            before = read_counts()
            kernels, _ = device_us(lambda: [run() for _ in range(reps)])
            made = sum(read_counts()[k] - before[k] for k in sgm)
            n = sum(c for k, (c, _) in kernels.items() if "sgm" in k)
            us = sum(t for k, (_, t) in kernels.items() if "sgm" in k)
            return (1e-3 * us / n * made / reps if n else float("nan")), n, made

        def time_lines(run, warmup):
            with lines_design():
                return timing.time_fn(run, warmup=warmup, runs=20)["median_ms"]

        for name, (kern, plain) in cases.items():
            slow = name not in ("batch4",)
            p1 = timing.time_fn(plain, warmup=1, runs=3 if slow else 10)
            if slow:
                o1 = time_lines(kern, 3)
            k1 = timing.time_fn(kern, warmup=3, runs=20)
            k2 = timing.time_fn(kern, warmup=0, runs=20)
            if slow:
                o2 = time_lines(kern, 0)
            p2 = timing.time_fn(plain, warmup=0, runs=3 if slow else 10)
            times[name] = (min(k1["median_ms"], k2["median_ms"]),
                           min(p1["median_ms"], p2["median_ms"]))
            vs = "4 single frames" if name == "batch4" else "plain"
            old = (f", warp-per-line {o1:.4f} / {o2:.4f} ms "
                   f"({min(o1, o2) / times[name][0]:.2f}x)" if slow else "")
            print(f"  {name:16s} kernel {k1['median_ms']:.4f} / {k2['median_ms']:.4f} ms{old}, "
                  f"{vs} {p1['median_ms']:.4f} / {p2['median_ms']:.4f} ms [{card}]")
            if slow:
                dev_ms = [sgm_device_ms(kern)]
                with lines_design():
                    dev_ms.append(sgm_device_ms(kern))
                (k_ms, k_n, k_made), (o_ms, o_n, o_made) = dev_ms
                print(f"  {name:16s} SGM kernels' device time a call {k_ms:.4f} ms ({k_n} of "
                      f"{k_made} launches recorded), warp-per-line {o_ms:.4f} ms ({o_n} of "
                      f"{o_made}) [{card}]")
        k, p = times["batch4"]
        print(f"  batch of {BATCH}: {1e3 * BATCH / k:.2f} fps stacked, {1e3 * BATCH / p:.2f} fps "
              f"as {BATCH} frames [{card}]")

        # bounds: each input read once, each output written once (the
        # accumulator read and written), the carries in and out; 9 float32
        # operations per (d, pixel, direction)
        def nbytes(*ts):
            return sum(t.numel() * t.element_size() for t in ts)

        f32 = 4
        work = {
            "sgm_segment": (nbytes(vol[:, rows, cols], img[rows, cols]) + 2 * nbytes(acc_blk)
                            + 2 * (D + 1) * Ws * f32 + Ws * f32, 9 * acc_blk.numel()),
            "sgm_diag_segment": (nbytes(vol[:, rows], img[rows]) + 2 * nbytes(acc_row)
                                 + 2 * (D + 1) * W * f32 + 2 * W * f32, 9 * acc_row.numel()),
            "seam_pass": (nbytes(vol4, img4) + vol4.numel() * f32, 4 * 9 * vol4.numel()),
            "column_shard": (nbytes(vol[:, :, cols], img[:, cols]) + D * H * Ws * f32,
                             2 * 9 * D * H * Ws),
        }
        for name, (b, ops) in work.items():
            t_bytes, t_ops = 1e3 * b / HBM_BPS, 1e3 * ops / F32_OPS
            bound[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
            print(f"  bound {name:16s} {b / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP -> "
                  f"{bound[name][0]:.5f} ms ({bound[name][1]}); kernel {times[name][0]:.4f} ms")

        # the aggregations and frames, kernel path only: bench.py's 1-shard
        # sharded configs, the virtual 4-shard mesh, the single device
        mesh1 = mesh_mod.make_mesh(devices=[dev])
        runs = {
            "agg_single_4path": lambda: sgm_cuda.semi_global_matching(vol, img),
            "agg_reshard_1shard": lambda: sharding.sharded_semi_global_matching_reshard(
                vol, img, 0.01, 0.02, mesh1),
            "agg_wavefront_1shard": lambda: sharding.sharded_semi_global_matching(
                vol, img, 0.01, 0.02, mesh1),
            "agg_reshard_4shard": lambda: sharding.sharded_semi_global_matching_reshard(
                vol, img, 0.01, 0.02, vmesh),
            "agg_wavefront_4shard": lambda: sharding.sharded_semi_global_matching(
                vol, img, 0.01, 0.02, vmesh),
            "agg_single_8path": lambda: sgm_cuda.semi_global_matching(vol, img,
                                                                      do_diagonal=True),
            "agg_wavefront_8path_4shard": lambda: sharding.sharded_semi_global_matching(
                vol, img, 0.01, 0.02, vmesh, do_diagonal=True),
            "frame_4path": lambda: stereo_sgm.sgm_pipeline(left, right, cfg4),
            "frame_4path_mesh4": lambda: stereo_sgm.sgm_pipeline(left, right, cfg4, mesh=vmesh),
            "frame_8path": lambda: stereo_sgm.sgm_pipeline(left, right, cfg8),
            "frame_8path_mesh4": lambda: stereo_sgm.sgm_pipeline(left, right, cfg8, mesh=vmesh),
        }
        for name, run in runs.items():
            t1 = timing.time_fn(run, warmup=2, runs=10)
            t2 = timing.time_fn(run, warmup=0, runs=10)
            times[name] = (min(t1["median_ms"], t2["median_ms"]), None)
            print(f"  {name:27s} {t1['median_ms']:.4f} / {t2['median_ms']:.4f} ms [{card}]")

    print(f"phase 4 SGM segments, batch and mesh times at {W}x{H}/{D} (a virtual mesh runs its "
          "shards one after another on the card):")
    smoke.phase("phase 4 mesh", mesh_timing_phase)

    def kf_timing_phase():
        """The fuse kernel and its plain version on a running model at
        256^3/VGA, the frame and the sequence replay, and where the frame's
        device time goes."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        depths = kf_data["depths"]
        pipe = kf_seeded()
        for depth in depths[1:3]:
            pipe.process_frame(depth)
        depth = depths[3]
        T_cw = se3.inverse(pipe.T_wl)
        trunc = pipe.trunc_dist
        _, kin_v, kin_n = kf.preprocess_depth(depth, kf_K, kf_cfg)
        axis = separable._view_axis_index(T_cw)
        gmd, gct, params, window = separable.fuse_inputs(
            pipe.vol, kin_v[0][..., 2], kin_n[0], T_cw, kf_K, trunc, kf_cfg.max_w,
            kf_cfg.min_cos_theta, axis, near=kf_cfg.near, far=kf_cfg.far)
        full = torch.tensor([0, kf_cfg.vol_res], dtype=torch.int32, device=dev)
        kvol = (pipe.vol.val.clone(), pipe.vol.weight.clone())
        ovol = (pipe.vol.val.clone(), pipe.vol.weight.clone())
        pvol = (pipe.vol.val.clone(), pipe.vol.weight.clone())

        def fuse_case(win):
            """The fuse on the window ``win``: the kernel, the voxel design it
            replaced (kt_separable_fuse_voxel) and the plain version."""
            args = (gmd, gct, params, win, axis, W, H)
            return (lambda: separable_cuda.fuse_planes(*kvol, *args),
                    lambda: separable_cuda._fuse_planes_voxel(*ovol, *args),
                    lambda: separable.fuse_planes_plain(*pvol, *args))

        fuse_cases = {"separable_fuse": fuse_case(window), "separable_fuse_full": fuse_case(full)}
        for name, (kern, old, plain) in fuse_cases.items():
            # plain, old, kernel, kernel, old, plain
            p1 = timing.time_fn(plain, warmup=1, runs=5)
            o1 = timing.time_fn(old, warmup=3, runs=20)["median_ms"]
            k1 = timing.time_fn(kern, warmup=3, runs=20)
            k2 = timing.time_fn(kern, warmup=0, runs=20)
            o2 = timing.time_fn(old, warmup=0, runs=20)["median_ms"]
            p2 = timing.time_fn(plain, warmup=0, runs=5)
            times[name] = (min(k1["median_ms"], k2["median_ms"]),
                           min(p1["median_ms"], p2["median_ms"]))
            print(f"  {name:19s} kernel {k1['median_ms']:.4f} / {k2['median_ms']:.4f} ms, voxel "
                  f"design {o1:.4f} / {o2:.4f} ms ({min(o1, o2) / times[name][0]:.2f}x), plain "
                  f"{p1['median_ms']:.4f} / {p2['median_ms']:.4f} ms (256^3, {W}x{H} depth, "
                  f"axis {axis}) [{card}]")
            dev_ms = {}
            for design, run in (("kernel", kern), ("voxel design", old)):
                # a fuse is one launch: the device time a recorded launch over
                # 5 fuses (a profile may miss a launch now and then)
                kernels, _ = device_us(run, 5)
                hits = [(n, us) for k, (n, us) in kernels.items() if "separable_fuse" in k]
                n = sum(n for n, _ in hits)
                dev_ms[design] = (sum(us for _, us in hits) / n / 1e3 if n else float("nan"), n)
            print(f"  {name:19s} device time a fuse: kernel {dev_ms['kernel'][0]:.4f} ms "
                  f"({dev_ms['kernel'][1]} of 5 launches recorded), voxel design "
                  f"{dev_ms['voxel design'][0]:.4f} ms ({dev_ms['voxel design'][1]} of 5) "
                  f"[{card}]")
        # the fuse's chunk (voxels a thread loads together) and its blocks
        # an SM against alternatives (variant_builds of csrc/separable_fuse.cu),
        # and the voxel design, on the frame's window: 20 fuses back to back
        # under CUDA events, in turns (the repo's build, the variant, the
        # variant, the repo's build), each variant's volume equal to the
        # repo's after one fuse
        stream = torch.cuda.current_stream().cuda_stream
        D_ = kf_cfg.vol_res

        def fuse_args(v, w):
            return (v.data_ptr(), w.data_ptr(), gmd.data_ptr(), gct.data_ptr(),
                    params.data_ptr(), window.data_ptr(), D_, D_, D_, axis, *gmd.shape, W, H,
                    stream)

        variants = {"1 voxel a chunk": {"kChunk": 1}, "2 voxels a chunk": {"kChunk": 2},
                    "8 voxels a chunk": {"kChunk": 8}, "2 blocks an SM": {"kMinBlocks": 2},
                    "8 blocks an SM": {"kMinBlocks": 8}, "32 rows a block": {"kPlaneRows": 32},
                    "64 rows a block": {"kPlaneRows": 64},
                    # where the time goes (results not the fuse's): every voxel
                    # without an update; the projection alone; the taps too
                    "cut: no sample": [("  const int b = tab.b[ei], row = tab.row[ej];\n",
                                        "  return false;\n  const int b = tab.b[ei], "
                                        "row = tab.row[ej];\n")],
                    "cut: projection": [("  const float ra0 = tab.ra0[ej], ra1",
                                         "  return uu == 12345.f && vv == 54321.f;\n"
                                         "  const float ra0 = tab.ra0[ej], ra1")],
                    "cut: projection, taps": [("  const float sd = fmul(ct, fsub(md, qz));",
                                               "  return md == 12345.f && ct == 54321.f;\n"
                                               "  const float sd = fmul(ct, fsub(md, qz));")]}
        with variant_builds(("separable_fuse.cu", ("kChunk", "kMinBlocks", "kPlaneRows"), variants,
                             "kt_separable_fuse")) as (fns,):
            fns["old kt_separable_fuse_voxel"] = (None, lib.kt_separable_fuse_voxel)
            repo = fns["repo"][1]
            ref = (pipe.vol.val.clone(), pipe.vol.weight.clone())
            repo(*fuse_args(*ref))
            for name, (cfg, fn) in fns.items():
                got = (pipe.vol.val.clone(), pipe.vol.weight.clone())
                fn(*fuse_args(*got))
                same = (torch.equal(got[0].nan_to_num(7.0), ref[0].nan_to_num(7.0))
                        and torch.equal(got[1], ref[1]))
                if not same and not name.startswith("cut"):
                    smoke.failures.append(f"phase 4 fuse variant {name}: differs")
                r1 = ms_per_call(repo, fuse_args(*kvol))
                a1 = ms_per_call(fn, fuse_args(*kvol))
                a2 = ms_per_call(fn, fuse_args(*kvol))
                r2 = ms_per_call(repo, fuse_args(*kvol))
                what = (f"chunk {cfg['kChunk']}, {cfg['kMinBlocks']} blocks, "
                        f"{cfg['kPlaneRows']} rows" if cfg else "one thread a voxel")
                print(f"  fuse variant {name:26s} ({what}) {a1:.4f} / {a2:.4f} ms a fuse, the "
                      f"repo's build {r1:.4f} / {r2:.4f}; equal {same} [{card}]")

        # the bound of what this run's data needs: the weight of every voxel
        # of the window read (its limit applies to all), val read and val
        # and weight written for the voxels updated, the two grids read;
        # about 80 float32 operations per voxel of the window (geometry 30,
        # four-tap samples 24, gate and blend 26). Beside it, a read and a
        # write of val and weight of the window (16 bytes a voxel).
        plane = kf_cfg.vol_res ** 2
        for name, win in (("separable_fuse", window), ("separable_fuse_full", full)):
            before = pipe.vol.weight.clone()
            after = before.clone()
            separable_cuda.fuse_planes(pipe.vol.val.clone(), after, gmd, gct, params, win, axis,
                                       W, H)
            n_upd = int((after != before).sum())
            k_lo, k_hi = win.tolist()
            nvox = (k_hi - k_lo) * plane
            b, ops = 4 * nvox + 12 * n_upd + 2 * gmd.numel() * 4, 80 * nvox
            t_bytes, t_ops = 1e3 * b / HBM_BPS, 1e3 * ops / F32_OPS
            bound[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
            print(f"  bound {name}: planes [{k_lo}, {k_hi}) of {kf_cfg.vol_res}, {n_upd} voxels "
                  f"updated, {b / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP -> {bound[name][0]:.5f} ms "
                  f"({bound[name][1]}); a read and write of the window's val and weight "
                  f"{16 * nvox / 1e6:.1f} MB -> {1e3 * 16 * nvox / HBM_BPS:.5f} ms; kernel "
                  f"{times[name][0]:.4f} ms [{card}]")

        # the frame (process_frame) against the frame of plain versions, and
        # the sequence replay per frame
        pvol_frame = TsdfVolume(pipe.vol.val.clone(), pipe.vol.weight.clone(), pipe.vol.bbox)
        T_plain = pipe.T_wl.clone()
        p1 = timing.time_fn(lambda: plain_kf_frame(pvol_frame, T_plain, depth, False), warmup=1,
                            runs=5)
        k1 = timing.time_fn(pipe.process_frame, depth, warmup=2, runs=10)
        k2 = timing.time_fn(pipe.process_frame, depth, warmup=0, runs=10)
        p2 = timing.time_fn(lambda: plain_kf_frame(pvol_frame, T_plain, depth, False), warmup=0,
                            runs=5)
        times["kf_frame"] = (min(k1["median_ms"], k2["median_ms"]),
                             min(p1["median_ms"], p2["median_ms"]))
        print(f"  kf_frame   kernel {k1['median_ms']:.4f} / {k2['median_ms']:.4f} ms, plain "
              f"{p1['median_ms']:.4f} / {p2['median_ms']:.4f} ms (process_frame, 256^3, "
              f"{W}x{H}) [{card}]")
        stack = torch.stack(depths[1:])
        seq_ms = []
        for _ in range(3):
            seq = kf_seeded()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            seq.run_sequence(stack)
            end.record()
            torch.cuda.synchronize()
            seq_ms.append(start.elapsed_time(end) / len(stack))
        print(f"  kf_sequence run_sequence of {len(stack)} frames: "
              f"{', '.join(f'{m:.4f}' for m in seq_ms)} ms per frame [{card}]")

        # host synchronisations per frame
        sites = host_syncs(lambda: pipe.process_frame(depth))
        print(f"  kf_frame host synchronisations: {sum(sites.values())}, by site "
              f"{json.dumps(dict(sites.most_common()))}")

        # device time by stage and for the whole frame (torch.profiler)
        def device_profile(run):
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
            ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            return (sum(e.self_device_time_total for e in ev), sum(e.count for e in ev), wall_us,
                    sorted(((e.self_device_time_total, e.count, e.key) for e in ev),
                           reverse=True))

        _, kin_v, kin_n = kf.preprocess_depth(depth, kf_K, kf_cfg)
        _, ray_v, ray_n = kf.raycast_model(pipe.vol, pipe.T_wl, kf_K, kf_cfg, levels=kf_cfg.its,
                                           trunc=trunc, cloud=True)
        fvol = TsdfVolume(pipe.vol.val.clone(), pipe.vol.weight.clone(), pipe.vol.bbox)
        stages = {
            "preprocess": lambda: kf.preprocess_depth(depth, kf_K, kf_cfg),
            "raycasts (levels 0, 2, 3)": lambda: kf.raycast_model(
                pipe.vol, pipe.T_wl, kf_K, kf_cfg, levels=kf_cfg.its, trunc=trunc, cloud=True),
            "icp (6 iterations)": lambda: kf.icp_refine(kin_v, ray_v, ray_n, kf_K, kf_cfg),
            "fuse (inputs + kernel)": lambda: separable.sdf_fuse_separable(
                fvol, kin_v[0][..., 2], kin_n[0], T_cw, kf_K, trunc, kf_cfg.max_w,
                kf_cfg.min_cos_theta, near=kf_cfg.near, far=kf_cfg.far, inplace=True),
            "whole frame": lambda: pipe.process_frame(depth),
        }
        for name, run in stages.items():
            busy, n, wall, top = device_profile(run)
            print(f"  profile {name}: {n} kernel launches, device {busy / 1e3:.4f} ms of "
                  f"{wall / 1e3:.4f} ms wall (busy share {busy / wall:.3f}, idle "
                  f"{1 - busy / wall:.3f}) [{card}]")
            for us, count, key in top[:4]:
                print(f"    {us / 1e3:.4f} ms in {count} launches: {key[:90]}")

    print(f"phase 4 KinectFusion times at 256^3, {W}x{H}:")
    smoke.phase("phase 4 KinectFusion", kf_timing_phase)

    def kf_paths_timing_phase():
        """Each leftover path's frame on a running model (frame 3 again after
        frames 1-2): CUDA-event time (two rounds of 5 frames: median, min,
        max), kernel launches and device busy time a frame (torch.profiler),
        host synchronisations by site, and peak memory above the model; the
        exact and guided voxel fuses alone (time and peak memory), and a
        one-voxel roll of the TSDF."""
        depth = kf_data["depths"][3]
        for name in KF_PATHS:
            cfg = kf_path_cfg(name)
            rgb = kf_data["rgb"] if cfg.use_colour else None
            pipe = kf_path_seeded(name)
            for d in kf_data["depths"][1:3]:
                pipe.process_frame(d, rgb=rgb)
            frame = lambda: pipe.process_frame(depth, rgb=rgb)  # noqa: E731
            r1 = timing.time_fn(frame, warmup=1, runs=5)
            r2 = timing.time_fn(frame, warmup=0, runs=5)
            kernels, wall_us = device_us(frame)
            n = sum(c for c, _ in kernels.values())
            busy = sum(us for _, us in kernels.values())
            sites = host_syncs(frame)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            frame()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            lo, hi = min(r1["min_ms"], r2["min_ms"]), max(r1["max_ms"], r2["max_ms"])
            print(f"  kf_{name:7s} frame {r1['median_ms']:.3f} / {r2['median_ms']:.3f} ms (min "
                  f"{lo:.3f}, max {hi:.3f}); {n} kernel launches, device busy {busy / 1e3:.3f} ms "
                  f"of {wall_us / 1e3:.3f} ms profiled wall (idle {1 - busy / wall_us:.3f}); "
                  f"{sum(sites.values())} host synchronisations; peak memory "
                  f"{peak / 2**20:.1f} MiB above the model [{card}]")
            print(f"    host synchronisations by site: {json.dumps(dict(sites.most_common(6)))}")
            top = sorted(((us, c, k) for k, (c, us) in kernels.items()), reverse=True)[:3]
            for us, c, k in top:
                print(f"    {us / 1e3:.4f} ms in {c} launches: {k[:90]}")
            if name == "exact":
                _, kin_v, kin_n = kf.preprocess_depth(depth, kf_K, cfg)
                T_cw = se3.inverse(pipe.T_wl)
                for sample in ("bilinear", "nearest"):
                    fuse = lambda: sdf.sdf_fuse(  # noqa: E731
                        pipe.vol, kin_v[0][..., 2], kin_n[0], T_cw, kf_K, pipe.trunc_dist,
                        cfg.max_w, cfg.min_cos_theta, sample=sample)
                    f1 = timing.time_fn(fuse, warmup=1, runs=5)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    fuse()
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() - base
                    print(f"  sdf_fuse sample={sample}: {f1['median_ms']:.3f} ms (min "
                          f"{f1['min_ms']:.3f}, max {f1['max_ms']:.3f}); peak memory "
                          f"{peak / 2**20:.1f} MiB above the model, of which the new volume "
                          f"{2 * pipe.vol.val.numel() * 4 / 2**20:.1f} MiB [{card}]")
            if name == "moving":
                roll = lambda: rolling.roll_volume(pipe.vol, (1, 0, 0))  # noqa: E731
                r = timing.time_fn(roll, warmup=1, runs=10)
                print(f"  roll_volume by one voxel along x: {r['median_ms']:.3f} ms (min "
                      f"{r['min_ms']:.3f}, max {r['max_ms']:.3f}) [{card}]")

    print(f"phase 4 KinectFusion leftover paths' frames at 256^3, {W}x{H}:")
    smoke.phase("phase 4 KinectFusion paths", kf_paths_timing_phase)

    def filters_timing_phase():
        """BASELINE config 1 and the filters beside it (median of 20 runs),
        the bilateral frame against the unfiltered frame and the frame of
        plain versions (median of 3), the volume filter alone (median of 3)
        with its launches and device time, and the SGM kernel on the
        filtered float32 volume against the bf16 census volume."""
        for name, (fn, x) in filter_cases.items():
            xd = torch.from_numpy(x).to(dev)
            ms = timing.time_fn(fn, xd, warmup=3, runs=20)
            kernels, wall_us = device_us(lambda: fn(xd))
            busy = sum(us for _, us in kernels.values())
            profile = (f"{sum(n for n, _ in kernels.values())} launches, device {busy / 1e3:.4f} "
                       f"ms of {wall_us / 1e3:.4f} ms wall" if kernels
                       else "the profile recorded no device activity")
            print(f"  filter {name:26s} {ms['median_ms']:.4f} ms (min {ms['min_ms']:.4f}, max "
                  f"{ms['max_ms']:.4f}); {profile} [{card}]")
        bcfg = bcfgs["bilateral"]
        frames = {"unfiltered": lambda: stereo_sgm.sgm_pipeline(left, right, cfgs["4-path"]),
                  "bilateral": lambda: stereo_sgm.sgm_pipeline(left, right, bcfg),
                  "bilateral size 3": lambda: stereo_sgm.sgm_pipeline(left, right,
                                                                      bcfgs["bilateral size 3"]),
                  "bilateral plain": lambda: plain_frame(left, right, bcfg)}
        got = {name: [] for name in frames}
        for turn in ("unfiltered", "bilateral", "bilateral plain", "bilateral size 3",
                     "bilateral size 3", "bilateral plain", "bilateral", "unfiltered"):
            got[turn].append(timing.time_fn(frames[turn], warmup=1, runs=3))
        for name, runs in got.items():
            print(f"  frame {name:16s} " + " / ".join(
                f"{r['median_ms']:.2f} (min {r['min_ms']:.2f}, max {r['max_ms']:.2f})"
                for r in runs) + f" ms, median of 3 runs, in turns [{card}]")
        vol, img = census_volume(bcfg), stereo_sgm._intensity(left)
        run = lambda: filtered_volume(bcfg, vol)  # noqa: E731
        ms = timing.time_fn(run, warmup=1, runs=3)
        kernels, wall_us = device_us(run)
        busy = sum(us for _, us in kernels.values())
        n_launches = sum(n for n, _ in kernels.values())
        taps = (2 * bcfg.bilateral_size + 1) ** 2
        print(f"  bilateral_volume {tuple(vol.shape)} f32, size {bcfg.bilateral_size} ({taps} "
              f"taps): {ms['median_ms']:.2f} ms (min {ms['min_ms']:.2f}, max "
              f"{ms['max_ms']:.2f}), median of 3 runs; {n_launches} launches ({n_launches / taps:.2f} a tap), device "
              f"{busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall (busy share "
              f"{busy / wall_us:.3f}) [{card}]")
        for key, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]:
            print(f"    {us / 1e3:.2f} ms in {n} launches: {key[:90]}")
        # the volume's bytes a tap (one read, one write) and its floor
        print(f"  sizing: one read and write of the volume {2 * vol.numel() * 4 / 1e6:.1f} MB, "
              f"{1e3 * 2 * vol.numel() * 4 / HBM_BPS:.4f} ms at {HBM_BPS / 1e12:.2f} TB/s; "
              f"{taps * vol.numel() / 1e9:.2f} G exponentials")
        # kernel 1 on the filtered float32 volume and on the bf16 census volume
        fvol = run()
        bvol = vol.to(torch.bfloat16)
        for what, v in (("bf16 census", bvol), ("f32 filtered", fvol), ("bf16 census", bvol),
                        ("f32 filtered", fvol)):
            sgm = lambda: sgm_cuda.semi_global_matching(v, img)  # noqa: E731
            ev = timing.time_fn(sgm, warmup=3, runs=20)["median_ms"]
            kernels, _ = device_us(sgm, reps=10)
            dev_ms = sum(us for k, (_, us) in kernels.items()
                         if "sgm_rows_kernel" in k or "sgm_cols_kernel" in k) / 1e4
            print(f"  sgm (4 paths) on the {what} volume: {ev:.4f} ms by events, device "
                  f"{dev_ms:.4f} ms a call (torch.profiler, 10 calls) [{card}]")

    print(f"phase 4 filters and the bilateral frame at {W}x{H}/{D}:")
    smoke.phase("phase 4 filters", filters_timing_phase)

    def timed(name, run, runs=10, warmup=2):
        """Events (median, min, max of ``runs``) and one profiled run's
        launches and device time of ``run()``."""
        ms = timing.time_fn(run, warmup=warmup, runs=runs)
        kernels, wall_us = device_us(run)
        busy = sum(us for _, us in kernels.values())
        profile = (f"{sum(n for n, _ in kernels.values())} launches, device {busy / 1e3:.4f} ms "
                   f"of {wall_us / 1e3:.4f} ms wall" if kernels
                   else "the profile recorded no device activity")
        print(f"  {name:34s} {ms['median_ms']:.4f} ms (min {ms['min_ms']:.4f}, max "
              f"{ms['max_ms']:.4f}, {runs} runs); {profile} [{card}]")
        return ms

    def apps_timing_phase():
        """The multi-view accumulation and solves, the coarse_init frame
        against the cold frame in turns, Stereo2App by stage."""
        mvs = new_mvs()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        img, T_wc = mv_track[0]
        img = img.float()
        T_cv = se3.compose(se3.inverse(T_wc), mvs.T_wv)
        KT_cv = mvs.K.matrix(device=dev) @ T_cv
        add = lambda: costvolume.cost_volume_add(mvs.n, mvs.s, mvs.img_v, img, KT_cv, mvs.K,  # noqa: E731
                                                 mvs.baseline, rad=mvs.rad)
        add()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print(f"  cost_volume_add {tuple(mvs.n.shape)}: peak memory {peak / 1e9:.3f} GB above "
              f"the {base / 1e9:.3f} GB held before the call")
        timed("cost_volume_add (one view)", add)
        timed("cost_volume_from_stereo (the seed)",
              lambda: costvolume.cost_volume_from_stereo(mvs.img_v, mv_track[-1][0].float(), D,
                                                         -1, mvs.rad), runs=5)
        for view, T in mv_track:
            mvs.add(view.float(), T)
        timed("MultiViewStereo.solve DTAM 50", lambda: mvs.solve(use_dtam=True), runs=5)
        timed("MultiViewStereo.solve WTA", lambda: mvs.solve(use_dtam=False))
        frames = {"cold": lambda: stereo.stereo_pipeline(left, right, dcfg),
                  "coarse_init": lambda: stereo.stereo_pipeline(left, right, coarse_cfg)}
        for turn in ("cold", "coarse_init", "coarse_init", "cold"):
            timed(f"DTAM frame {turn}", frames[turn], runs=5, warmup=1)
        app = new_stereo2()
        app(left, right, image=left)
        disp = stereo_sgm.sgm_pipeline(left, right, s2_cfg)
        d3d = depth_mod.depth_from_disparity_vbo(disp, s2_K, STEREO2_BASELINE, app.min_disp)
        pts_w = torch.cat([se3.transform(se3.identity(device=dev), d3d[..., :3]),
                           d3d[..., 3:4]], dim=-1)

        def fit(schedule):
            z = None
            for c, its in schedule:
                _, z = plane_fit.fit_plane(d3d, app.Qinv, z0=z, iterations=its,
                                           zmax=app.plane_within, c=c)
            return z

        c = app.plane_c
        timed("Stereo2App SGM frame", lambda: stereo_sgm.sgm_pipeline(left, right, s2_cfg),
              runs=5)
        timed("Stereo2App points (vbo)",
              lambda: depth_mod.depth_from_disparity_vbo(disp, s2_K, STEREO2_BASELINE,
                                                         app.min_disp))
        timed("Stereo2App plane fit, 5 steps",
              lambda: plane_fit.fit_plane(d3d, app.Qinv, z0=app.z, iterations=5,
                                          zmax=app.plane_within, c=c))
        timed("Stereo2App plane fit, 105-step reset",
              lambda: fit(((16 * c, 35), (4 * c, 35), (c, 35))), runs=5)
        timed("Stereo2App heightmap fuse",
              lambda: heightmap.update_heightmap(app.hm.hm, pts_w, left, app.hm.T_hw))
        timed("Stereo2App steady frame", lambda: app(left, right, image=left), runs=5)

    print(f"phase 4 the stereo apps' entry points at {W}x{H}/{D}:")
    smoke.phase("phase 4 apps", apps_timing_phase)
    out_ctx.timed = timed
    print(f"phase 4 the output side and the solvers at {W}x{H} (256^3 volumes):")
    smoke.phase("phase 4 output side", output_times, out_ctx)
    print(f"phase 4 the host side at {W}x{H} (256^3 volume):")
    smoke.phase("phase 4 host side", host_side_times, out_ctx)
    print("phase 3 host side, run last: profiling.trace of an SGM frame")
    smoke.phase("phase 3 profiling.trace", trace_check, out_ctx)
    torch.cuda.synchronize()
    scratch.cleanup()

    if smoke.failures:
        for f in smoke.failures:
            print(f"chip_smoke: FAILED {f}", file=sys.stderr)
        return 1
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": smoke.max_err[name],
         "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": bound[name][0],
         "bound_by": bound[name][1],
         # launches on the host side's runs: the file-fed frame and the demos
         "host_side_launches": out_ctx.host_launches[name],
         # no single PyTorch call computes any of these functions (for the
         # fuse, F.grid_sample computes only the interpolation: none of the
         # update gate, the blend or the 1e-6 weight snap)
         "library_ms": None}
        for name, (src, replaces) in KERNELS.items()]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
