"""The host-side slice of kangaroo_tpu_torch as a whole on the CPU, against
kangaroo_tpu: 16-bit PGM depth files in millimetres through each
package's FrameLoader into its KinectFusion(front_volume=True,
depth_scale=1e-3), as the reference app reads its camera; and each demo of
``kangaroo_tpu_torch/examples`` through ``main([..., "--device", "cpu"])``
at a tiny size, writing the JAX demo's files.

Tolerances. The loaders' frames equal; the poses of the file-fed frames
within 1e-4 of the JAX package's (the KinectFusion tests' tolerance).

Run as a script, this file prints the JAX package's quality on the chip
smoke's file-fed KinectFusion input (the reference of ``chip_smoke.py``'s
limits):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_examples.py

(256^3 volume, 640x480 depth, 9 frames; about 40 s and 3 GB of CPU).
"""
import dataclasses
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.apps import kinectfusion as jkf
from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu.io import frame_loader as jfl
from kangaroo_tpu_torch.apps import kinectfusion as tkf
from kangaroo_tpu_torch.containers import Intrinsics
from kangaroo_tpu_torch.examples import (denoising_demo, features_demo, filters_demo,
                                         kinectfusion_demo, raycast_demo, sdf_difference_demo,
                                         sdf_fusion_demo, stereo_demo, sum_speed_demo)
from kangaroo_tpu_torch.io import frame_loader as tfl
from kangaroo_tpu_torch.io import pxm

ROOT = Path(__file__).resolve().parent.parent
POSE_TOL = 1e-4
DEMOS = {"denoising": denoising_demo, "features": features_demo, "filters": filters_demo,
         "kinectfusion": kinectfusion_demo, "raycast": raycast_demo,
         "sdf_difference": sdf_difference_demo, "sdf_fusion": sdf_fusion_demo,
         "stereo": stereo_demo, "sum_speed": sum_speed_demo}


def orbit_pgms(out_dir, n, K, w, h, scene_res, step, radius):
    """The JAX package's synthetic orbit as 16-bit PGM depth files in
    millimetres (NaN -> 0), written with the port's pxm: (paths, the raw
    frames, the true poses relative to frame 0 as float32 (3, 4))."""
    seq = list(jsyn.depth_sequence(n, K, w, h, scene=jsyn.sphere_scene(res=scene_res), step=step,
                                   radius=radius))
    T0 = np.vstack([np.asarray(seq[0][0], np.float64), [0.0, 0.0, 0.0, 1.0]])
    paths, raws, poses = [], [], []
    for i, (T, d) in enumerate(seq):
        raw = np.rint(np.nan_to_num(np.asarray(d), nan=0.0) * np.float32(1000)).astype(np.uint16)
        path = str(Path(out_dir) / f"depth_{i:05d}.pgm")
        pxm.save_pxm(path, raw)
        paths.append(path)
        raws.append(raw)
        T = np.vstack([np.asarray(T, np.float64), [0.0, 0.0, 0.0, 1.0]])
        poses.append((np.linalg.inv(T0) @ T)[:3].astype(np.float32))
    return paths, raws, poses


def test_file_fed_kinectfusion_matches_jax(tmp_path):
    """3 uint16 orbit frames at 64x48 (a 48^3 front volume), read by each
    package's loader and fed raw to its KinectFusion, seeded at frame 0's
    pose (the identity in camera 0's frame, where a file-fed run starts)."""
    w, h = 64, 48
    K = kt.Intrinsics.centered(55.0, w, h)
    paths, raws, true = orbit_pgms(tmp_path, 3, K, w, h, 64, 0.015, 2.0)
    jframes = list(jfl.FrameLoader(paths, use_native=True))
    tframes = list(tfl.FrameLoader(paths))
    for (ji, jraw), (ti, traw), raw in zip(jframes, tframes, raws, strict=True):
        assert ji == ti and traw.dtype == np.uint16
        np.testing.assert_array_equal(traw, raw)
        np.testing.assert_array_equal(traw, jraw)
    jcfg = jkf.KinectFusionConfig(w=w, h=h, vol_res=48, vol_extent=1.2, max_levels=2, its=(2, 2),
                                  near=0.5, far=6.0, max_rmse=0.3, front_volume=True)
    tcfg = tkf.KinectFusionConfig.from_dict(dataclasses.asdict(jcfg))
    jpipe = jkf.KinectFusion(K, jcfg)
    tpipe = tkf.KinectFusion(Intrinsics.create(K.fu, K.fv, K.u0, K.v0), tcfg, device="cpu")
    jcfg.depth_scale = tcfg.depth_scale = 1e-3  # after construction, as the demo sets it
    jpipe.T_wl = jnp.asarray(true[0])
    tpipe.T_wl = torch.from_numpy(true[0].copy())
    for (_, jraw), (_, traw), T in zip(jframes, tframes, true):
        want = np.asarray(jpipe.process_frame(jnp.asarray(jraw)))
        got = tpipe.process_frame(torch.from_numpy(traw)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=POSE_TOL)
        assert tpipe.tracking_good == jpipe.tracking_good
        assert np.abs(got[:, 3] - T[:, 3]).max() < 0.05
    assert float(tpipe.vol.weight.max()) > 0


def _templates(path):
    """The artefact names a demo writes (``f"{out}/<name>"``), as written."""
    return sorted(set(re.findall(r'f"\{out\}/([^"]+)"', path.read_text())))


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_writes_the_jax_demos_artefacts(name):
    want = _templates(ROOT / "examples" / f"{name}_demo.py")
    assert _templates(ROOT / "kangaroo_tpu_torch" / "examples" / f"{name}_demo.py") == want


@pytest.fixture
def out(tmp_path, monkeypatch):
    monkeypatch.setenv("KANGAROO_OUT", str(tmp_path / "out"))
    return tmp_path / "out"


KF = ["--frames", "3", "--volres", "32", "--width", "64", "--height", "48"]
STEREO = ["--width", "96", "--height", "64", "--maxdisp", "16"]
STEREO_FILES = ["left.png", "gt_disp.png", "disp_{}.png", "depth_{}.png", "cloud_{}.ply"]
# (demo, arguments, files the JAX demo writes for them)
RUNS = {
    "kinectfusion": ("kinectfusion", KF, ["kf_render.png", "kf_depth.png", "kf_mesh.ply",
                                          "kf_save.vol"]),
    "kinectfusion sequence": ("kinectfusion", KF + ["--sequence"], None),
    "kinectfusion colour": ("kinectfusion", KF + ["--colour"], None),
    "stereo sgm": ("stereo", STEREO, [f.format("sgm") for f in STEREO_FILES]),
    "stereo heightmap": ("stereo", STEREO + ["--heightmap"],
                         [f.format("sgm") for f in STEREO_FILES] + ["heightmap_sgm.ply"]),
    "stereo dtam": ("stereo", STEREO + ["--mode", "dtam"],
                    [f.format("dtam") for f in STEREO_FILES]),
    "stereo wta": ("stereo", STEREO + ["--mode", "wta"], [f.format("wta") for f in STEREO_FILES]),
    "stereo multiview": ("stereo", STEREO + ["--mode", "multiview"],
                         [f.format("multiview") for f in STEREO_FILES]),
    "denoising": ("denoising", ["--iterations", "5"],
                  ["noisy.png", "denoised_rof.png", "denoised_tgv.png", "blurry.png",
                   "deconvolved.png", "corrupted.png", "inpainted.png"]),
    "features": ("features", [], ["fast.png", "harris_nms.png"]),
    "filters": ("filters", ["--size", "2", "--guided-rad", "3"],
                ["anaglyph.png", "bilateral.png", "guided.png"]),
    "raycast": ("raycast", ["--size", "48", "--res", "24", "--views", "2"],
                [f"raycast_{k}_{i}.png" for k in ("shaded", "depth", "normals", "sweep")
                 for i in range(2)]),
    "sdf_difference": ("sdf_difference", ["--width", "64", "--height", "48", "--focal", "58"],
                       ["sdf_diff.png", "sdf_diff_shaded.png"]),
    "sdf_fusion": ("sdf_fusion", ["--res", "24", "--views", "2", "--size", "48"],
                   ["raycast_primitives.png", "sdf_fusion_render.png", "sdf_fusion_gt_diff.png",
                    "save.vol", "fused.ply"]),
    "sum_speed": ("sum_speed", ["--iters", "2"], []),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_demo_main_on_cpu(run, out):
    demo, args, files = RUNS[run]
    result = DEMOS[demo].main(args + ["--device", "cpu"])
    files = RUNS[demo][2] if files is None else files
    written = sorted(p.name for p in out.iterdir()) if out.exists() else []
    assert set(files) <= set(written), (files, written)
    for f in files:
        assert (out / f).stat().st_size > 0, f
    if demo == "kinectfusion":
        assert result.tracking_good and float(result.vol.weight.max()) > 0
    if demo == "sum_speed":
        assert 0 < result["min"] <= result["median"] <= result["max"]


def test_kinectfusion_demo_input_and_stereo_rig(tmp_path, out):
    """``--input``: PGM files through the native loader into a front
    volume; ``--rig``: intrinsics and baseline from a rig file."""
    K = kt.Intrinsics.centered(64 * 0.9, 64, 48)
    orbit_pgms(tmp_path, 3, K, 64, 48, 64, 0.02, 2.0)
    pipe = kinectfusion_demo.main(KF + ["--input", str(tmp_path), "--device", "cpu"])
    assert pipe.cfg.front_volume and pipe.cfg.depth_scale == 1e-3 and pipe.frame == 3
    assert float(pipe.vol.weight.max()) > 0
    rig = {"cameras": [
        {"name": "left", "width": 192, "height": 128, "fu": 172.8, "fv": 172.8, "u0": 95.5,
         "v0": 63.5},
        {"name": "right", "width": 192, "height": 128, "fu": 172.8, "fv": 172.8, "u0": 95.5,
         "v0": 63.5, "T_wc": [0.08, 0.0, 0.0, 0.0, 0.0, 0.0]}]}
    (tmp_path / "rig.json").write_text(json.dumps(rig))
    disp, depth, cloud = stereo_demo.main(STEREO + ["--rig", str(tmp_path / "rig.json"),
                                                    "--device", "cpu"])
    fb = np.float32(np.float32(86.4) * np.float32(0.08))
    valid = np.isfinite(depth.numpy())
    np.testing.assert_allclose(depth.numpy()[valid], fb / disp.numpy()[valid], rtol=1e-6)
    assert (out / "cloud_sgm.ply").stat().st_size > 0


def jax_file_fed_quality(w=640, h=480, vol_res=256, frames=9):
    """The JAX package's quality on the chip smoke's file-fed KinectFusion
    input: bench.py's config (its=(1, 0, 2, 3), near 0.5, far 6.0) with
    ``front_volume=True`` and ``depth_scale=1e-3`` on
    synthetic.depth_sequence(frames, K, w, h, sphere_scene(res=128),
    step=0.01), K = centered(550), each frame rounded to uint16 millimetres
    (NaN -> 0), poses taken relative to frame 0, frame 0 seeded at the
    identity, the rest tracked. ATE is bench.py's (the RMS of the
    translation errors), final rmse the last frame's ICP rmse."""
    import tempfile

    K = kt.Intrinsics.centered(550.0, w, h)
    cfg = jkf.KinectFusionConfig(w=w, h=h, vol_res=vol_res, vol_extent=1.2, max_levels=4,
                                 its=(1, 0, 2, 3), near=0.5, far=6.0, front_volume=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths, _, true = orbit_pgms(tmp, frames, K, w, h, 128, 0.01, 3.0)
        raws = [raw for _, raw in jfl.FrameLoader(paths, use_native=True)]
    pipe = jkf.KinectFusion(K, cfg)
    cfg.depth_scale = 1e-3
    pipe.T_wl = jnp.asarray(true[0])
    poses = [np.asarray(pipe.process_frame(jnp.asarray(raw))) for raw in raws]
    est = np.stack(poses[1:])[:, :, 3]
    ref = np.stack(true[1:])[:, :, 3]
    return {"ate_rmse_m": float(np.sqrt(np.mean(np.sum((est - ref) ** 2, axis=1)))),
            "final_rmse": float(pipe.rmse)}


if __name__ == "__main__":
    print(json.dumps(jax_file_fed_quality()))
