"""The KinectFusion frame on the plane-sweep engine:
kangaroo_tpu_torch.apps.kinectfusion against kangaroo_tpu's on
tests/test_apps.py's 4-frame synthetic orbit (64x48 depth, a 48^3 volume,
its=(2, 2)).

Tolerances. Poses within 1e-4 of the JAX package's (measured ~2e-7 apart).
The fused volume's weights within 1e-3 where both updated (test_apps.py's
own bound between its scan replay and its frame loop), except for voxels
counted as flips and held to 1 % of the updated ones: the principal point
of a centred 64x48 camera lies on a half pixel, where the fuse's
nearest-neighbour warp and its gates can take the other side on one ulp of
the geometry. The port's sequence replay equals its frame loop exactly
(the same step on the same axis).

Run as a script, this file prints the JAX package's quality on the chip
smoke's KinectFusion input (the references of ``chip_smoke.py``'s limits):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_kinectfusion.py

(256^3 volume, 640x480 depth, 9 frames; about a minute and 3 GB of CPU).
"""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.apps import kinectfusion as jkf
from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu.parallel import mesh as jmesh
from kangaroo_tpu_torch.apps import kinectfusion as tkf
from kangaroo_tpu_torch.apps import synthetic as tsyn
from kangaroo_tpu_torch.containers import Intrinsics
from kangaroo_tpu_torch.fusion import separable_cuda
from kangaroo_tpu_torch.parallel import mesh as tmesh

W, H = 64, 48
POSE_TOL, WEIGHT_TOL, MAX_FLIP_SHARE = 1e-4, 1e-3, 0.01


def _config(**overrides):
    jcfg = jkf.KinectFusionConfig(w=W, h=H, vol_res=48, vol_extent=1.2, max_levels=2, its=(2, 2),
                                  near=0.5, far=6.0, max_rmse=0.3, bilateral_minval=0.2,
                                  **overrides)
    return jcfg, tkf.KinectFusionConfig.from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def orbit():
    """(K, frames as (T_wc, depth) NumPy pairs with sensor-style zeros)."""
    K = kt.Intrinsics.centered(55.0, W, H)
    frames = jsyn.depth_sequence(4, K, W, H, scene=jsyn.sphere_scene(res=64), step=0.015)
    return K, [(np.asarray(T), np.asarray(jnp.where(jnp.isfinite(d), d, 0.0))) for T, d in frames]


def _port(K, cfg, T0):
    pipe = tkf.KinectFusion(Intrinsics.create(float(K.fu), float(K.fv), float(K.u0),
                                              float(K.v0)), cfg, device="cpu")
    pipe.T_wl = torch.from_numpy(T0.copy())
    return pipe


def _compare_volumes(got, want):
    gw, ww = got.weight.numpy(), np.asarray(want.weight)
    gu, wu = gw > 0, ww > 0
    both = gu & wu
    off = both & (np.abs(gw - ww) > WEIGHT_TOL)
    flips = int((gu != wu).sum()) + int(off.sum())
    assert wu.sum() > 1000
    assert flips <= MAX_FLIP_SHARE * wu.sum(), (flips, int(wu.sum()))
    ok = both & ~off
    np.testing.assert_allclose(gw[ok], ww[ok], atol=WEIGHT_TOL, rtol=0)
    np.testing.assert_allclose(got.val.numpy()[ok], np.asarray(want.val)[ok], atol=1e-3, rtol=0)


def test_frame_loop_matches_jax(orbit):
    K, frames = orbit
    jcfg, cfg = _config()
    jpipe = jkf.KinectFusion(K, jcfg)
    jpipe.T_wl = jnp.asarray(frames[0][0])
    pipe = _port(K, cfg, frames[0][0])
    for T_wc, depth in frames:
        want = np.asarray(jpipe.process_frame(jnp.asarray(depth)))
        got = pipe.process_frame(torch.from_numpy(depth.copy())).numpy()
        np.testing.assert_allclose(got, want, atol=POSE_TOL, rtol=0)
        assert pipe.tracking_good == jpipe.tracking_good
    assert pipe.frame == jpipe.frame == 4 and pipe.tracking_good
    assert abs(pipe.rmse - jpipe.rmse) <= 1e-5
    assert np.abs(got - frames[-1][0]).max() < 0.06  # and it tracks the orbit
    _compare_volumes(pipe.vol, jpipe.vol)
    # the view-only render from the final pose
    jd, _, _ = jpipe.render()
    td, _, _ = pipe.render()
    both = np.isfinite(np.asarray(jd)) & np.isfinite(td.numpy())
    assert both.sum() > 0.95 * np.isfinite(np.asarray(jd)).sum()
    np.testing.assert_allclose(td.numpy()[both], np.asarray(jd)[both], atol=1e-3, rtol=0)


def test_run_sequence_equals_the_loop(orbit):
    K, frames = orbit
    _, cfg = _config()
    depths = torch.from_numpy(np.stack([d for _, d in frames]))
    loop = _port(K, cfg, frames[0][0])
    loop_poses = [loop.process_frame(d) for d in depths]
    seq = _port(K, cfg, frames[0][0])
    poses, rmses = seq.run_sequence(depths)
    assert poses.shape == (4, 3, 4) and rmses.shape == (4,)
    assert seq._seq_axis == 0 and seq.frame == 4 and seq.tracking_good
    assert torch.equal(poses, torch.stack(loop_poses))
    assert torch.equal(seq.vol.weight, loop.vol.weight)
    assert abs(seq.rmse - loop.rmse) == 0.0
    # resuming picks up where the replay left off
    poses2, _ = seq.run_sequence(depths[-1:])
    assert seq.frame == 5 and seq.tracking_good
    assert (poses2[-1] - poses[-1]).abs().max() < 0.05


def test_staged_frame_without_pose_refinement_matches_jax(orbit):
    """process_frame(pose_refinement=False): fuse at the given pose, no ICP."""
    K, frames = orbit
    jcfg, cfg = _config()
    jpipe = jkf.KinectFusion(K, jcfg)
    pipe = _port(K, cfg, frames[0][0])
    for T_wc, depth in frames[:2]:
        jpipe.T_wl = jnp.asarray(T_wc)
        pipe.T_wl = torch.from_numpy(T_wc.copy())
        jpipe.process_frame(jnp.asarray(depth), pose_refinement=False)
        pipe.process_frame(torch.from_numpy(depth.copy()), pose_refinement=False)
    _compare_volumes(pipe.vol, jpipe.vol)


def test_state_from_numpy_resumes_the_jax_state(orbit):
    """Both packages start frame 2 from the JAX package's volume and pose."""
    K, frames = orbit
    jcfg, cfg = _config()
    jpipe = jkf.KinectFusion(K, jcfg)
    jpipe.T_wl = jnp.asarray(frames[0][0])
    for _, depth in frames[:2]:
        jpipe.process_frame(jnp.asarray(depth))
    pipe = _port(K, cfg, frames[0][0])
    pipe.vol, pipe.T_wl = tkf.state_from_numpy(
        np.asarray(jpipe.vol.val), np.asarray(jpipe.vol.weight), np.asarray(jpipe.vol.bbox.lo),
        np.asarray(jpipe.vol.bbox.hi), np.asarray(jpipe.T_wl), device="cpu")
    pipe.frame = jpipe.frame
    want = np.asarray(jpipe.process_frame(jnp.asarray(frames[2][1])))
    got = pipe.process_frame(torch.from_numpy(frames[2][1].copy())).numpy()
    np.testing.assert_allclose(got, want, atol=POSE_TOL, rtol=0)
    _compare_volumes(pipe.vol, jpipe.vol)


def test_synthetic_sequence_matches_jax(orbit):
    K, frames = orbit
    scene = tsyn.sphere_scene(res=64, device="cpu")
    np.testing.assert_allclose(scene.val.numpy(), np.asarray(jsyn.sphere_scene(res=64).val),
                               atol=1e-6, rtol=0)
    tK = Intrinsics.centered(55.0, W, H)
    for (T_want, d_want), (T_got, d_got) in zip(frames, tsyn.depth_sequence(
            4, tK, W, H, scene=scene, step=0.015)):
        np.testing.assert_array_equal(T_got.numpy(), T_want)
        d_got = torch.where(torch.isfinite(d_got), d_got, 0.0).numpy()
        assert (d_got == 0).mean() == pytest.approx((d_want == 0).mean(), abs=0.005)
        both = (d_got > 0) & (d_want > 0)
        np.testing.assert_allclose(d_got[both], d_want[both], atol=1e-4, rtol=0)


def test_config_from_dict_carries_every_field():
    jcfg, cfg = _config(icp_c=0.2, fuse_roi=False, raycast_downsample=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tkf.KinectFusionConfig()) == \
        dataclasses.asdict(jkf.KinectFusionConfig())


@pytest.mark.parametrize("call", ["mesh"])
def test_unported_entry_points_raise(call):
    """Every entry point is ported; ``mesh=`` raises the JAX package's
    ValueError without the one-sweep frame (tests/test_parallel.py), and
    runs with it (tests/test_torch_kinectfusion_mesh.py)."""
    jcfg, cfg = _config()
    mesh = tmesh.make_mesh(devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        jkf.KinectFusion(kt.Intrinsics.centered(55.0, W, H), jcfg, mesh=jmesh.make_mesh(8))
    K = Intrinsics.centered(55.0, W, H)
    with pytest.raises(ValueError):
        tkf.KinectFusion(K, cfg, mesh=mesh, device="cpu")
    assert tkf.KinectFusion(K, dataclasses.replace(cfg, raycast_downsample=True), mesh=mesh,
                            device="cpu").mesh is mesh


def test_raycast_downsample_frame_tracks(orbit):
    """The one-sweep variant (coarser ICP levels from a box-downsampled
    raycast, window association) against the JAX package's."""
    K, frames = orbit
    jcfg, cfg = _config(raycast_downsample=True)
    jpipe = jkf.KinectFusion(K, jcfg)
    jpipe.T_wl = jnp.asarray(frames[0][0])
    pipe = _port(K, cfg, frames[0][0])
    for _, depth in frames[:3]:
        want = np.asarray(jpipe.process_frame(jnp.asarray(depth)))
        got = pipe.process_frame(torch.from_numpy(depth.copy())).numpy()
        np.testing.assert_allclose(got, want, atol=POSE_TOL, rtol=0)


def test_cpu_frame_launches_no_kernel(orbit):
    K, frames = orbit
    _, cfg = _config()
    before = separable_cuda.launches
    pipe = _port(K, cfg, frames[0][0])
    for _, depth in frames[:2]:
        pipe.process_frame(torch.from_numpy(depth.copy()))
    assert separable_cuda.launches == before


def jax_reference_quality(w=640, h=480, vol_res=256, frames=9, engine="separable",
                          use_colour=False, moving_threshold_voxels=0, moving_lead_m=0.5):
    """The JAX package's KinectFusion quality at the chip smoke's input:
    bench.py's config (its=(1, 0, 2, 3), near 0.5, far 6.0) on
    synthetic.depth_sequence(frames, K, w, h, sphere_scene(res=128),
    step=0.01), K = centered(550), on ``engine``, with colour fusion of the
    port's ``synthetic.colour_texture(w, h)`` (seed 0) in every frame under
    ``use_colour``, and the moving workspace under
    ``moving_threshold_voxels`` > 0: frame 0 seeded at the true pose, then
    the rest as a frame loop and, on the separable engine without the moving
    workspace, as a sequence replay from a fresh seed. ATE is bench.py's
    (the RMS of the translation errors), final rmse the last frame's ICP
    rmse; with colour also the share of voxels touched (weight > 0) and the
    median grey of the colour volume over them; with the moving workspace
    the number of frames that rolled the volume."""
    K = kt.Intrinsics.centered(550.0, w, h)
    cfg = jkf.KinectFusionConfig(w=w, h=h, vol_res=vol_res, vol_extent=1.2, max_levels=4,
                                 its=(1, 0, 2, 3), near=0.5, far=6.0, engine=engine,
                                 use_colour=use_colour,
                                 moving_threshold_voxels=moving_threshold_voxels,
                                 moving_lead_m=moving_lead_m)
    seq = list(jsyn.depth_sequence(frames, K, w, h, scene=jsyn.sphere_scene(res=128), step=0.01))
    depths = [jnp.where(jnp.isfinite(d), d, 0.0) for _, d in seq]
    ref_t = np.stack([np.asarray(T)[:, 3] for T, _ in seq[1:]])
    rgb = jnp.asarray(tsyn.colour_texture(w, h, device="cpu").numpy()) if use_colour else None

    def seeded():
        pipe = jkf.KinectFusion(K, cfg)
        pipe.T_wl = jnp.asarray(seq[0][0])
        pipe.process_frame(depths[0], rgb=rgb)
        return pipe

    def quality(poses, rmse):
        est = np.asarray(poses)[:, :, 3]
        return {"ate_rmse_m": float(np.sqrt(np.mean(np.sum((est - ref_t) ** 2, axis=1)))),
                "final_rmse": float(rmse)}

    loop = seeded()
    poses, rolls = [], 0
    for d in depths[1:]:
        lo = np.asarray(loop.vol.bbox.lo)
        poses.append(np.asarray(loop.process_frame(d, rgb=rgb)))
        rolls += int(not np.array_equal(lo, np.asarray(loop.vol.bbox.lo)))
    out = {"loop": quality(np.stack(poses), loop.rmse)}
    if use_colour:
        touched = np.asarray(loop.vol.weight) > 0
        out["loop"].update(touched_share=float(touched.mean()),
                           median_grey=float(np.median(np.asarray(loop.color_vol.data)[touched])))
    if moving_threshold_voxels > 0:
        out["loop"]["rolls"] = rolls
    elif engine == "separable":
        rgbs = jnp.stack([rgb] * (frames - 1)) if use_colour else None
        poses, rmses = seeded().run_sequence(jnp.stack(depths[1:]), rgbs=rgbs)
        out["sequence"] = quality(poses, np.asarray(rmses)[-1])
    return out


if __name__ == "__main__":
    import json

    # positional ints (w h vol_res frames), then key=value options, e.g.
    # engine=guided use_colour=1 moving_threshold_voxels=2 moving_lead_m=2.0
    args = [a for a in sys.argv[1:] if "=" not in a]
    opts = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    kinds = {"engine": str, "use_colour": lambda v: bool(int(v)),
             "moving_threshold_voxels": int, "moving_lead_m": float}
    print(json.dumps(jax_reference_quality(*map(int, args),
                                           **{k: kinds[k](v) for k, v in opts.items()})))
