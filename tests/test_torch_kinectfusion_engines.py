"""KinectFusion's guided and exact engines, colour fusion and the moving
workspace: kangaroo_tpu_torch.apps.kinectfusion against kangaroo_tpu's on
tests/test_apps.py's 4-frame synthetic orbit (64x48 depth, a 48^3 volume,
its=(2, 2)), pose for pose, and tests/test_apps.py's moving-volume scenario.

Tolerances, test_torch_kinectfusion.py's: poses within 1e-4 (measured
under 4e-6), weights within 1e-3 where both updated with at most 1 % of
the updated voxels flipped (0 measured), values within 1e-3; the colour
volume within 1e-3 where both updated (test_apps.py's own bound between
its colour sequence replay and its frame loop). Renders of the same state
(the JAX package's, carried across by state_from_numpy) as
test_torch_separable.py's raycasts: NaN masks within 0.5 % of the pixels,
depth within 1e-4 and images within 1e-3 elsewhere (measured equal).
Renders of each package's own state: the same depth and images, except
that pixels whose march ends elsewhere (a guided fine march starts a step
apart when a coarse sample lies an ulp apart) are counted and held to 1 %
of the hits (0.8 % measured on the colour render); their normals are the
volume's gradient at the hit, which an ulp of the volume turns by up to
1e-2 where the truncated band is flat, so they are held on the same state
only. The rgb frame is
synthetic.colour_texture (seed 0), seen by a colour camera of focal 55 and
a 5 cm baseline.

The output side runs on the JAX package's state after the orbit (the
colour and guided runs): volume files byte-equal and read back equal,
meshes ("tet" and "mc") bit-equal with byte-equal .ply files, and the
keyframe-textured render at the render tolerances above.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.apps import kinectfusion as jkf
from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu_torch.apps import kinectfusion as tkf
from kangaroo_tpu_torch.apps import synthetic as tsyn
from kangaroo_tpu_torch.containers import Intrinsics
from kangaroo_tpu_torch.fusion import separable_cuda
from test_torch_kinectfusion import POSE_TOL, WEIGHT_TOL, _compare_volumes, _config, _port, orbit

W, H = 64, 48
COLOUR = dict(use_colour=True, rgb_focal=55.0, rgb_baseline_m=0.05)
MOVING = dict(moving_threshold_voxels=2, moving_lead_m=2.0)
CONFIGS = {"guided": dict(engine="guided"), "exact": dict(engine="exact"), "colour": COLOUR,
           "colour exact": dict(engine="exact", **COLOUR), "moving": MOVING}
_ = orbit  # the module-scoped orbit fixture


@pytest.fixture(scope="module")
def rgb():
    return tsyn.colour_texture(W, H, device="cpu").numpy()


@pytest.fixture(scope="module")
def jax_runs(orbit, rgb):
    """The JAX package's frame loop of each config, run once: its pipeline
    after the orbit and the per-frame (pose, tracking_good, bbox.lo)."""
    K, frames = orbit
    runs = {}

    def run(name):
        if name not in runs:
            jcfg, _ = _config(**CONFIGS[name])
            pipe = jkf.KinectFusion(K, jcfg)
            pipe.T_wl = jnp.asarray(frames[0][0])
            kw = dict(rgb=jnp.asarray(rgb)) if jcfg.use_colour else {}
            trace = [(np.asarray(pipe.process_frame(jnp.asarray(d), **kw)), pipe.tracking_good,
                      np.asarray(pipe.vol.bbox.lo)) for _, d in frames]
            runs[name] = (pipe, trace)
        return runs[name]

    return run


def _port_loop(K, frames, name, rgb):
    _, cfg = _config(**CONFIGS[name])
    pipe = _port(K, cfg, frames[0][0])
    kw = dict(rgb=torch.from_numpy(rgb)) if cfg.use_colour else {}
    trace = [(pipe.process_frame(torch.from_numpy(d.copy()), **kw).numpy(), pipe.tracking_good,
              pipe.vol.bbox.lo.numpy()) for _, d in frames]
    return pipe, trace


def _compare_traces(got, want):
    for (T_g, good_g, lo_g), (T_w, good_w, lo_w) in zip(got, want):
        np.testing.assert_allclose(T_g, T_w, atol=POSE_TOL, rtol=0)
        assert good_g == good_w
        np.testing.assert_array_equal(lo_g, lo_w)


def _compare_colour(got, want):
    gw, ww = got.vol.weight.numpy(), np.asarray(want.vol.weight)
    both = (gw > 0) & (ww > 0)
    gc, wc = got.color_vol.data.numpy(), np.asarray(want.color_vol.data)
    np.testing.assert_allclose(gc[both], wc[both], atol=WEIGHT_TOL, rtol=0)
    np.testing.assert_array_equal(gc[(gw == 0) & (ww == 0)], 0.5)
    assert np.ptp(gc[both]) > 0.3  # the texture, not a flat grey


def _compare_renders(got, want, max_off_share=0.0, normals=True):
    gd, wd = got[0].numpy(), np.asarray(want[0])
    gn, wn = np.isnan(gd), np.isnan(wd)
    assert (gn != wn).mean() <= 0.005
    both = ~gn & ~wn
    assert both.sum() > 100
    off = both & (np.abs(gd - wd) > 1e-4)
    assert off.sum() <= max_off_share * both.sum(), (int(off.sum()), int(both.sum()))
    ok = both & ~off
    for g, w in zip(got[1:] if normals else got[2:], want[1:] if normals else want[2:]):
        np.testing.assert_allclose(g.numpy()[ok], np.asarray(w)[ok], atol=1e-3, rtol=0)


def _render_both(pipe, jpipe, **kw):
    """The port's render of its own state and of the JAX package's state
    against the JAX package's render."""
    want = jpipe.render(**kw)
    _compare_renders(pipe.render(**kw), want, max_off_share=0.01, normals=False)
    colour = np.asarray(jpipe.color_vol.data) if jpipe.color_vol is not None else None
    state = tkf.state_from_numpy(np.asarray(jpipe.vol.val), np.asarray(jpipe.vol.weight),
                                 np.asarray(jpipe.vol.bbox.lo), np.asarray(jpipe.vol.bbox.hi),
                                 np.asarray(jpipe.T_wl), device="cpu", color=colour)
    pipe.vol, pipe.T_wl = state[0], state[-1]
    if colour is not None:
        pipe.color_vol = state[1]
    _compare_renders(pipe.render(**kw), want)


@pytest.mark.parametrize("name", ["guided", "exact"])
def test_engine_frame_loop_matches_jax(orbit, jax_runs, rgb, name):
    K, frames = orbit
    jpipe, want = jax_runs(name)
    pipe, got = _port_loop(K, frames, name, rgb)
    _compare_traces(got, want)
    assert pipe.frame == 4 and pipe.tracking_good
    assert abs(pipe.rmse - jpipe.rmse) <= 1e-5
    assert np.abs(got[-1][0] - frames[-1][0]).max() < 0.06  # and it tracks the orbit
    _compare_volumes(pipe.vol, jpipe.vol)
    # the view-only render (coarse to fine on the guided engine)
    _render_both(pipe, jpipe)


@pytest.mark.parametrize("name", ["colour", "colour exact"])
def test_colour_frame_loop_matches_jax(orbit, jax_runs, rgb, name):
    """The colour frame: the whole step with the plane-sweep colour fuse,
    or the staged frame with the voxel colour fuse; then the colour render
    (the guided raycast on the separable engine, as in the JAX package)."""
    K, frames = orbit
    jpipe, want = jax_runs(name)
    pipe, got = _port_loop(K, frames, name, rgb)
    _compare_traces(got, want)
    assert pipe.tracking_good
    _compare_volumes(pipe.vol, jpipe.vol)
    _compare_colour(pipe, jpipe)
    _render_both(pipe, jpipe, show_colour=True)


def test_colour_run_sequence_matches_loop_and_jax(orbit, jax_runs, rgb):
    """run_sequence(rgbs=) against the port's frame loop (poses within
    1e-4, colour within 1e-3, as test_apps.py's replay against its loop)
    and against the JAX package's replay."""
    K, frames = orbit
    jloop, _ = jax_runs("colour")
    loop, trace = _port_loop(K, frames, "colour", rgb)
    jcfg, cfg = _config(**COLOUR)
    depths = np.stack([d for _, d in frames])
    rgbs = np.stack([rgb] * len(frames))
    seq = _port(K, cfg, frames[0][0])
    poses, rmses = seq.run_sequence(torch.from_numpy(depths), rgbs=torch.from_numpy(rgbs))
    np.testing.assert_allclose(poses.numpy(), np.stack([T for T, _, _ in trace]), atol=POSE_TOL,
                               rtol=0)
    np.testing.assert_allclose(seq.color_vol.data.numpy(), loop.color_vol.data.numpy(),
                               atol=WEIGHT_TOL, rtol=0)
    jseq = jkf.KinectFusion(K, jcfg)
    jseq.T_wl = jnp.asarray(frames[0][0])
    jposes, _ = jseq.run_sequence(jnp.asarray(depths), rgbs=jnp.asarray(rgbs))
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=POSE_TOL, rtol=0)
    _compare_volumes(seq.vol, jseq.vol)
    _compare_colour(seq, jseq)
    assert seq.frame == 4 and seq.tracking_good == jseq.tracking_good


def test_run_sequence_refusals(orbit):
    K, frames = orbit
    depths = torch.from_numpy(np.stack([d for _, d in frames[:2]]))
    cases = [(dict(engine="guided"), None, "separable"), (COLOUR, None, "rgbs"),
             ({}, torch.zeros(2, H, W, 3), "use_colour=False")]
    for overrides, rgbs, match in cases:
        _, cfg = _config(**overrides)
        with pytest.raises(ValueError, match=match):
            _port(K, cfg, frames[0][0]).run_sequence(depths, rgbs=rgbs)


def test_reset_refills_the_colour_volume(orbit, rgb):
    K, frames = orbit
    _, cfg = _config(**COLOUR)
    pipe = _port(K, cfg, frames[0][0])
    pipe.process_frame(torch.from_numpy(frames[0][1].copy()), rgb=torch.from_numpy(rgb),
                       pose_refinement=False)
    assert (pipe.color_vol.data != 0.5).any()
    pipe.reset()
    assert bool((pipe.color_vol.data == 0.5).all())
    assert float(pipe.vol.weight.max()) == 0.0
    assert torch.equal(pipe.T_wl, torch.eye(3, 4))


def test_state_from_numpy_with_colour(orbit, jax_runs, rgb):
    """Both packages take frame 3 from the JAX package's colour state after
    frame 2 (a fresh JAX pipeline run to there)."""
    K, frames = orbit
    jcfg, cfg = _config(**COLOUR)
    jpipe = jkf.KinectFusion(K, jcfg)
    jpipe.T_wl = jnp.asarray(frames[0][0])
    for _, d in frames[:3]:
        jpipe.process_frame(jnp.asarray(d), rgb=jnp.asarray(rgb))
    pipe = _port(K, cfg, frames[0][0])
    pipe.vol, pipe.color_vol, pipe.T_wl = tkf.state_from_numpy(
        np.asarray(jpipe.vol.val), np.asarray(jpipe.vol.weight), np.asarray(jpipe.vol.bbox.lo),
        np.asarray(jpipe.vol.bbox.hi), np.asarray(jpipe.T_wl), device="cpu",
        color=np.asarray(jpipe.color_vol.data))
    pipe.frame = jpipe.frame
    np.testing.assert_array_equal(pipe.color_vol.bbox.hi.numpy(),
                                  np.asarray(jpipe.color_vol.bbox.hi))
    want = np.asarray(jpipe.process_frame(jnp.asarray(frames[3][1]), rgb=jnp.asarray(rgb)))
    got = pipe.process_frame(torch.from_numpy(frames[3][1].copy()), rgb=torch.from_numpy(rgb))
    np.testing.assert_allclose(got.numpy(), want, atol=POSE_TOL, rtol=0)
    _compare_volumes(pipe.vol, jpipe.vol)
    _compare_colour(pipe, jpipe)


def test_moving_frame_loop_matches_jax(orbit, jax_runs, rgb):
    """The moving workspace on the orbit (threshold 2 voxels, lead 2 m):
    the same rolls (the box after every frame exactly), the same poses."""
    K, frames = orbit
    jpipe, want = jax_runs("moving")
    pipe, got = _port_loop(K, frames, "moving", rgb)
    _compare_traces(got, want)
    rolls = sum(not np.array_equal(a[2], b[2]) for a, b in zip(got, got[1:]))
    assert rolls >= 1
    _compare_volumes(pipe.vol, jpipe.vol)


def test_moving_volume_follows_camera():
    """tests/test_apps.py's scenario: a frame fused at the true pose, the
    camera moved 0.6 m along x, the roll, the render from the old pose,
    against the JAX package step by step."""
    w, h = 48, 36
    K = kt.Intrinsics.centered(40.0, w, h)
    jcfg = jkf.KinectFusionConfig(w=w, h=h, vol_res=32, vol_extent=1.2, max_levels=1, its=(1,),
                                  near=0.5, far=6.0, moving_threshold_voxels=2,
                                  moving_lead_m=3.0)
    cfg = tkf.KinectFusionConfig.from_dict(dataclasses.asdict(jcfg))
    (T_wc, depth), = list(jsyn.depth_sequence(1, K, w, h, scene=jsyn.sphere_scene(res=48)))
    depth = jnp.where(jnp.isfinite(depth), depth, 0.0)
    jpipe = jkf.KinectFusion(K, jcfg)
    jpipe.T_wl = T_wc
    jpipe.process_frame(depth, pose_refinement=False)
    pipe = tkf.KinectFusion(Intrinsics.create(float(K.fu), float(K.fv), float(K.u0),
                                              float(K.v0)), cfg, device="cpu")
    pipe.T_wl = torch.from_numpy(np.array(T_wc))
    pipe.process_frame(torch.from_numpy(np.array(depth)), pose_refinement=False)
    w_before = float(pipe.vol.weight.sum())
    lo0 = pipe.vol.bbox.lo.clone()
    jpipe.T_wl = jpipe.T_wl.at[0, 3].add(0.6)
    pipe.T_wl[0, 3] += 0.6
    jpipe._maybe_roll()
    pipe._maybe_roll()
    np.testing.assert_array_equal(pipe.vol.bbox.lo.numpy(), np.asarray(jpipe.vol.bbox.lo))
    assert float(pipe.vol.bbox.lo[0]) > float(lo0[0]) + 0.3
    assert float(pipe.vol.weight.sum()) > 0.2 * w_before
    np.testing.assert_allclose(pipe.vol.weight.numpy(), np.asarray(jpipe.vol.weight),
                               atol=WEIGHT_TOL, rtol=0)
    T_back = pipe.T_wl.clone()
    T_back[0, 3] -= 0.6
    assert torch.isfinite(pipe.render(T_wc=T_back)[0]).any()
    _render_both(pipe, jpipe, T_wc=np.array(jpipe.T_wl.at[0, 3].add(-0.6)))


def test_cpu_engine_frames_launch_no_kernel(orbit, rgb):
    K, frames = orbit
    before = separable_cuda.launches
    for name in ("guided", "colour"):
        _port_loop(K, frames[:2], name, rgb)
    assert separable_cuda.launches == before


# --- the output side: volume files, meshes and keyframe texturing ------------------------


def _shared_state(name, orbit, jax_runs):
    """The JAX package's pipeline after the orbit and a port pipeline that
    holds the same state (state_from_numpy)."""
    K, frames = orbit
    jpipe, _ = jax_runs(name)
    _, cfg = _config(**CONFIGS[name])
    pipe = _port(K, cfg, frames[0][0])
    colour = np.asarray(jpipe.color_vol.data) if jpipe.color_vol is not None else None
    state = tkf.state_from_numpy(np.asarray(jpipe.vol.val), np.asarray(jpipe.vol.weight),
                                 np.asarray(jpipe.vol.bbox.lo), np.asarray(jpipe.vol.bbox.hi),
                                 np.asarray(jpipe.T_wl), device="cpu", color=colour)
    pipe.vol, pipe.T_wl = state[0], state[-1]
    if colour is not None:
        pipe.color_vol = state[1]
    return jpipe, pipe


@pytest.mark.parametrize("name", ["colour", "guided"])
def test_volume_files_match_jax(orbit, jax_runs, name, tmp_path):
    """save_volume writes the JAX package's bytes; load_volume reads them
    back onto the app's device, equal, and the next frame runs."""
    K, frames = orbit
    jpipe, pipe = _shared_state(name, orbit, jax_runs)
    pipe.save_volume(str(tmp_path / "t.vol"))
    jpipe.save_volume(str(tmp_path / "j.vol"))
    for suffix in ("", ".bbox.npy"):
        assert ((tmp_path / f"t.vol{suffix}").read_bytes()
                == (tmp_path / f"j.vol{suffix}").read_bytes())
    _, cfg = _config(**CONFIGS[name])
    fresh = _port(K, cfg, frames[0][0])
    fresh.load_volume(str(tmp_path / "j.vol"))
    for a, b in ((fresh.vol.val, pipe.vol.val), (fresh.vol.weight, pipe.vol.weight),
                 (fresh.vol.bbox.lo, pipe.vol.bbox.lo), (fresh.vol.bbox.hi, pipe.vol.bbox.hi)):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if cfg.use_colour:  # the frame step is rebuilt for the loaded volume
        fresh.T_wl, fresh.frame = pipe.T_wl, 4
        fresh.process_frame(torch.from_numpy(frames[-1][1].copy()),
                            rgb=tsyn.colour_texture(W, H, device="cpu"))
        assert fresh.tracking_good


@pytest.mark.parametrize("method", ["tet", "mc"])
def test_save_mesh_matches_jax(orbit, jax_runs, method, tmp_path):
    """The fused orbit's mesh: the JAX package's triangles and .ply bytes."""
    jpipe, pipe = _shared_state("colour", orbit, jax_runs)
    got = pipe.save_mesh(str(tmp_path / "t.ply"), method=method)
    want = jpipe.save_mesh(str(tmp_path / "j.ply"), method=method)
    assert len(got) > 1000
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    with pytest.raises(ValueError, match="method"):
        pipe.save_mesh(str(tmp_path / "x.ply"), method="marching")


@pytest.mark.parametrize("name", ["colour", "guided"])
def test_keyframe_texturing_matches_jax(orbit, jax_runs, rgb, name):
    """render_textured without keyframes (grey shading, alpha 1), then after
    two save_keyframe calls at two poses of the orbit (the colour camera's
    T_iw and K_rgb under use_colour, the depth camera's without), from the
    last pose and from a given one, at the render tolerances above."""
    K, frames = orbit
    jpipe, pipe = _shared_state(name, orbit, jax_runs)
    jkeys, jT = list(jpipe.keyframes), jpipe.T_wl
    jpipe.keyframes.clear()
    try:
        _compare_renders(pipe.render_textured(), jpipe.render_textured())
        got = pipe.render_textured()[2]
        assert got.shape == (H, W, 4) and bool((got[..., 3] == 1).all())
        img = (255.0 * rgb[..., 1]).astype(np.float32)
        for T in (frames[1][0], frames[-1][0]):
            pipe.T_wl, jpipe.T_wl = torch.from_numpy(T.copy()), jnp.asarray(T)
            pipe.save_keyframe(torch.from_numpy(img))
            jpipe.save_keyframe(jnp.asarray(img))
        assert len(pipe.keyframes) == 2
        _, K_kf, T_iw = pipe.keyframes[-1]
        _, jK_kf, jT_iw = jpipe.keyframes[-1]
        assert (K_kf.fu, K_kf.u0) == (float(jK_kf.fu), float(jK_kf.u0))
        np.testing.assert_allclose(T_iw.numpy(), np.asarray(jT_iw), atol=1e-6, rtol=0)
        for kw in ({}, dict(T_wc=frames[2][0])):
            want = jpipe.render_textured(**kw)
            got = pipe.render_textured(**{k: torch.from_numpy(v.copy()) for k, v in kw.items()})
            _compare_renders(got, want)
            textured = np.isfinite(np.asarray(want[0]))
            assert np.ptp(np.asarray(want[2])[..., 0][textured]) > 0.1  # keyframe colour
        pipe.reset()
        assert pipe.keyframes == []
    finally:  # the JAX pipeline is the module's, shared with the tests above
        jpipe.keyframes[:], jpipe.T_wl = jkeys, jT
