"""The stereo app's remaining entry points: kangaroo_tpu_torch against
kangaroo_tpu on the CPU. Intrinsics (project, unproject, scale, inverse
matrix), disparity to depth and points, the running-mean cost volumes
(seeded from a pair, accumulated from posed views), the multi-view track,
``MultiViewStereo`` (WTA and DTAM, and resumed from the JAX package's
state), ``stereo_pipeline`` with ``coarse_init``, ``depth_and_cloud``,
``export_depthmap`` and the PXM files. The same NumPy inputs from a seed
go through both, at the JAX package's app-test sizes.

Tolerances: intrinsics and depth 1e-6 relative (one float32 formula);
``cost_volume_from_stereo`` 1e-5 of the largest sum (its patch means come
from float32 cumsums, added in another order); ``cost_volume_add``: n
equal on >= 99.9 % of cells (a projection that lands on the 5-pixel
border or on the d = 0 plane can flip its in-bounds test) and s / n within
1e-4 of the largest mean where both counted; the disparities of
``MultiViewStereo`` and ``coarse_init`` >= 99.5 % of pixels both NaN or
within 1e-3 px (a last-bit difference can move a subpixel step or flip
the LR check); the multi-view track, the .pdm/.pgm files and the PXM
files exactly, byte for byte.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_stereo_apps.py``
prints the JAX package's quality at VGA/64 (``MultiViewStereo`` on
``multiview_track(640, 480, 64)``, stereo-seeded, 3 views, DTAM 50
iterations and WTA; the ``coarse_init`` cold frame on ``stereo_pair(640,
480, 64, seed=0)``): the references beside which chip_smoke.py sets its
limits.
"""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.apps import stereo as jst
from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu.core import se3 as jse3
from kangaroo_tpu.geometry import depth as jdepth
from kangaroo_tpu.io import pxm as jpxm
from kangaroo_tpu.stereo import costvolume as jcv
from kangaroo_tpu_torch.apps import stereo as tst
from kangaroo_tpu_torch.apps import synthetic as tsyn
from kangaroo_tpu_torch.containers import BoundingBox, Intrinsics, TsdfVolume
from kangaroo_tpu_torch.core import se3 as tse3
from kangaroo_tpu_torch.geometry import depth as tdepth
from kangaroo_tpu_torch.io import pxm as tpxm
from kangaroo_tpu_torch.stereo import costvolume as tcv

SIZES = [(96, 64, 16), (128, 96, 32)]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def intrinsics(f, W, H):
    return kt.Intrinsics.centered(f, W, H), Intrinsics.centered(f, W, H)


def agreement(a, b, tol=1e-3):
    a, b = np.asarray(a), np.asarray(b)
    return float(((np.isnan(a) & np.isnan(b)) | (np.abs(a - b) <= tol)).mean())


def disp_stats(disp, gt, band: int):
    """bench.py's disp_stats: invalid fraction and median error inside the
    frame, skipping the ``band`` columns and an 8-pixel border."""
    d, g = np.asarray(disp), np.asarray(gt)
    inner = np.zeros(d.shape, bool)
    inner[8:-8, band:-8] = True
    m = np.isfinite(d) & inner
    err = np.abs(d[m] - g[m])
    return {"invalid_frac": float(1.0 - m.sum() / inner.sum()),
            "median_err_px": float(np.median(err))}


# --- intrinsics and depth ------------------------------------------------------


def test_intrinsics_match_jax():
    jK, tK = intrinsics(57.3, 37, 23)
    P = np.random.default_rng(0).normal(0, 1, (5, 7, 3)).astype(np.float32)
    P[..., 2] = np.abs(P[..., 2]) + 0.5
    np.testing.assert_allclose(tK.project(t(P)).numpy(), np.asarray(jK.project(P)), rtol=1e-6)
    u, v, z = P[..., 0] * 30, P[..., 1] * 20, P[..., 2]
    for zz in (None, z):
        want = np.asarray(jK.unproject(u, v, zz))
        got = tK.unproject(t(u), t(v), None if zz is None else t(zz)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    jS, tS = jK.scale(0.37), tK.scale(0.37)
    assert [tS.fu, tS.fv, tS.u0, tS.v0] == [float(np.asarray(v)) for v in
                                             (jS.fu, jS.fv, jS.u0, jS.v0)]
    np.testing.assert_allclose(tK.inverse_matrix(device="cpu").numpy(),
                               np.asarray(jK.inverse_matrix()), rtol=1e-7)


@pytest.mark.parametrize("min_disp", [0.0, 3.5])
def test_disparity_to_depth_and_points_match_jax(min_disp):
    jK, tK = intrinsics(100.0, 37, 23)
    disp = np.random.default_rng(1).uniform(-1, 16, (23, 37)).astype(np.float32)
    disp[3, 4] = np.nan
    for got, want in ((tdepth.disp_to_depth(t(disp), tK.fu, 0.3, min_disp),
                       jdepth.disp_to_depth(disp, jK.fu, 0.3, min_disp)),
                      (tdepth.depth_from_disparity_vbo(t(disp), tK, 0.3, min_disp),
                       jdepth.depth_from_disparity_vbo(disp, jK, 0.3, min_disp))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    depth, cloud = tst.depth_and_cloud(t(disp), tK, 0.3, min_disp)
    jdepth_, jcloud = jst.depth_and_cloud(disp, jK, 0.3, min_disp)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth_), rtol=1e-6)
    np.testing.assert_allclose(cloud.numpy(), np.asarray(jcloud), rtol=1e-6)
    assert (cloud[..., 3].numpy() == (disp >= min_disp)).all()


@pytest.mark.parametrize("w,h,maxpixels", [(640, 480, 640 * 480), (640, 480, 20000),
                                            (37, 23, 1)])
def test_level_from_max_pixels_matches_jax(w, h, maxpixels):
    from kangaroo_tpu.containers import intrinsics as jintr
    from kangaroo_tpu_torch.containers import intrinsics as tintr

    assert tintr.level_from_max_pixels(w, h, maxpixels) == \
        jintr.level_from_max_pixels(w, h, maxpixels)


def test_kinect_filter_and_colouring_match_jax():
    rng = np.random.default_rng(11)
    depth_mm = rng.uniform(0, 900, (23, 37)).astype(np.float32)
    np.testing.assert_array_equal(tdepth.filter_bad_kinect_data(t(depth_mm)).numpy(),
                                  np.asarray(jdepth.filter_bad_kinect_data(depth_mm)))
    jK, tK = intrinsics(30.0, 37, 23)
    depth = rng.uniform(0.8, 2.0, (23, 37)).astype(np.float32)
    pts = np.asarray(jdepth.depth_to_vbo(depth, jK))
    img = (rng.random((20, 30, 3)) * 255).astype(np.float32)
    KT = np.asarray(jnp.asarray(jK.matrix()) @ jse3.exp(jnp.asarray(
        [0.05, -0.02, 0.1, 0.01, 0.03, -0.02], jnp.float32)))
    got = tdepth.colour_vbo(t(pts), t(img), t(KT))
    want = np.asarray(jdepth.colour_vbo(pts, img, KT))
    assert got.dtype == torch.uint8 and (want[..., 3] == 255).mean() > 0.3
    # uint8 truncation of a bilinear sample a last bit apart may step by 1
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("grey", [False, True])
def test_texture_depth_matches_jax(grey):
    rng = np.random.default_rng(12)
    jK, tK = intrinsics(30.0, 37, 23)
    depth = rng.uniform(0.8, 2.0, (23, 37)).astype(np.float32)
    normals = np.asarray(jdepth.normals_from_vbo(jdepth.depth_to_vbo(depth, jK)))
    normals = np.where(np.isfinite(normals), normals, 0.0).astype(np.float32)
    shape = (20, 30) if grey else (20, 30, 3)
    imgs = [(rng.random(shape) * 255).astype(np.float32) for _ in range(2)]
    poses = [np.asarray(jse3.exp(jnp.asarray(xi, jnp.float32))) for xi in
             ([0.05, 0.0, 0.1, 0.0, 0.02, 0.0], [-0.1, 0.02, 0.0, 0.01, -0.03, 0.0])]
    T_wd = np.asarray(jse3.exp(jnp.asarray([0.0, 0.01, 0.0, 0.0, 0.0, 0.01], jnp.float32)))
    want = jdepth.texture_depth(depth, normals, imgs[0], jK, poses[0], T_wd, jK)
    got = tdepth.texture_depth(t(depth), t(normals), t(imgs[0]), tK, t(poses[0]), t(T_wd), tK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    phong = rng.random((23, 37)).astype(np.float32)
    want = jdepth.texture_depth_keyframes(depth, normals, phong,
                                          [(i, jK, T) for i, T in zip(imgs, poses)], T_wd, jK)
    got = tdepth.texture_depth_keyframes(t(depth), t(normals), t(phong),
                                         [(t(i), tK, t(T)) for i, T in zip(imgs, poses)],
                                         t(T_wd), tK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_noise_inputs_match_jax():
    depth = np.random.default_rng(13).uniform(0.2, 4.0, (24, 32)).astype(np.float32)
    depth[0, :5] = np.nan
    want = np.asarray(jsyn.kinect_noise(jnp.asarray(depth), seed=3))
    got = tsyn.kinect_noise(t(depth), seed=3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    for got, want in zip(tsyn.noisy_stereo_pair(48, 32, 8, seed=2, device="cpu"),
                         jsyn.noisy_stereo_pair(48, 32, 8, seed=2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- running-mean cost volumes ---------------------------------------------------


def pair(W, H, D, seed):
    left, right, gt = jsyn.stereo_pair(W, H, D, seed=seed)
    return np.asarray(left, np.float32), np.asarray(right, np.float32), np.asarray(gt)


@pytest.mark.parametrize("W,H,D", SIZES)
@pytest.mark.parametrize("sd,rad", [(-1, 1), (1, 2)])
def test_cost_volume_from_stereo_matches_jax(W, H, D, sd, rad):
    left, right, _ = pair(W, H, D, seed=2)
    jn, js = jcv.cost_volume_from_stereo(left, right, D, sd, rad)
    tn, ts = tcv.cost_volume_from_stereo(t(left), t(right), D, sd, rad)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    js = np.asarray(js)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5 * float(js.max()))


def test_cost_elem_to_float_and_zero_match_jax():
    rng = np.random.default_rng(3)
    n = rng.integers(0, 3, (4, 5, 6)).astype(np.float32)
    s = (rng.random((4, 5, 6)) * 50 * n).astype(np.float32)
    np.testing.assert_array_equal(tcv.cost_elem_to_float(t(n), t(s)).numpy(),
                                  np.asarray(jcv.cost_elem_to_float(n, s)))
    for got, want in zip(tcv.cost_volume_zero(4, 5, 6, device="cpu"), jcv.cost_volume_zero(4, 5, 6)):
        assert got.shape == (4, 5, 6) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_accumulator(tn, ts, jn, js):
    """n equal on >= 99.9 % of cells; s / n within 1e-4 of the largest mean
    where both counted."""
    tn, ts, jn, js = (np.asarray(a) for a in (tn, ts, jn, js))
    assert (tn == jn).mean() >= 0.999
    both = (tn > 0) & (jn > 0)
    assert both.mean() > 0.3
    tm, jm = ts[both] / tn[both], js[both] / jn[both]
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-4 * float(np.abs(jm).max()))


@pytest.mark.parametrize("W,H,D", SIZES)
@pytest.mark.parametrize("rad,pose", [(1, ([0.0, 0.0, 0.0], [0.3, 0.0, 0.0])),
                                      (2, ([0.0, 0.02, -0.01], [0.15, 0.01, 0.05]))])
def test_cost_volume_add_matches_jax(W, H, D, rad, pose):
    """A lateral view (rectified geometry) and a view turned and shifted
    off the baseline, added onto a stereo-seeded volume."""
    left, right, _ = pair(W, H, D, seed=2)
    jK, tK = intrinsics(100.0, W, H)
    T_wc = np.asarray(jse3.exp(jnp.asarray(pose[1] + pose[0], jnp.float32)))
    KT = np.asarray(jnp.asarray(jK.matrix()) @ jse3.inverse(jnp.asarray(T_wc)))
    jn, js = jcv.cost_volume_from_stereo(left, right, D, -1, rad)
    tn, ts = tcv.cost_volume_from_stereo(t(left), t(right), D, -1, rad)
    jn, js = jcv.cost_volume_add(jn, js, left, right, KT, jK, 0.3, rad=rad)
    tn, ts = tcv.cost_volume_add(tn, ts, t(left), t(right), t(KT), tK, 0.3, rad=rad)
    assert tn.dtype == ts.dtype == torch.float32 and tn.shape == (D, H, W)
    check_accumulator(tn, ts, jn, js)
    assert float(tn.max()) == 2.0


def test_multiview_track_matches_jax():
    want_key, want_gt, want_track = jsyn.multiview_track(48, 32, 8, seed=4)
    key, gt, track = tsyn.multiview_track(48, 32, 8, seed=4, device="cpu")
    np.testing.assert_array_equal(key.numpy(), np.asarray(want_key))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(want_gt))
    assert len(track) == len(want_track) == 3
    for (img, T), (want_img, want_T) in zip(track, want_track):
        assert img.dtype == torch.uint8
        np.testing.assert_array_equal(img.numpy(), np.asarray(want_img))
        np.testing.assert_array_equal(T.numpy(), np.asarray(want_T))


# --- MultiViewStereo ----------------------------------------------------------------


def multiview(W, H, D, seed, stereo_seed, iterations=20):
    """A JAX and a port MultiViewStereo on the same keyframe and track."""
    key, gt, track = jsyn.multiview_track(W, H, D, seed=seed, baseline=0.3)
    jK, tK = intrinsics(100.0, W, H)
    jcfg = jst.StereoConfig(max_disp=D, dtam_iterations=iterations)
    cfg = tst.StereoConfig.from_dict(dataclasses.asdict(jcfg))
    jm, tm = jst.MultiViewStereo(jK, 0.3, jcfg), tst.MultiViewStereo(tK, 0.3, cfg)
    key = np.asarray(key, np.float32)
    right = np.asarray(track[-1][0], np.float32) if stereo_seed else None
    jm.reset(jnp.asarray(key), jse3.identity(), None if right is None else jnp.asarray(right))
    tm.reset(t(key), tse3.identity(device="cpu"), None if right is None else t(right))
    track = [(np.asarray(img, np.float32), np.asarray(T)) for img, T in track]
    return jm, tm, track, np.asarray(gt)


@pytest.mark.parametrize("W,H,D", SIZES)
@pytest.mark.parametrize("stereo_seed", [False, True])
def test_multiview_stereo_matches_jax(W, H, D, stereo_seed):
    jm, tm, track, gt = multiview(W, H, D, seed=5, stereo_seed=stereo_seed)
    for img, T in track:
        jm.add(jnp.asarray(img), jnp.asarray(T))
        n, s = tm.add(t(img), t(T))
        assert n is tm.n and s is tm.s
    check_accumulator(tm.n, tm.s, jm.n, jm.s)
    for use_dtam in (False, True):
        want = np.asarray(jm.solve(use_dtam=use_dtam))
        got = tm.solve(use_dtam=use_dtam)
        assert got.dtype == torch.float32 and got.shape == (H, W)
        assert agreement(got.numpy(), want) >= 0.995
        q = disp_stats(got.numpy(), gt, D + 8)
        assert q["invalid_frac"] < 0.2 and q["median_err_px"] < 1.0, q


def test_multiview_stereo_resumes_from_the_jax_state():
    """After the JAX package's first added view the port takes its (n, s, img_v,
    T_wv) and adds the second: the same accumulator and disparity."""
    W, H, D = SIZES[0]
    jm, tm, track, _ = multiview(W, H, D, seed=6, stereo_seed=True)
    jm.add(jnp.asarray(track[0][0]), jnp.asarray(track[0][1]))
    resumed = tst.state_from_numpy(tst.MultiViewStereo(tm.K, tm.baseline, tm.cfg), jm.n, jm.s,
                                   jm.img_v, jm.T_wv, device="cpu")
    assert resumed.n.device.type == "cpu" and resumed.img_v.dtype == torch.float32
    jm.add(jnp.asarray(track[1][0]), jnp.asarray(track[1][1]))
    resumed.add(t(track[1][0]), t(track[1][1]))
    check_accumulator(resumed.n, resumed.s, jm.n, jm.s)
    assert agreement(resumed.solve(use_dtam=False).numpy(),
                     np.asarray(jm.solve(use_dtam=False))) >= 0.995


def test_multiview_stereo_add_needs_a_keyframe():
    tm = tst.MultiViewStereo(Intrinsics.centered(100.0, 8, 8), 0.3)
    with pytest.raises(RuntimeError, match="reset"):
        tm.add(torch.zeros(8, 8), tse3.identity(device="cpu"))


# --- coarse_init --------------------------------------------------------------------


# XLA on the CPU sums a 2x2 block of ``box_half`` in an order that depends on
# the shape (the row-major order of the port at 96x64, 160x96 and 640x480,
# pairwise at 128x96), and a last-bit change of the half-size image flips
# census bits; so the second size is 160x96 here
@pytest.mark.parametrize("W,H,D", [(96, 64, 16), (160, 96, 32)])
def test_coarse_init_matches_jax(W, H, D):
    jcfg = jst.StereoConfig(max_disp=D, census_window="9x7", dtam_iterations=30,
                            coarse_init=True, coarse_iterations=30)
    cfg = tst.StereoConfig.from_dict(dataclasses.asdict(jcfg))
    left, right, gt = jsyn.stereo_pair(W, H, D, seed=7)
    want = np.asarray(jst.stereo_pipeline(left, right, jcfg))
    got = tst.stereo_pipeline(t(left), t(right), cfg)
    assert got.dtype == torch.float32 and got.shape == (H, W)
    assert agreement(got.numpy(), want) >= 0.995
    q, q_jax = disp_stats(got.numpy(), gt, D + 8), disp_stats(want, gt, D + 8)
    for k in q:
        assert abs(q[k] - q_jax[k]) <= 1e-3, (q, q_jax)


def test_coarse_init_warm_starts_the_fine_solve(monkeypatch):
    """The fine solve starts from twice the upsampled coarse disparity."""
    seen = []
    solve = tst.dtam_solve

    def recording(vol, img, *args, **kwargs):
        seen.append((tuple(vol.shape), kwargs.get("d_init")))
        return solve(vol, img, *args, **kwargs)

    monkeypatch.setattr(tst, "dtam_solve", recording)
    left, right, _ = tsyn.stereo_pair(48, 16, 8, seed=0, device="cpu")
    cfg = tst.StereoConfig(max_disp=16, census_window="9x7", dtam_iterations=2,
                           coarse_init=True, coarse_iterations=3)
    tst.stereo_pipeline(left, right, cfg)
    assert [s for s, _ in seen] == [(8, 8, 24), (16, 16, 48)]
    assert seen[0][1] is None and seen[1][1].shape == (16, 48)


# --- files ----------------------------------------------------------------------------


@pytest.mark.parametrize("frame,timestamp,grey_dtype", [(7, None, np.uint8),
                                                        (0, 1234.5678901234, np.float32)])
def test_export_depthmap_files_match_jax(tmp_path, frame, timestamp, grey_dtype):
    rng = np.random.default_rng(8)
    disp = rng.uniform(-1, 16, (23, 37)).astype(np.float32)
    grey = (rng.random((23, 37)) * 300).astype(grey_dtype)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jst.export_depthmap(str(tmp_path / "jax"), jnp.asarray(disp), jnp.asarray(grey), 100.0,
                               0.3, frame=frame, timestamp=timestamp)
    got = tst.export_depthmap(str(tmp_path / "port"), t(disp), t(grey), 100.0, 0.3, frame=frame,
                              timestamp=timestamp)
    for g, w in zip(got, want):
        assert g.rsplit("/", 1)[1] == w.rsplit("/", 1)[1]
        assert open(g, "rb").read() == open(w, "rb").read()
    np.testing.assert_array_equal(tpxm.load_pdm(got[0]), jpxm.load_pdm(want[0]))


def test_pxm_files_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    cases = {"g.pgm": (rng.random((5, 7)) * 255).astype(np.uint8),
             "c.ppm.gz": (rng.random((5, 7, 3)) * 255).astype(np.uint8),
             "w.pgm": (rng.random((5, 7)) * 60000).astype(np.uint16),
             "f.pgm": rng.random((5, 7)).astype(np.float32)}
    # one name in two folders: a gzip header holds the file's name
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    for name, img in cases.items():
        tpxm.save_pxm(str(tmp_path / "t" / name), img)
        jpxm.save_pxm(str(tmp_path / "j" / name), img)
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
        dtype = np.float32 if img.dtype == np.float32 else None
        np.testing.assert_array_equal(tpxm.load_pxm(str(tmp_path / "j" / name), dtype), img)
    vol = rng.random((3, 5, 7)).astype(np.float32)
    tpxm.save_volume(str(tmp_path / "t" / "v.pgm"), vol)
    jpxm.save_volume(str(tmp_path / "j" / "v.pgm"), vol)
    assert (tmp_path / "t" / "v.pgm").read_bytes() == (tmp_path / "j" / "v.pgm").read_bytes()
    np.testing.assert_array_equal(tpxm.load_volume(str(tmp_path / "j" / "v.pgm")), vol)


def test_tsdf_files_match_jax(tmp_path):
    rng = np.random.default_rng(10)
    val, wgt = (rng.random((3, 5, 7)).astype(np.float32) for _ in range(2))
    lo, hi = np.array([-1.0, -0.5, 0.0], np.float32), np.array([1.0, 0.5, 2.0], np.float32)
    tvol = TsdfVolume(t(val), t(wgt), BoundingBox.create(lo, hi, device="cpu"))
    jvol = kt.TsdfVolume(jnp.asarray(val), jnp.asarray(wgt), kt.BoundingBox.create(lo, hi))
    tpxm.save_tsdf(str(tmp_path / "t.vol"), tvol)
    jpxm.save_tsdf(str(tmp_path / "j.vol"), jvol)
    assert (tmp_path / "t.vol").read_bytes() == (tmp_path / "j.vol").read_bytes()
    back = tpxm.load_tsdf(str(tmp_path / "j.vol"), device="cpu")
    for got, want in ((back.val, val), (back.weight, wgt), (back.bbox.lo, lo), (back.bbox.hi, hi)):
        np.testing.assert_array_equal(got.numpy(), want)


def jax_reference_quality(w=640, h=480, max_disp=64):
    """The JAX package's quality at ``w``x``h``/``max_disp``: MultiViewStereo
    on multiview_track(w, h, max_disp) (focal 0.9 w, baseline 0.1, seeded
    from the keyframe and the f = 1 view, the 3 views added; DTAM 50
    iterations and WTA), and the coarse_init cold frame (16x16 census, 50
    fine and 50 coarse iterations) on stereo_pair(w, h, max_disp, seed=0)."""
    key, gt, track = jsyn.multiview_track(w, h, max_disp, seed=0)
    K = kt.Intrinsics.centered(0.9 * w, w, h)
    cfg = jst.StereoConfig(max_disp=max_disp, dtam_iterations=50)
    mvs = jst.MultiViewStereo(K, 0.1, cfg)
    mvs.reset(key.astype(jnp.float32), jse3.identity(), right=track[-1][0].astype(jnp.float32))
    for img, T_wc in track:
        mvs.add(img.astype(jnp.float32), T_wc)
    out = {f"multiview_{name}": disp_stats(mvs.solve(use_dtam=use_dtam), gt, max_disp + 8)
           for name, use_dtam in (("dtam50", True), ("wta", False))}
    left, right, gt = jsyn.stereo_pair(w, h, max_disp, seed=0)
    ccfg = jst.StereoConfig(max_disp=max_disp, census_window="16x16", dtam_iterations=50,
                            coarse_init=True)
    out["coarse50"] = disp_stats(jst.stereo_pipeline(left, right, ccfg), gt, max_disp + 8)
    return out


if __name__ == "__main__":
    import json

    print(json.dumps(jax_reference_quality(*map(int, sys.argv[1:]))))
