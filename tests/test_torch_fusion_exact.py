"""The exact and guided engines' fusion and raycasting:
kangaroo_tpu_torch.fusion.sdf and .raycast against kangaroo_tpu's on
tests/test_separable.py's scene (64x48 depth of a sphere, a (D, H, W) =
(44, 40, 48) volume), and against tests/reference_impl.py's scalar loops.

Tolerances. The fuses: val 1e-5 and weight 1e-4 where both packages
updated, voxels updated on one side only counted and held to 0.2 % of the
updated ones (0 measured), untouched voxels bit-equal
(test_torch_separable.compare_fused); the colour volume 1e-5 where both
updated. Against the voxel loop, test_fusion.py's own rtol 1e-4 and atol
1e-5. The raycasts: NaN masks equal but for at most 0.5 % of pixels, depth
within 1e-4, normals and images within 1e-3 elsewhere; against the pixel
loop test_fusion.py's own (2 % of the masks, 2e-3). The analytic raycasts
within 1e-5 (depth) and 1e-4 (shading).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
import reference_impl as ref
from kangaroo_tpu.core import se3 as jse3
from kangaroo_tpu.fusion import raycast as jrc
from kangaroo_tpu.fusion import sdf as jsdf
from kangaroo_tpu.geometry import depth as jdepth
from kangaroo_tpu_torch.containers import BoundedVolume
from kangaroo_tpu_torch.fusion import raycast as trc
from kangaroo_tpu_torch.fusion import sdf as tsdf
from kangaroo_tpu_torch.fusion import separable_cuda
from test_separable import POSES, _scene
from test_torch_separable import (_compare_images, colour_inputs, compare_fused, port_bbox,
                                  port_K, port_vol, t)

TRUNC, MAX_W, MINCOS = 0.15, 1000.0, 0.1
COLOUR_TOL = 1e-5


@pytest.mark.parametrize("sample", ["bilinear", "nearest"])
@pytest.mark.parametrize("angles", POSES)
def test_sdf_fuse_matches_jax(angles, sample):
    K, vol, T_wc, gt, norm, W, H = _scene(angles)
    T_cw = jse3.inverse(T_wc)
    v1 = jsdf.sdf_fuse(vol, gt, norm, T_cw, K, TRUNC, MAX_W, MINCOS, sample=sample)
    v2 = jsdf.sdf_fuse(v1, gt, norm, T_cw, K, TRUNC, MAX_W, MINCOS, sample=sample)
    pv = port_vol(vol)
    g1 = tsdf.sdf_fuse(pv, t(gt), t(norm), t(T_cw), port_K(K), TRUNC, MAX_W, MINCOS,
                       sample=sample)
    g2 = tsdf.sdf_fuse(g1, t(gt), t(norm), t(T_cw), port_K(K), TRUNC, MAX_W, MINCOS,
                       sample=sample)
    assert int((np.asarray(v1.weight) > 0).sum()) > 1000
    compare_fused(g1.val, g1.weight, v1.val, v1.weight)
    compare_fused(g2.val, g2.weight, v2.val, v2.weight)
    assert float(pv.weight.max()) == 0.0  # value semantics


def test_sdf_fuse_slabs_equal_one_slab(monkeypatch):
    """The fuse's slabs of planes give the same bits as one slab."""
    K, vol, T_wc, gt, norm, W, H = _scene(POSES[1])
    args = (t(gt), t(norm), t(jse3.inverse(T_wc)), port_K(K), TRUNC, MAX_W, MINCOS)
    monkeypatch.setattr(tsdf, "_SLAB_VOXELS", 1)  # one plane a slab
    a = tsdf.sdf_fuse(port_vol(vol), *args)
    monkeypatch.setattr(tsdf, "_SLAB_VOXELS", 1 << 30)
    b = tsdf.sdf_fuse(port_vol(vol), *args)
    assert torch.equal(a.weight, b.weight)
    assert torch.equal(a.val.nan_to_num(7.0), b.val.nan_to_num(7.0))


def test_sdf_fuse_matches_voxel_loop():
    """tests/test_fusion.py's golden case: a partial prior state, max_w 6."""
    res, w, h = 12, 24, 18
    K = kt.Intrinsics.centered(20.0, w, h)
    T_wc = jse3.make(np.eye(3), [0.05, -0.04, -3.0])
    T_cw = np.asarray(jse3.inverse(T_wc))
    bbox = kt.BoundingBox.create((-1.2, -1.2, -1.2), (1.2, 1.2, 1.2))
    trunc = 0.3
    rng = np.random.default_rng(3)
    w0 = ((rng.random((res,) * 3) < 0.5) * rng.random((res,) * 3) * 4.0).astype(np.float32)
    v0 = (rng.standard_normal((res,) * 3) * 0.1).astype(np.float32)
    depth, _ = jrc.raycast_sphere(jnp.full((h, w), jnp.nan), T_wc, K, (0.0, 0.0, 0.0), 0.9, w, h)
    norm = jdepth.normals_from_vbo(jdepth.depth_to_vbo(depth, K))
    got = tsdf.sdf_fuse(port_vol(kt.TsdfVolume(jnp.asarray(v0), jnp.asarray(w0), bbox)),
                        t(depth), t(norm), t(T_cw), port_K(K), trunc, 6.0, 0.1)
    want_v, want_w = ref.sdf_fuse(
        v0.astype(np.float64), w0.astype(np.float64), np.asarray(bbox.lo), np.asarray(bbox.hi),
        np.asarray(depth, np.float64), np.asarray(norm, np.float64), T_cw.astype(np.float64),
        (float(K.fu), float(K.fv), float(K.u0), float(K.v0)), trunc, max_w=6.0, mincostheta=0.1)
    np.testing.assert_allclose(got.weight.numpy(), want_w, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.val.numpy(), want_v, rtol=1e-4, atol=1e-5)


def test_sdf_fuse_color_matches_jax():
    K, vol, T_wc, gt, norm, W, H = _scene(POSES[2])
    T_cw = jse3.inverse(T_wc)
    cvol, rgb, T_iw = colour_inputs(vol, T_cw, W, H)
    want_v, want_c = jsdf.sdf_fuse_color(vol, cvol, gt, norm, T_cw, K, jnp.asarray(rgb), T_iw, K,
                                         TRUNC, MAX_W, MINCOS)
    want_v, want_c = jsdf.sdf_fuse_color(want_v, want_c, gt, norm, T_cw, K, jnp.asarray(rgb),
                                         T_iw, K, TRUNC, MAX_W, MINCOS)
    pc = BoundedVolume(t(cvol.data), port_bbox(cvol.bbox))
    args = (t(gt), t(norm), t(T_cw), port_K(K), torch.from_numpy(rgb), t(T_iw), port_K(K),
            TRUNC, MAX_W, MINCOS)
    got_v, got_c = tsdf.sdf_fuse_color(port_vol(vol), pc, *args)
    got_v, got_c = tsdf.sdf_fuse_color(got_v, got_c, *args)
    compare_fused(got_v.val, got_v.weight, want_v.val, want_v.weight)
    gw, ww = got_v.weight.numpy(), np.asarray(want_v.weight)
    both = (gw > 0) & (ww > 0)
    gc, wc = got_c.data.numpy(), np.asarray(want_c.data)
    np.testing.assert_allclose(gc[both], wc[both], atol=COLOUR_TOL, rtol=0)
    np.testing.assert_array_equal(gc[(gw == 0) & (ww == 0)], 0.5)
    # the texture is not flat: the blended grey spreads over the surface
    assert np.ptp(gc[both]) > 0.3
    assert float(pc.data.min()) == float(pc.data.max()) == 0.5  # value semantics


def test_sphere_distance_and_reset_match_jax():
    K, vol, T_wc, gt, norm, W, H = _scene()
    want = jsdf.sdf_sphere(vol, (0.1, -0.05, 0.0), 0.8)
    got = tsdf.sdf_sphere(port_vol(vol), (0.1, -0.05, 0.0), 0.8)
    np.testing.assert_allclose(got.val.numpy(), np.asarray(want.val), atol=1e-6, rtol=0)
    assert torch.equal(got.weight, torch.ones_like(got.weight))
    depth = jnp.where(jnp.isfinite(gt), gt, 2.1)
    want_d = jsdf.sdf_distance(depth, want, T_wc, K)
    got_d = tsdf.sdf_distance(t(depth), got, t(T_wc), port_K(K))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5, rtol=0)
    reset = tsdf.sdf_reset(got, 0.25)
    assert float(reset.val.min()) == float(reset.val.max()) == 0.25
    assert float(reset.weight.abs().max()) == 0.0


@functools.lru_cache(maxsize=None)
def _fused(angles):
    """The scene's volume after two exact fuses (and its colour volume)."""
    K, vol, T_wc, gt, norm, W, H = _scene(angles)
    T_cw = jse3.inverse(T_wc)
    cvol, rgb, T_iw = colour_inputs(vol, T_cw, W, H)
    for _ in range(2):
        vol, cvol = jsdf.sdf_fuse_color(vol, cvol, gt, norm, T_cw, K, jnp.asarray(rgb), T_iw, K,
                                        TRUNC, MAX_W, MINCOS)
    return K, vol, cvol, T_wc, W, H


def _compare_raycasts(got, want, img_tol=1e-3):
    _compare_images(got[0], want[0], 1e-4)
    hit = np.isfinite(np.asarray(want[0])) & np.isfinite(got[0].numpy())
    assert hit.sum() > 300
    np.testing.assert_allclose(got[1].numpy()[hit], np.asarray(want[1])[hit], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[2].numpy()[hit], np.asarray(want[2])[hit], atol=img_tol,
                               rtol=0)


RAYCAST_OPTIONS = {
    "trilinear": {},
    "no subpix": dict(subpix=False),
    "nearest": dict(march_sample="nearest"),
    "nearest skip 4": dict(march_sample="nearest", skip_unobserved=4.0),
    "trilinear skip ignored": dict(skip_unobserved=4.0),
    "max_steps 40": dict(max_steps=40),
}


@pytest.mark.parametrize("option", list(RAYCAST_OPTIONS))
def test_raycast_options_match_jax(option):
    K, vol, cvol, T_wc, W, H = _fused(POSES[1])
    kw = RAYCAST_OPTIONS[option]
    want = jrc.raycast_sdf(vol, T_wc, K, W, H, near=0.5, far=8.0, **kw)
    got = trc.raycast_sdf(port_vol(vol), t(T_wc), port_K(K), W, H, 0.5, 8.0, **kw)
    _compare_raycasts(got, want)


def test_raycast_colour_volume_matches_jax():
    K, vol, cvol, T_wc, W, H = _fused(POSES[2])
    want = jrc.raycast_sdf(vol, T_wc, K, W, H, near=0.5, far=8.0, color_vol=cvol)
    got = trc.raycast_sdf(port_vol(vol), t(T_wc), port_K(K), W, H, 0.5, 8.0,
                          color_vol=BoundedVolume(t(cvol.data), port_bbox(cvol.bbox)))
    _compare_raycasts(got, want, img_tol=COLOUR_TOL * 10)
    img = got[2].numpy()[np.isfinite(got[0].numpy())]
    assert np.ptp(img) > 0.1  # the colour volume, not Phong shading


def test_raycast_warm_start_matches_jax():
    """lam_init/done_init: rays start 5 cm in front of the true depth, a
    block of rays is marked done, and the march stops at 12 steps."""
    K, vol, cvol, T_wc, W, H = _fused(POSES[0])
    d_full, _, _ = jrc.raycast_sdf(vol, T_wc, K, W, H, near=0.5, far=8.0)
    lam = jnp.where(jnp.isfinite(d_full), d_full - 0.05, 0.0)
    done = jnp.zeros((H, W), bool).at[10:20, 20:30].set(True)
    kw = dict(max_steps=12, march_sample="nearest", skip_unobserved=4.0)
    want = jrc.raycast_sdf(vol, T_wc, K, W, H, near=0.5, far=8.0, lam_init=lam, done_init=done,
                           **kw)
    got = trc.raycast_sdf(port_vol(vol), t(T_wc), port_K(K), W, H, 0.5, 8.0, lam_init=t(lam),
                          done_init=torch.from_numpy(np.array(done)), **kw)
    _compare_raycasts(got, want)
    assert not torch.isfinite(got[0][10:20, 20:30]).any()
    # without done_init every ray marches from lam_init
    want = jrc.raycast_sdf(vol, T_wc, K, W, H, near=0.5, far=8.0, lam_init=lam, **kw)
    got = trc.raycast_sdf(port_vol(vol), t(T_wc), port_K(K), W, H, 0.5, 8.0, lam_init=t(lam),
                          **kw)
    _compare_raycasts(got, want)


def test_raycast_matches_pixel_loop():
    """tests/test_fusion.py's golden case: an analytic sphere TSDF."""
    res, w, h = 24, 20, 16
    K = kt.Intrinsics.centered(18.0, w, h)
    T_wc = jse3.make(np.eye(3), [0.0, 0.0, -3.0])
    bbox = kt.BoundingBox.create((-1.2, -1.2, -1.2), (1.2, 1.2, 1.2))
    vol = tsdf.sdf_sphere(port_vol(kt.TsdfVolume.create(res, res, res, bbox, trunc_dist=0.2)),
                          (0.1, -0.05, 0.0), 0.8)
    got = trc.raycast_sdf(vol, t(T_wc), port_K(K), w, h, 0.5, 8.0, subpix=True)[0].numpy()
    want = ref.raycast_sdf_depth(vol.val.numpy().astype(np.float64), np.asarray(bbox.lo),
                                 np.asarray(bbox.hi), np.asarray(T_wc, np.float64),
                                 (float(K.fu), float(K.fv), float(K.u0), float(K.v0)), w, h,
                                 near=0.5, far=8.0, subpix=True)
    hit_g, hit_w = np.isfinite(got), np.isfinite(want)
    assert (hit_g != hit_w).mean() <= 0.02
    both = hit_g & hit_w
    assert both.sum() >= 60
    np.testing.assert_allclose(got[both], want[both], atol=2e-3)


@pytest.mark.parametrize("colour", [False, True])
@pytest.mark.parametrize("angles", POSES[:2])
def test_raycast_guided_matches_jax(angles, colour):
    K, vol, cvol, T_wc, W, H = _fused(angles)
    want = jrc.raycast_sdf_guided(vol, T_wc, K, W, H, near=0.5, far=8.0, trunc_dist=TRUNC,
                                  color_vol=cvol if colour else None)
    got = trc.raycast_sdf_guided(
        port_vol(vol), t(T_wc), port_K(K), W, H, 0.5, 8.0, trunc_dist=TRUNC,
        color_vol=BoundedVolume(t(cvol.data), port_bbox(cvol.bbox)) if colour else None)
    _compare_raycasts(got, want, img_tol=1e-4 if colour else 1e-3)


def test_raycast_guided_coarse_factor_and_trilinear_match_jax():
    K, vol, cvol, T_wc, W, H = _fused(POSES[2])
    kw = dict(coarse_factor=2, fine_steps=16, march_sample="trilinear", skip_unobserved=0.0)
    want = jrc.raycast_sdf_guided(vol, T_wc, K, W, H, near=0.5, far=8.0, **kw)
    got = trc.raycast_sdf_guided(port_vol(vol), t(T_wc), port_K(K), W, H, 0.5, 8.0, **kw)
    _compare_raycasts(got, want)


@pytest.mark.parametrize("f", [2, 3, 4])
def test_intrinsics_scale_matches_jax(f):
    K = kt.Intrinsics.centered(55.0, 64, 48)
    want = jrc.Intrinsics_scale(K, f)
    got = trc.Intrinsics_scale(port_K(K), f)
    for name in ("fu", "fv", "u0", "v0"):
        assert getattr(got, name) == float(np.float32(getattr(want, name))), name


def test_analytic_raycasts_match_jax():
    K, vol, T_wc, gt, norm, W, H = _scene(POSES[1])
    bbox = kt.BoundingBox.create((-1.0, -0.8, -1.1), (0.9, 1.0, 1.2))
    np.testing.assert_allclose(trc.raycast_box(port_bbox(bbox), t(T_wc), port_K(K), W, H).numpy(),
                               np.asarray(jrc.raycast_box(bbox, T_wc, K, W, H)), atol=1e-5,
                               rtol=0)
    prev = jnp.full((H, W), jnp.nan).at[:, : W // 2].set(2.5)
    want_d, want_img = jrc.raycast_sphere(prev, T_wc, K, (0.1, 0.0, 0.2), 0.9, W, H)
    got_d, got_img = trc.raycast_sphere(t(prev), t(T_wc), port_K(K), (0.1, 0.0, 0.2), 0.9, W, H)
    _compare_images(got_d, want_d, 1e-5, max_nan_share=0.0)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-4, rtol=0)
    assert trc.raycast_sphere(t(prev), t(T_wc), port_K(K), (0.1, 0.0, 0.2), 0.9, W, H,
                              shade=False)[1] is None
    want_d, want_img = jrc.raycast_plane(want_d, T_wc, K, (0.0, 0.0, -0.5), W, H)
    got_d, got_img = trc.raycast_plane(got_d, t(T_wc), port_K(K), (0.0, 0.0, -0.5), W, H)
    _compare_images(got_d, want_d, 1e-5, max_nan_share=0.0)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-4, rtol=0)


def test_cpu_engines_launch_no_kernel():
    K, vol, cvol, T_wc, W, H = _fused(POSES[0])
    before = separable_cuda.launches
    pv = port_vol(vol)
    tsdf.sdf_fuse(pv, torch.full((H, W), 3.0), torch.zeros(H, W, 4), t(jse3.inverse(T_wc)),
                  port_K(K), TRUNC)
    trc.raycast_sdf_guided(pv, t(T_wc), port_K(K), W, H, 0.5, 8.0)
    assert separable_cuda.launches == before
