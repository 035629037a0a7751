"""The plane-sweep engine: kangaroo_tpu_torch.fusion.separable against
kangaroo_tpu's on tests/test_separable.py's scene (64x48 depth of a sphere,
a (D, H, W) = (44, 40, 48) volume), and the exact sphere trace.

Tolerances. The fuse: val 1e-5 and weight 1e-4 where both packages
updated (tests/test_separable.py's own for the Pallas kernel against the
scan); the update gates (sd > -trunc, ct > mincos, the window and image
tests) and the nearest-neighbour warp can flip on one ulp of the geometry,
so voxels updated on one side only are counted and held to a share of the
updated ones (0 expected when both get the same geometry). The raycasts:
NaN masks equal but for at most 0.5 % of pixels, depth within 1e-4 and
normals within 1e-3 elsewhere (the normals are forward differences of the
depth, which amplify its last bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.containers.volume import BoundedVolume as JBoundedVolume
from kangaroo_tpu.core import se3 as jse3
from kangaroo_tpu.fusion import raycast as jrc
from kangaroo_tpu.fusion import sdf as jsdf
from kangaroo_tpu.fusion import separable as jsep
from kangaroo_tpu.fusion import separable_pallas as jsp
from kangaroo_tpu_torch.apps import synthetic as tsyn
from kangaroo_tpu_torch.containers import BoundedVolume, BoundingBox, Intrinsics, TsdfVolume
from kangaroo_tpu_torch.core import se3 as tse3
from kangaroo_tpu_torch.fusion import raycast as trc
from kangaroo_tpu_torch.fusion import separable as tsep
from kangaroo_tpu_torch.fusion import separable_cuda
from test_separable import POSES, _rot, _scene

# poses whose view is most parallel to world y and x: the fuse and raycast
# sweep axes 1 and 2 ('auto')
POSE_Y, POSE_X = (1.4, 0.0, 0.2), (0.0, 1.45, 0.0)
ALL_POSES = POSES + [POSE_Y, POSE_X]
TRUNC, MAX_W, MINCOS = 0.15, 1000.0, 0.1
VAL_TOL, W_TOL = 1e-5, 1e-4
MAX_FLIP_SHARE = 0.002


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def port_K(K) -> Intrinsics:
    return Intrinsics.create(float(K.fu), float(K.fv), float(K.u0), float(K.v0))


def port_bbox(bbox) -> BoundingBox:
    return BoundingBox.create(np.asarray(bbox.lo), np.asarray(bbox.hi), device="cpu")


def port_vol(vol) -> TsdfVolume:
    return TsdfVolume(t(vol.val), t(vol.weight), port_bbox(vol.bbox))


def compare_fused(got_val, got_w, want_val, want_w, max_flip_share=MAX_FLIP_SHARE):
    """Values where both updated within the tolerances; one-sided updates
    counted and bounded; untouched voxels bit-equal."""
    gv, gw = np.asarray(got_val), np.asarray(got_w)
    wv, ww = np.asarray(want_val), np.asarray(want_w)
    gu, wu = gw > 0, ww > 0
    flips = int((gu != wu).sum())
    assert flips <= max_flip_share * max(int(wu.sum()), 1), (flips, int(wu.sum()))
    both = gu & wu
    np.testing.assert_allclose(gv[both], wv[both], atol=VAL_TOL, rtol=0)
    np.testing.assert_allclose(gw[both], ww[both], atol=W_TOL, rtol=0)
    neither = ~gu & ~wu
    np.testing.assert_array_equal(gv[neither], wv[neither])
    return flips


def _axis(angles):
    _, _, T_wc, *_ = _scene(angles)
    return int(jsep._view_axis_index(jse3.inverse(T_wc)))


def test_poses_cover_every_sweep_axis():
    assert sorted({_axis(a) for a in ALL_POSES}) == [0, 1, 2]
    assert (_axis(POSE_Y), _axis(POSE_X)) == (1, 2)
    _, _, T_wc, *_ = _scene(POSE_X)
    assert tsep._view_axis_index(tse3.inverse(t(T_wc))) == 2


@pytest.mark.parametrize("clip_planes", [True, False])
@pytest.mark.parametrize("angles", ALL_POSES)
def test_fuse_matches_xla_scan(angles, clip_planes):
    K, vol, T_wc, gt, norm, W, H = _scene(angles)
    T_cw = jse3.inverse(T_wc)
    # an empty volume, then one that already holds a fused frame
    v1 = jsep.sdf_fuse_separable(vol, gt, norm, T_cw, K, TRUNC, MAX_W, MINCOS,
                                 clip_planes=clip_planes)
    v2 = jsep.sdf_fuse_separable(v1, gt, norm, T_cw, K, TRUNC, MAX_W, MINCOS,
                                 clip_planes=clip_planes)
    pv = port_vol(vol)
    g1 = tsep.sdf_fuse_separable(pv, t(gt), t(norm), t(T_cw), port_K(K), TRUNC, MAX_W, MINCOS,
                                 clip_planes=clip_planes)
    g2 = tsep.sdf_fuse_separable(g1, t(gt), t(norm), t(T_cw), port_K(K), TRUNC, MAX_W, MINCOS,
                                 clip_planes=clip_planes)
    assert int((np.asarray(v1.weight) > 0).sum()) > 1000
    compare_fused(g1.val, g1.weight, v1.val, v1.weight)
    compare_fused(g2.val, g2.weight, v2.val, v2.weight)
    # value semantics: the input volume is untouched
    assert float(pv.weight.max()) == 0.0


def test_fuse_bilinear_warp_matches_xla_scan():
    K, vol, T_wc, gt, norm, W, H = _scene(POSES[2])
    T_cw = jse3.inverse(T_wc)
    want = jsep.sdf_fuse_separable(vol, gt, norm, T_cw, K, TRUNC, MAX_W, MINCOS, warp="bilinear")
    got = tsep.sdf_fuse_separable(port_vol(vol), t(gt), t(norm), t(T_cw), port_K(K), TRUNC,
                                  MAX_W, MINCOS, warp="bilinear")
    compare_fused(got.val, got.weight, want.val, want.weight)


@pytest.mark.parametrize("angles", [POSES[0], POSE_Y, POSE_X])
def test_fuse_near_far_crop_matches_xla_scan(angles):
    K, vol, T_wc, gt, norm, W, H = _scene(angles)
    T_cw = jse3.inverse(T_wc)
    far = float(np.nanmedian(np.asarray(gt)))  # crops part of the surface
    want = jsep.sdf_fuse_separable(vol, gt, norm, T_cw, K, TRUNC, MAX_W, MINCOS, near=2.2,
                                   far=far)
    got = tsep.sdf_fuse_separable(port_vol(vol), t(gt), t(norm), t(T_cw), port_K(K), TRUNC,
                                  MAX_W, MINCOS, near=2.2, far=far)
    full = jsep.sdf_fuse_separable(vol, gt, norm, T_cw, K, TRUNC, MAX_W, MINCOS)
    assert not np.array_equal(np.asarray(want.weight), np.asarray(full.weight))
    compare_fused(got.val, got.weight, want.val, want.weight)


def _jax_fuse_inputs(vol, depth, normals, T_cw, K, axis, near=None, far=None):
    """The JAX package's own geometry for the plane loop: its SweepGeom's
    params, warped grids and plane window (_sdf_fuse_axis's first half)."""
    order = jsep._ORDER[axis]
    Hi, Wi = depth.shape
    D, Hv, Wv = vol.val.transpose(jsep._PERM[axis]).shape
    geom = jsep.make_sweep_geom(vol, T_cw, K, Wi, Hi, Wi, Hi, order=order)
    s, tt = jsep._grid_st(geom, Wi, Hi)
    u, v = jsep._grid_uv(geom, s, tt)
    ray = jnp.asarray(K.unproject_grid(Wi, Hi))
    ct_img = jnp.sum(normals[..., :3] * ray, axis=-1) / -jnp.linalg.norm(ray, axis=-1)
    valid = jnp.isfinite(depth) & jnp.isfinite(ct_img)
    packed = jnp.stack([jnp.where(valid, depth, -1e6), jnp.where(valid, ct_img, 0.0)], -1)
    ok = (u >= 0) & (u < Wi) & (v >= 0) & (v < Hi) & jnp.isfinite(u) & jnp.isfinite(v)
    ui = jnp.clip(jnp.floor(jnp.where(ok, u, 0.0) + 0.5), 0, Wi - 1).astype(jnp.int32)
    vi = jnp.clip(jnp.floor(jnp.where(ok, v, 0.0) + 0.5), 0, Hi - 1).astype(jnp.int32)
    G = jnp.where(ok[..., None], packed[vi, ui], jnp.array([-1e6, 0.0]))
    params = np.concatenate([np.asarray(geom.A).reshape(-1), np.asarray(geom.g),
                             np.asarray([geom.s_lo, geom.ds, geom.t_lo, geom.dt]),
                             [TRUNC, MAX_W, MINCOS, 1.0]]).astype(np.float32)
    visible = np.asarray(jsep.fuse_plane_window(vol, depth, normals, T_cw, K, TRUNC, MINCOS,
                                                sweep_axis=axis, near=near, far=far))
    P = tsep.batch_size(D)
    k = np.nonzero(visible)[0]
    window = [k.min() // P * P, (k.max() // P + 1) * P] if k.size else [0, 0]
    return (t(G[..., 0]).contiguous(), t(G[..., 1]).contiguous(), t(params),
            torch.tensor(window, dtype=torch.int32))


@pytest.mark.parametrize("near_far", [(None, None), (2.2, 2.9)])
@pytest.mark.parametrize("angles", [POSES[1], POSE_Y, POSE_X])
def test_plane_loop_given_the_jax_geometry(angles, near_far):
    """The port's plane loop fed the JAX package's own geometry, grids and
    window: no ulp of geometry apart, so no voxel flips."""
    K, vol, T_wc, gt, norm, W, H = _scene(angles)
    T_cw = jse3.inverse(T_wc)
    axis = _axis(angles)
    v1 = jsep.sdf_fuse_separable(vol, gt, norm, T_cw, K, TRUNC, MAX_W, MINCOS)
    want = jsep.sdf_fuse_separable(v1, gt, norm, T_cw, K, TRUNC, MAX_W, MINCOS,
                                   near=near_far[0], far=near_far[1])
    gmd, gct, params, window = _jax_fuse_inputs(v1, gt, norm, T_cw, K, axis, *near_far)
    val, weight = t(v1.val), t(v1.weight)
    tsep.fuse_planes_plain(val, weight, gmd, gct, params, window, axis, W, H)
    assert compare_fused(val, weight, want.val, want.weight, max_flip_share=0.0) == 0


def test_enable_false_is_an_exact_passthrough():
    K, vol, T_wc, gt, norm, W, H = _scene(POSES[2])
    T_cw = t(jse3.inverse(T_wc))
    v1 = tsep.sdf_fuse_separable(port_vol(vol), t(gt), t(norm), T_cw, port_K(K), TRUNC)
    for enable in (False, torch.tensor(False)):
        out = tsep.sdf_fuse_separable(v1, t(gt), t(norm), T_cw, port_K(K), TRUNC, enable=enable)
        assert torch.equal(out.val.isnan(), v1.val.isnan())
        assert torch.equal(out.val.nan_to_num(7.0), v1.val.nan_to_num(7.0))
        assert torch.equal(out.weight, v1.weight)
    on = tsep.sdf_fuse_separable(v1, t(gt), t(norm), T_cw, port_K(K), TRUNC, enable=True)
    assert not torch.equal(on.weight, v1.weight)


def test_fuse_in_place_updates_the_given_volume():
    K, vol, T_wc, gt, norm, W, H = _scene()
    T_cw = t(jse3.inverse(T_wc))
    a = port_vol(vol)
    copy = tsep.sdf_fuse_separable(a, t(gt), t(norm), T_cw, port_K(K), TRUNC)
    assert float(a.weight.max()) == 0.0
    same = tsep.sdf_fuse_separable(a, t(gt), t(norm), T_cw, port_K(K), TRUNC, inplace=True)
    assert same.val is a.val and same.weight is a.weight
    assert torch.equal(a.weight, copy.weight)


def test_fuse_refuses_inputs_that_require_grad():
    """Under grad the fuse refuses only ``inplace`` (autograd needs the
    volume it fused into); otherwise its gradient with respect to the depth
    is ``jax.grad``'s within 1e-4 of the largest entry (the fuse's reverse
    mode; tests/test_torch_differentiability.py has the other inputs)."""
    K, vol, T_wc, gt, norm, W, H = _scene(POSES[1])
    pv = port_vol(vol)
    T_cw = jse3.inverse(T_wc)
    depth = t(gt).requires_grad_(True)
    with pytest.raises(ValueError, match="inplace"):
        tsep.sdf_fuse_separable(pv, depth, t(norm), t(T_cw), port_K(K), TRUNC, inplace=True)
    out = tsep.sdf_fuse_separable(pv, depth, t(norm), t(T_cw), port_K(K), TRUNC)
    torch.sum(torch.where(out.weight > 0, out.val, 0.0) ** 2).backward()

    def loss(d):
        o = jsep.sdf_fuse_separable(vol, d, norm, T_cw, K, TRUNC, MAX_W, MINCOS)
        return jnp.sum(jnp.where(o.weight > 0, o.val, 0.0) ** 2)

    want = np.asarray(jax.jit(jax.grad(loss))(gt))
    assert float(pv.weight.max()) == 0.0 and np.abs(want).max() > 0
    np.testing.assert_allclose(depth.grad.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_plain_window_and_limit_weight():
    """A fuse of planes outside the window leaves them alone; a weight above
    max_w inside the window is limited even without an update."""
    K, vol, T_wc, gt, norm, W, H = _scene()
    T_cw = t(jse3.inverse(T_wc))
    pv = port_vol(vol)
    pv.weight.fill_(5.0)
    gmd, gct, params, _ = tsep.fuse_inputs(pv, t(gt), t(norm), T_cw, port_K(K), TRUNC, 4.0,
                                           MINCOS, axis=0)
    window = torch.tensor([8, 16], dtype=torch.int32)
    tsep.fuse_planes_plain(pv.val, pv.weight, gmd, gct, params, window, 0, W, H)
    assert torch.equal(pv.weight[:8], torch.full_like(pv.weight[:8], 5.0))
    assert torch.equal(pv.weight[16:], torch.full_like(pv.weight[16:], 5.0))
    assert float(pv.weight[8:16].max()) <= 4.0


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route kangaroo_tpu's fuse through fuse_planes_pallas in interpret
    mode, as tests/test_separable.py does; drop the patched traces after."""
    from jax.experimental import pallas as pl

    from kangaroo_tpu import backend

    real_call = pl.pallas_call
    jax.clear_caches()  # a cached un-patched trace would bypass the patch
    monkeypatch.setenv("KANGAROO_PALLAS_FUSE", "1")
    monkeypatch.setattr(backend, "on_tpu", lambda: True)
    monkeypatch.setattr(jsp.pl, "pallas_call",
                        lambda *a, **k: real_call(*a, interpret=True, **k))
    yield
    jax.clear_caches()


@pytest.mark.parametrize("angles", [POSES[1], POSE_X])
def test_fuse_matches_pallas_kernel(angles, pallas_interpret):
    K, vol, T_wc, gt, norm, W, H = _scene(angles)
    T_cw = jse3.inverse(T_wc)
    v1 = jsep.sdf_fuse_separable(vol, gt, norm, T_cw, K, TRUNC, MAX_W, MINCOS)
    off = jsep.sdf_fuse_separable(v1, gt, norm, T_cw, K, TRUNC, MAX_W, MINCOS,
                                  enable=jnp.asarray(False))
    g1 = tsep.sdf_fuse_separable(port_vol(vol), t(gt), t(norm), t(T_cw), port_K(K), TRUNC, MAX_W,
                                 MINCOS)
    compare_fused(g1.val, g1.weight, v1.val, v1.weight)
    g_off = tsep.sdf_fuse_separable(g1, t(gt), t(norm), t(T_cw), port_K(K), TRUNC, MAX_W, MINCOS,
                                    enable=False)
    compare_fused(g_off.val, g_off.weight, off.val, off.weight)


def _fused_scene(angles):
    K, vol, T_wc, gt, norm, W, H = _scene(angles)
    vol1 = jsdf.sdf_fuse(vol, gt, norm, jse3.inverse(T_wc), K, TRUNC, MAX_W, MINCOS)
    return K, vol1, T_wc, W, H


def _compare_images(got, want, tol, max_nan_share=0.005):
    g, w = np.asarray(got), np.asarray(want)
    gn, wn = np.isnan(g), np.isnan(w)
    assert (gn != wn).mean() <= max_nan_share
    both = ~gn & ~wn
    assert both.any()
    np.testing.assert_allclose(g[both], w[both], atol=tol, rtol=0)


@pytest.mark.parametrize("angles", ALL_POSES)
def test_raycast_pixels_matches_jax(angles):
    K, vol1, T_wc, W, H = _fused_scene(angles)
    want_d, want_n, want_img = jsep.raycast_sdf_separable(vol1, T_wc, K, W, H, near=0.5,
                                                          far=8.0, trunc_dist=TRUNC)
    got_d, got_n, got_img = tsep.raycast_sdf_separable(port_vol(vol1), t(T_wc), port_K(K), W, H,
                                                       0.5, 8.0, trunc_dist=TRUNC)
    assert np.isfinite(np.asarray(want_d)).sum() > 300
    _compare_images(got_d, want_d, 1e-4)
    hit = np.isfinite(np.asarray(want_d)) & np.isfinite(got_d.numpy())
    np.testing.assert_allclose(got_n.numpy()[hit], np.asarray(want_n)[hit], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_img.numpy()[hit], np.asarray(want_img)[hit], atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("angles", ALL_POSES)
def test_raycast_cloud_matches_jax(angles):
    K, vol1, T_wc, W, H = _fused_scene(angles)
    want = jsep.raycast_sdf_separable(vol1, T_wc, K, W, H, near=0.5, far=8.0, trunc_dist=TRUNC,
                                      output="cloud")
    got = tsep.raycast_sdf_separable(port_vol(vol1), t(T_wc), port_K(K), W, H, 0.5, 8.0,
                                     trunc_dist=TRUNC, output="cloud")
    _compare_images(got[0], want[0], 1e-4)
    _compare_images(got[1], want[1], 1e-4)
    _compare_images(got[2], want[2], 1e-3)


@pytest.mark.parametrize("near_far", [(0.5, 8.0), (2.0, 2.6)])
@pytest.mark.parametrize("angles,sweep_axis", [(POSES[1], 0), (POSE_Y, 1), (POSE_X, 2)])
def test_raycast_window_and_fixed_axis(angles, sweep_axis, near_far):
    """A pinned sweep axis and the near/far window: the plane window is
    equal to the full sweep, and both match the JAX package."""
    K, vol1, T_wc, W, H = _fused_scene(angles)
    want, _, _ = jsep.raycast_sdf_separable(vol1, T_wc, K, W, H, *near_far, trunc_dist=TRUNC,
                                            sweep_axis=sweep_axis)
    outs = [tsep.raycast_sdf_separable(port_vol(vol1), t(T_wc), port_K(K), W, H, *near_far,
                                       trunc_dist=TRUNC, sweep_axis=sweep_axis,
                                       clip_planes=clip)[0] for clip in (True, False)]
    assert torch.equal(outs[0].isnan(), outs[1].isnan())
    assert torch.equal(outs[0].nan_to_num(0.0), outs[1].nan_to_num(0.0))
    _compare_images(outs[0], want, 1e-4)


def test_raycast_mixed_orientation_matches_jax():
    """A camera above the fused cap looking down world y, swept along z: the
    z planes' horizon crosses the image, so rays ascend and descend in k and
    both packages run the two-orientation scan. Depth within 5e-4: at this
    grazing view an ulp of the geometry moves a crossing further."""
    K, vol1, T_wc, W, H = _fused_scene(POSES[0])
    T_in = jse3.make(_rot(1.5, 0.0, 0.0), [0.0, 2.0, -0.5])
    geom = jsep.make_sweep_geom(vol1, jse3.inverse(T_in), K, W, H, W, H)
    s, tt = jsep._grid_st(geom, W, H)
    h2 = np.asarray(geom.A[2, 0] * s[None, :] + geom.A[2, 1] * tt[:, None] + geom.A[2, 2])
    asc = float(geom.g[2]) * h2 >= 0
    assert asc.any() and not asc.all()
    for output in ("pixels", "cloud"):
        want = jsep.raycast_sdf_separable(vol1, T_in, K, W, H, 0.1, 8.0, trunc_dist=TRUNC,
                                          sweep_axis=0, output=output)[0]
        got = tsep.raycast_sdf_separable(port_vol(vol1), t(T_in), port_K(K), W, H, 0.1, 8.0,
                                         trunc_dist=TRUNC, sweep_axis=0, output=output)[0]
        assert np.isfinite(np.asarray(want)).sum() > 10
        _compare_images(got, want, 5e-4)


def test_raycast_empty_volume_all_misses():
    K, vol, T_wc, gt, norm, W, H = _scene()
    d, _, _ = tsep.raycast_sdf_separable(port_vol(vol.reset(jnp.nan)), t(T_wc), port_K(K), W, H,
                                         0.5, 8.0, trunc_dist=TRUNC)
    assert not torch.isfinite(d).any()


@pytest.mark.parametrize("angles", [POSES[0], POSES[2], POSE_X])
def test_exact_raycast_matches_jax(angles):
    K, vol1, T_wc, W, H = _fused_scene(angles)
    want = jrc.raycast_sdf(vol1, T_wc, K, W, H, near=0.5, far=8.0)
    got = trc.raycast_sdf(port_vol(vol1), t(T_wc), port_K(K), W, H, 0.5, 8.0)
    _compare_images(got[0], want[0], 1e-4)
    hit = np.isfinite(np.asarray(want[0])) & np.isfinite(got[0].numpy())
    np.testing.assert_allclose(got[1].numpy()[hit], np.asarray(want[1])[hit], atol=1e-3, rtol=0)


@pytest.mark.parametrize("angles", [POSES[0], POSES[2], POSE_Y, POSE_X])
def test_raycast_gradient_normals_match_jax(angles):
    """normals='gradient' (the two-orientation scan over every plane, the
    volume's gradient at the crossing); normals and shading within 1e-3."""
    K, vol1, T_wc, W, H = _fused_scene(angles)
    want = jsep.raycast_sdf_separable(vol1, T_wc, K, W, H, near=0.5, far=8.0, trunc_dist=TRUNC,
                                      normals="gradient")
    got = tsep.raycast_sdf_separable(port_vol(vol1), t(T_wc), port_K(K), W, H, 0.5, 8.0,
                                     trunc_dist=TRUNC, normals="gradient")
    _compare_images(got[0], want[0], 1e-4)
    hit = np.isfinite(np.asarray(want[0])) & np.isfinite(got[0].numpy())
    assert hit.sum() > 300
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy()[hit], np.asarray(w)[hit], atol=1e-3, rtol=0)
    # unit normals facing the camera
    n = got[1].numpy()[hit]
    np.testing.assert_allclose(np.linalg.norm(n[:, :3], axis=-1), 1.0, atol=1e-5)
    assert (n[:, 2] < 0).mean() > 0.95


def test_raycast_options_refused():
    K, vol1, T_wc, W, H = _fused_scene(POSES[0])
    pv = port_vol(vol1)
    with pytest.raises(ValueError, match="normals"):
        tsep.raycast_sdf_separable(pv, t(T_wc), port_K(K), W, H, normals="vbo")
    with pytest.raises(ValueError, match="cloud"):
        tsep.raycast_sdf_separable(pv, t(T_wc), port_K(K), W, H, normals="gradient",
                                   output="cloud")


def colour_inputs(vol, T_cw, W, H, baseline=0.05):
    """A colour volume of 0.5, the seeded rgb texture and a colour camera
    ``baseline`` to the side of the depth camera."""
    cvol = JBoundedVolume.create(*vol.val.shape[::-1], vol.bbox, fill=0.5)
    rgb = tsyn.colour_texture(W, H, device="cpu").numpy()
    T_iw = jse3.compose(jnp.asarray(jse3.inverse(jse3.make(np.eye(3), [baseline, 0.0, 0.0]))),
                        T_cw)
    return cvol, rgb, T_iw


def _compare_colour(got_v, got_c, want_v, want_c):
    compare_fused(got_v.val, got_v.weight, want_v.val, want_v.weight)
    gw, ww = got_v.weight.numpy(), np.asarray(want_v.weight)
    both = (gw > 0) & (ww > 0)
    gc, wc = got_c.data.numpy(), np.asarray(want_c.data)
    np.testing.assert_allclose(gc[both], wc[both], atol=VAL_TOL, rtol=0)
    np.testing.assert_array_equal(gc[~(gw > 0) & ~(ww > 0)], wc[~(gw > 0) & ~(ww > 0)])
    assert np.ptp(gc[both]) > 0.3  # the texture, not a flat grey


@pytest.mark.parametrize("angles", [POSES[1], POSE_Y, POSE_X])
def test_colour_fuse_matches_xla_scan(angles):
    """The colour fuse on each sweep axis, twice (the second blends over the
    first's weights), against the JAX package's."""
    K, vol, T_wc, gt, norm, W, H = _scene(angles)
    T_cw = jse3.inverse(T_wc)
    cvol, rgb, T_iw = colour_inputs(vol, T_cw, W, H)
    want_v, want_c = vol, cvol
    got_v, got_c = port_vol(vol), BoundedVolume(t(cvol.data), port_vol(vol).bbox)
    for _ in range(2):
        want_v, want_c = jsep.sdf_fuse_color_separable(want_v, want_c, gt, norm, T_cw, K,
                                                       jnp.asarray(rgb), T_iw, K, TRUNC, MAX_W,
                                                       MINCOS)
        got_v, got_c = tsep.sdf_fuse_color_separable(got_v, got_c, t(gt), t(norm), t(T_cw),
                                                     port_K(K), torch.from_numpy(rgb), t(T_iw),
                                                     port_K(K), TRUNC, MAX_W, MINCOS)
    assert int((np.asarray(want_v.weight) > 0).sum()) > 1000
    _compare_colour(got_v, got_c, want_v, want_c)


def test_colour_fuse_options_match_xla_scan():
    """A narrower colour camera (its image does not cover the depth
    camera's: the colour gate rejects TSDF updates a depth-only fuse makes),
    the near/far crop, a pinned axis and the enable gate."""
    K, vol, T_wc, gt, norm, W, H = _scene(POSES[2])
    T_cw = jse3.inverse(T_wc)
    cvol, rgb, T_iw = colour_inputs(vol, T_cw, W, H, baseline=0.3)
    K_img = kt.Intrinsics.centered(80.0, W, H)
    kw = dict(near=2.2, far=2.9, sweep_axis=0)
    want_v, want_c = jsep.sdf_fuse_color_separable(vol, cvol, gt, norm, T_cw, K, jnp.asarray(rgb),
                                                   T_iw, K_img, TRUNC, MAX_W, MINCOS, **kw)
    args = (t(gt), t(norm), t(T_cw), port_K(K), torch.from_numpy(rgb), t(T_iw), port_K(K_img),
            TRUNC, MAX_W, MINCOS)
    pv, pc = port_vol(vol), BoundedVolume(t(cvol.data), port_vol(vol).bbox)
    got_v, got_c = tsep.sdf_fuse_color_separable(pv, pc, *args, **kw)
    _compare_colour(got_v, got_c, want_v, want_c)
    depth_only = tsep.sdf_fuse_separable(pv, t(gt), t(norm), t(T_cw), port_K(K), TRUNC, MAX_W,
                                         MINCOS, **kw)
    assert int((depth_only.weight > 0).sum()) > int((got_v.weight > 0).sum()) + 100
    off_v, off_c = tsep.sdf_fuse_color_separable(got_v, got_c, *args, enable=False, **kw)
    assert torch.equal(off_v.weight, got_v.weight) and torch.equal(off_c.data, got_c.data)
    # in place: the given tensors are updated and returned
    same_v, same_c = tsep.sdf_fuse_color_separable(pv, pc, *args, inplace=True, **kw)
    assert same_v.val is pv.val and same_c.data is pc.data
    assert torch.equal(pv.weight, got_v.weight)


@pytest.mark.parametrize("near_far", [(None, None), (2.2, 2.9)])
@pytest.mark.parametrize("angles,axis", [(POSES[1], 0), (POSE_Y, 1), (POSE_X, 2)])
def test_fuse_plane_window_matches_jax(angles, axis, near_far):
    K, vol, T_wc, gt, norm, W, H = _scene(angles)
    T_cw = jse3.inverse(T_wc)
    want = jsep.fuse_plane_window(vol, gt, norm, T_cw, K, TRUNC, MINCOS, sweep_axis=axis,
                                  near=near_far[0], far=near_far[1])
    got = tsep.fuse_plane_window(port_vol(vol), t(gt), t(norm), t(T_cw), port_K(K), TRUNC,
                                 MINCOS, sweep_axis=axis, near=near_far[0], far=near_far[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the crop leaves planes out; without it the sphere spans the volume
    assert 0 < int(got.sum()) <= (got.numel() if near_far[0] is None else got.numel() - 10)
    # the fuse's window is these planes rounded out to batches
    _, _, _, window = tsep.fuse_inputs(port_vol(vol), t(gt), t(norm), t(T_cw), port_K(K), TRUNC,
                                       MAX_W, MINCOS, axis, near=near_far[0], far=near_far[1])
    k = np.nonzero(got.numpy())[0]
    P = tsep.batch_size(got.numel())
    assert window.tolist() == [k.min() // P * P, (k.max() // P + 1) * P]


def test_make_sweep_geom_ignores_from_planes():
    K, vol, T_wc, gt, norm, W, H = _scene(POSES[1])
    args = (port_vol(vol), t(jse3.inverse(T_wc)), port_K(K), W, H, W, H)
    a = tsep.make_sweep_geom(*args, from_planes=False)
    b = tsep.make_sweep_geom(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cpu_fuse_launches_no_kernel():
    K, vol, T_wc, gt, norm, W, H = _scene()
    before = separable_cuda.launches
    tsep.sdf_fuse_separable(port_vol(vol), t(gt), t(norm), t(jse3.inverse(T_wc)), port_K(K),
                            TRUNC)
    assert separable_cuda.launches == before
    with pytest.raises(RuntimeError, match="sm_90"):
        separable_cuda.fuse_planes(torch.zeros(4, 4, 4), torch.zeros(4, 4, 4), torch.zeros(4, 4),
                                   torch.zeros(4, 4), torch.zeros(20),
                                   torch.zeros(2, dtype=torch.int32), 0, 4, 4)
    assert separable_cuda.launches == before
