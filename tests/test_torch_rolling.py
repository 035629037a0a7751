"""The moving workspace and the containers it rolls:
kangaroo_tpu_torch.fusion.rolling, containers.volume (BoundedVolume and the
TsdfVolume block methods), containers.bbox (the BoundingBox methods,
fit_to_frustum), core.reweighting and solvers.lss.LSS against kangaroo_tpu's,
on tests/test_rolling_and_network.py's cases (a 16^3 sphere TSDF in
[-1, 1]^3) and seeded random data.

Tolerances. Rolls, sub-volumes and their write-backs move data and add one
float32 product to the box: exactly equal. Samples, gradients, boxes and
weights are a few float32 operations: within 1e-6 (1e-5 for the gradients,
which divide by the voxel size).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.containers.bbox import fit_to_frustum as jfit
from kangaroo_tpu.core import reweighting as jrw
from kangaroo_tpu.core import se3 as jse3
from kangaroo_tpu.fusion import rolling as jroll
from kangaroo_tpu.fusion import sdf as jsdf
from kangaroo_tpu.solvers.lss import LSS as JLSS
from kangaroo_tpu_torch import BoundedVolume, BoundingBox, fit_to_frustum
from kangaroo_tpu_torch.core import reweighting as trw
from kangaroo_tpu_torch.fusion import rolling as troll
from kangaroo_tpu_torch.fusion import sdf as tsdf
from kangaroo_tpu_torch.solvers.lss import LSS
from test_torch_separable import port_bbox, port_K, port_vol, t


def _jvol():
    bbox = kt.BoundingBox.create((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    return jsdf.sdf_sphere(kt.TsdfVolume.create(16, 16, 16, bbox, trunc_dist=0.2),
                           (0.0, 0.0, 0.0), 0.6)


def _equal_volumes(got, want):
    for a, b in ((got.val, want.val), (got.weight, want.weight)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.bbox.lo.numpy(), np.asarray(want.bbox.lo))
    np.testing.assert_array_equal(got.bbox.hi.numpy(), np.asarray(want.bbox.hi))


@pytest.mark.parametrize("shift", [(3, -2, 4), (5, 0, 0), (0, -7, 0), (-1, 1, -15)])
def test_roll_volume_matches_jax(shift):
    want = jroll.roll_volume(_jvol(), shift)
    got = troll.roll_volume(port_vol(_jvol()), shift)
    _equal_volumes(got, want)
    # world geometry stays put inside both windows
    pts = t([[0.0, 0.0, 0.61], [0.3, 0.1, 0.1], [-0.2, 0.3, 0.2]])
    if max(abs(s) for s in shift) < 6:
        np.testing.assert_allclose(got.sample_trilinear_world(pts).numpy(),
                                   port_vol(_jvol()).sample_trilinear_world(pts).numpy(),
                                   atol=1e-5)


def test_roll_resets_vacated_slabs():
    got = troll.roll_volume(port_vol(_jvol()), (5, 0, 0), reset_val=0.25)
    assert (got.weight[:, :, -5:] == 0).all() and (got.weight[:, :, :-5] > 0).any()
    assert (got.val[:, :, -5:] == 0.25).all()
    assert torch.isnan(troll.roll_volume(port_vol(_jvol()), (5, 0, 0)).val[:, :, -5:]).all()


def test_roll_bounded_volume_follows_tsdf_roll():
    """The colour volume rolls with the TSDF's shift: the same box, content
    moved as a val plane with reset 0.5 (test_rolling_and_network.py)."""
    rng = np.random.default_rng(0)
    D, H, W = 8, 6, 10
    bbox = kt.BoundingBox.create((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    cdata = rng.random((D, H, W)).astype(np.float32)
    shift = (3, -2, 1)
    want = jroll.roll_bounded_volume(kt.BoundedVolume(jnp.asarray(cdata), bbox), shift)
    got = troll.roll_bounded_volume(BoundedVolume(t(cdata), port_bbox(bbox)), shift)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.bbox.lo.numpy(), np.asarray(want.bbox.lo))
    v2 = troll.roll_volume(port_vol(kt.TsdfVolume(jnp.asarray(cdata), jnp.ones((D, H, W)), bbox)),
                           shift)
    assert torch.equal(v2.bbox.hi, got.bbox.hi)
    assert got.data[2, 3, 2] == cdata[3, 1, 5]
    assert (got.data[:, :, -1] == 0.5).all()


@pytest.mark.parametrize("t_wc,lead,threshold", [
    ((0.05, 0.0, -0.45), 0.5, 8), ((2.0, 0.0, -0.5), 0.5, 2), ((0.3, -0.4, 0.2), 1.5, 3),
    ((0.0, 0.0, -3.0), 2.0, 2)])
def test_recenter_shift_and_follow_camera_match_jax(t_wc, lead, threshold):
    T = jse3.make(np.eye(3), t_wc)
    want = jroll.recenter_shift(_jvol(), T, lead=lead, threshold_voxels=threshold)
    pv = port_vol(_jvol())
    assert troll.recenter_shift(pv, t(T), lead=lead, threshold_voxels=threshold) == want
    moved = troll.follow_camera(pv, np.array(T), lead, threshold)
    if want == (0, 0, 0):
        assert moved is pv
    else:
        _equal_volumes(moved, jroll.follow_camera(_jvol(), T, lead, threshold))


@pytest.mark.parametrize("rows", [3, 4])
def test_recenter_shift_takes_only_a_3x4_pose(rows):
    """A (4, 4) pose is refused, as the JAX package refuses it (its row
    (0, 0, 0, 1) is not read as the box); its (3, 4) rows agree."""
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.7, -0.4, 0.9)
    T = T[:rows]
    if rows == 4:
        with pytest.raises(ValueError):
            jroll.recenter_shift(_jvol(), T, lead=0.5, threshold_voxels=1)
        with pytest.raises(ValueError, match=r"\(3, 4\)"):
            troll.recenter_shift(port_vol(_jvol()), t(T), lead=0.5, threshold_voxels=1)
    else:
        want = jroll.recenter_shift(_jvol(), T, lead=0.5, threshold_voxels=1)
        assert want == (5, -3, 10)
        assert troll.recenter_shift(port_vol(_jvol()), t(T), lead=0.5, threshold_voxels=1) == want


def _rand_bounded(seed=1):
    rng = np.random.default_rng(seed)
    bbox = kt.BoundingBox.create((-1.0, -0.5, 0.2), (1.5, 0.9, 2.0))
    data = rng.standard_normal((7, 9, 11)).astype(np.float32)
    return kt.BoundedVolume(jnp.asarray(data), bbox), BoundedVolume(t(data), port_bbox(bbox))


def test_bounded_volume_matches_jax():
    jv, tv = _rand_bounded()
    assert (tv.w, tv.h, tv.d) == (jv.w, jv.h, jv.d) == (11, 9, 7)
    np.testing.assert_allclose(tv.voxel_size_units().numpy(), np.asarray(jv.voxel_size_units()),
                               atol=1e-7, rtol=0)
    np.testing.assert_array_equal(tv.size_units().numpy(), np.asarray(jv.size_units()))
    np.testing.assert_allclose(tv.voxel_positions().numpy(), np.asarray(jv.voxel_positions()),
                               atol=1e-6, rtol=0)
    pts = np.random.default_rng(2).uniform((-1.2, -0.6, 0.0), (1.7, 1.0, 2.2), (50, 3))
    pts = pts.astype(np.float32)
    np.testing.assert_allclose(tv.sample_trilinear_world(t(pts)).numpy(),
                               np.asarray(jv.sample_trilinear_world(jnp.asarray(pts))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tv.grad_backward_world(t(pts)).numpy(),
                               np.asarray(jv.grad_backward_world(jnp.asarray(pts))),
                               atol=1e-5, rtol=0)
    assert torch.equal(tv.image_xy(3), t(jv.image_xy(3)))
    assert torch.equal(tv.image_xz(4), t(jv.image_xz(4)))
    filled = BoundedVolume.create(5, 4, 3, tv.bbox, fill=0.5)
    assert filled.data.shape == (3, 4, 5) and bool((filled.data == 0.5).all())
    assert filled.data.device == tv.bbox.device


@pytest.mark.parametrize("roi", [((-0.3, -0.2, 0.5), (0.6, 0.4, 1.2)),
                                 ((-5.0, -5.0, -5.0), (0.0, 0.0, 1.0)),
                                 ((1.2, 0.8, 1.9), (9.0, 9.0, 9.0))])
def test_sub_volume_and_write_back_match_jax(roi):
    jv, tv = _rand_bounded()
    jroi = kt.BoundingBox.create(*roi)
    jsub, jorg = jv.sub_volume(jroi)
    tsub, torg = tv.sub_volume(port_bbox(jroi))
    assert torg == jorg
    np.testing.assert_array_equal(tsub.data.numpy(), np.asarray(jsub.data))
    np.testing.assert_allclose(tsub.bbox.lo.numpy(), np.asarray(jsub.bbox.lo), atol=1e-7, rtol=0)
    np.testing.assert_allclose(tsub.bbox.hi.numpy(), np.asarray(jsub.bbox.hi), atol=1e-7, rtol=0)
    jback = jv.with_sub_volume(jsub.replace(data=jsub.data * 2.0), jorg)
    tback = tv.with_sub_volume(BoundedVolume(tsub.data * 2.0, tsub.bbox), torg)
    np.testing.assert_array_equal(tback.data.numpy(), np.asarray(jback.data))
    # the TSDF's pair, and the parent untouched
    jt = kt.TsdfVolume(jv.data, jnp.abs(jv.data), jv.bbox)
    tt = port_vol(jt)
    jts, jo = jt.sub_volume(jroi)
    tts, to = tt.sub_volume(port_bbox(jroi))
    assert to == jo and (tts.w, tts.h, tts.d) == (jts.w, jts.h, jts.d)
    _equal_volumes(tts, jts)
    back = tt.with_sub_volume(tsdf.sdf_reset(tts, 0.1), to)
    _equal_volumes(back, jt.with_sub_volume(jsdf.sdf_reset(jts, 0.1), jo))
    assert torch.equal(tt.val, t(jt.val))
    assert torch.equal(tt.as_bounded().data, tt.val)


def test_sub_volume_outside_raises():
    _, tv = _rand_bounded()
    with pytest.raises(ValueError, match="intersect"):
        tv.sub_volume(BoundingBox.create((5.0, 5.0, 5.0), (6.0, 6.0, 6.0), device="cpu"))


def test_bounding_box_methods_match_jax():
    pts = np.random.default_rng(4).standard_normal((9, 3)).astype(np.float32)
    jb = kt.BoundingBox.empty().insert(jnp.asarray(pts))
    tb = BoundingBox.empty(device="cpu").insert(t(pts))
    o = ((-0.5, -0.2, 0.1), (2.0, 0.3, 5.0))
    checks = [(tb, jb), (tb.intersect(BoundingBox.create(*o, device="cpu")),
                         jb.intersect(kt.BoundingBox.create(*o))),
              (tb.enlarge(1.5), jb.enlarge(1.5))]
    for got, want in checks:
        for a, b in ((got.lo, want.lo), (got.hi, want.hi)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tb.center().numpy(), np.asarray(jb.center()), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tb.half_size().numpy(), np.asarray(jb.half_size()), atol=1e-6,
                               rtol=0)
    q = np.random.default_rng(5).standard_normal((20, 3)).astype(np.float32) * 2.0
    np.testing.assert_array_equal(tb.contains(t(q)).numpy(), np.asarray(jb.contains(q)))
    assert bool(tb.contains(t(pts[0])))
    e = BoundingBox.empty(device="cpu")
    assert float(e.lo[0]) == float(np.float32(3.4e38)) == -float(e.hi[0])


@pytest.mark.parametrize("near,far", [(0.5, 4.0), (0.1, 10.0)])
def test_fit_to_frustum_matches_jax(near, far):
    K = kt.Intrinsics.centered(100.0, 64, 48)
    T_wc = jse3.compose(jse3.make(np.eye(3), [0.3, -0.2, 1.0]), jse3.exp(
        jnp.asarray([0.0, 0.0, 0.0, 0.2, -0.3, 0.1])))
    want = jfit(K, 64, 48, T_wc, near, far)
    got = fit_to_frustum(port_K(K), 64, 48, t(T_wc), near, far)
    np.testing.assert_allclose(got.lo.numpy(), np.asarray(want.lo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.hi.numpy(), np.asarray(want.hi), atol=1e-5, rtol=0)
    assert got.lo.device == torch.device("cpu")
    assert bool(got.contains(t(T_wc)[:, 3]))


@pytest.mark.parametrize("name", sorted(jrw.WEIGHT_FNS))
def test_weights_match_jax(name):
    assert sorted(trw.WEIGHT_FNS) == sorted(jrw.WEIGHT_FNS)
    r = np.random.default_rng(6).standard_normal(200).astype(np.float32) * 0.3
    want = np.asarray(jrw.WEIGHT_FNS[name](jnp.asarray(r), 0.2))
    got = trw.WEIGHT_FNS[name](t(r), 0.2)
    assert got.dtype == torch.float32 and got.shape == (200,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_lss_zero_and_merge_match_jax():
    z = LSS.zero(6, device="cpu")
    jz = JLSS.zero(6)
    for f in dataclasses.fields(LSS):
        np.testing.assert_array_equal(getattr(z, f.name).numpy(), np.asarray(getattr(jz, f.name)))
    rng = np.random.default_rng(7)
    parts = [rng.standard_normal(s).astype(np.float32) for s in ((6, 6), (6,), (), ())]
    a = LSS(*map(t, parts))
    total = z + a + a
    want = jz + JLSS(*map(jnp.asarray, parts)) + JLSS(*map(jnp.asarray, parts))
    for f in dataclasses.fields(LSS):
        np.testing.assert_allclose(getattr(total, f.name).numpy(),
                                   np.asarray(getattr(want, f.name)), atol=1e-6, rtol=0)
