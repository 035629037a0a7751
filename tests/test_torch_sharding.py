"""The rest of the multi-device layer against kangaroo_tpu: the z-sharded
volume (``shard_volume_z``, the voxel and plane-sweep fuses, the colour
fuse, the sphere-trace and plane-sweep raycasts), sharded ICP, census WTA
and DTAM with the disparity axis sharded, row-sharded stencils and
``frame_parallel``, on a virtual 8-shard CPU mesh
(``make_mesh(devices=["cpu"] * 8)``) against the JAX package's on its
8-device CPU mesh, on tests/test_parallel.py's cases (a (D, H, W) =
(48, 48, 64) volume, 48x36 depth of a sphere). Each JAX mesh computation is
made once, in a module-scoped fixture, under ``jax.jit`` (one compiled
program each: called op by op, the JAX package's mesh programs take from 7 s
to over 2 minutes to run on the CPU).

Tolerances. Against the JAX package's sharded function, the port's own
single-device tolerances for the op: the fuses val 1e-5 and weight 1e-4
where both updated, one-sided updates held to 0.2 % of the updated voxels,
untouched voxels bit-equal (test_torch_separable.compare_fused); the
raycasts' NaN masks equal but for 0.5 % of pixels, depth 1e-4, normals and
images 1e-3 (test_torch_separable, test_torch_fusion_exact); ICP 1e-4
relative; census WTA exactly; DTAM 1e-5 after 12 iterations and its seed
exactly (test_torch_dtam). Against the port's single-device function, the
JAX package's own mesh bounds (tests/test_parallel.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.apps import stereo as jst
from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu.core import se3 as jse3
from kangaroo_tpu.fusion import raycast as jrc
from kangaroo_tpu.fusion import sdf as jsdf
from kangaroo_tpu.geometry import depth as jdepth
from kangaroo_tpu.ops import blur as jblur
from kangaroo_tpu.parallel import batch as jbatch
from kangaroo_tpu.parallel import mesh as jmesh
from kangaroo_tpu.parallel import sharding as jsh
from kangaroo_tpu.stereo import dispatch as jfast
from kangaroo_tpu_torch.apps import stereo as tst
from kangaroo_tpu_torch.containers import BoundedVolume, TsdfVolume
from kangaroo_tpu_torch.fusion import raycast as trc
from kangaroo_tpu_torch.fusion import sdf as tsdf
from kangaroo_tpu_torch.fusion import separable as tsep
from kangaroo_tpu_torch.fusion import separable_cuda
from kangaroo_tpu_torch.ops import blur as tblur
from kangaroo_tpu_torch.parallel import batch as tbatch
from kangaroo_tpu_torch.parallel import mesh as tmesh
from kangaroo_tpu_torch.parallel import sharding as tsh
from kangaroo_tpu_torch.solvers import icp as ticp
from kangaroo_tpu_torch.stereo import census as tcensus
from kangaroo_tpu_torch.stereo import costvolume as tcv
from kangaroo_tpu_torch.stereo import dispatch as tfast
from test_torch_separable import (_compare_images, colour_inputs, compare_fused, port_K,
                                  port_vol, t)

TRUNC, MAX_W, MINCOS = 0.15, 1000.0, 0.1
VOXEL = 2.4 / 47


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def scene():
    """tests/test_parallel.py's ``_setup``: (K, empty volume, T_wc, depth,
    normals, W, H), and the volume fused once by the voxel fuse."""
    W, H = 48, 36
    K = kt.Intrinsics.centered(40.0, W, H)
    bbox = kt.BoundingBox.create((-1.2, -1.2, -1.2), (1.2, 1.2, 1.2))
    vol = kt.TsdfVolume.create(64, 48, 48, bbox, trunc_dist=0.15)
    T_wc = jse3.make(np.eye(3), [0.0, 0.0, -3.0])
    gt, _ = jrc.raycast_sphere(jnp.full((H, W), jnp.nan), T_wc, K, (0.0, 0.0, 0.0), 0.9, W, H)
    norm = jdepth.normals_from_vbo(jdepth.depth_to_vbo(gt, K))
    fused = jax.jit(lambda v, d, n: jsdf.sdf_fuse(v, d, n, jse3.inverse(T_wc), K, TRUNC, MAX_W,
                                                  MINCOS))(vol, gt, norm)
    return K, vol, np.asarray(T_wc, np.float32), gt, norm, W, H, fused


@pytest.fixture(scope="module")
def jax_fused(scene, jax_mesh):
    """The JAX package's z-sharded fuses of the empty volume."""
    K, vol, T_wc, gt, norm, W, H, _ = scene
    T_cw = jse3.inverse(T_wc)
    vsh = jsh.shard_volume_z(vol, jax_mesh)
    cvol, rgb, T_iw = colour_inputs(vol, T_cw, W, H)
    voxel = jax.jit(lambda v, d, n: jsh.sharded_sdf_fuse(v, d, n, T_cw, K, TRUNC, MAX_W, MINCOS,
                                                         jax_mesh))
    sep = jax.jit(lambda v, d, n: jsh.sharded_sdf_fuse_separable(v, d, n, T_cw, K, TRUNC, MAX_W,
                                                                 MINCOS, jax_mesh))
    colour = jax.jit(lambda v, c, d, n, img: jsh.sharded_sdf_fuse_color_separable(
        v, c, d, n, T_cw, K, img, T_iw, K, TRUNC, MAX_W, MINCOS, jax_mesh))
    return {"voxel": voxel(vsh, gt, norm), "separable": sep(vsh, gt, norm),
            "colour": colour(vsh, jsh.shard_bounded_volume_z(cvol, jax_mesh), gt, norm,
                             jnp.asarray(rgb))}


@pytest.fixture(scope="module")
def jax_raycasts(scene, jax_mesh):
    K, vol, T_wc, gt, norm, W, H, fused = scene
    vsh = jsh.shard_volume_z(fused, jax_mesh)
    T = jnp.asarray(T_wc)
    return {name: jax.jit(lambda v, T_: fn(v, T_, K, W, H, jax_mesh, near=0.5, far=8.0,
                                           trunc_dist=TRUNC))(vsh, T)
            for name, fn in (("sphere", jsh.sharded_raycast),
                             ("separable", jsh.sharded_raycast_separable))}


def test_shard_volume_z_cuts_views_and_gathers(scene, mesh):
    _, vol, *_ = scene
    pv = port_vol(vol)
    zs = tsh.shard_volume_z(pv, mesh)
    assert len(zs.val) == 8 and zs.shape == (48, 48, 64) and zs.is_tsdf
    assert zs.val[3].data_ptr() == pv.val[18:24].data_ptr()  # views of the volume
    assert tsh.shard_volume_z(zs, mesh) is zs
    back = zs.gather()
    assert torch.equal(back.val, pv.val) and torch.equal(back.weight, pv.weight)
    np.testing.assert_array_equal(zs.voxel_size_units().numpy(), pv.voxel_size_units().numpy())
    with pytest.raises(ValueError):
        tsh.shard_volume_z(pv, tmesh.make_mesh(devices=["cpu"] * 5))


@pytest.mark.parametrize("k,extra", [(0, 0), (3, 1), (7, 1)])
def test_slab_bbox_matches_jax(scene, k, extra):
    _, vol, *_ = scene
    lo, hi = jsh._slab_bbox_from(vol.bbox.lo, vol.bbox.hi, 48, 8, k, extra)
    pv = port_vol(vol)
    got = tsh._slab_bbox_from(pv.bbox.lo, pv.bbox.hi, 48, 8, k, extra)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(lo))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(hi))


def test_sharded_voxel_fuse(scene, mesh, jax_fused):
    K, vol, T_wc, gt, norm, W, H, _ = scene
    T_cw = t(jse3.inverse(T_wc))
    got = tsh.sharded_sdf_fuse(port_vol(vol), t(gt), t(norm), T_cw, port_K(K), TRUNC, MAX_W,
                               MINCOS, mesh).gather()
    want = jax_fused["voxel"]
    compare_fused(got.val, got.weight, want.val, want.weight)
    single = tsdf.sdf_fuse(port_vol(vol), t(gt), t(norm), T_cw, port_K(K), TRUNC, MAX_W, MINCOS)
    np.testing.assert_allclose(got.val.numpy(), single.val.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.weight.numpy(), single.weight.numpy(), atol=1e-5)


def _separable_vs_single(got, single):
    """tests/test_parallel.py's bounds: per-slab grids agree with the
    whole-volume sweep statistically, not bitwise."""
    ww, gw = single.weight.numpy(), got.weight.numpy()
    assert ((ww > 0) == (gw > 0)).mean() > 0.99
    both = (ww > 0) & (gw > 0)
    dv = np.abs(single.val.numpy()[both] - got.val.numpy()[both])
    assert np.median(dv) < 2e-3 and dv.max() < 0.05


def test_sharded_separable_fuse(scene, mesh, jax_fused):
    K, vol, T_wc, gt, norm, W, H, _ = scene
    T_cw = t(jse3.inverse(T_wc))
    pv = port_vol(vol)
    got = tsh.sharded_sdf_fuse_separable(pv, t(gt), t(norm), T_cw, port_K(K), TRUNC, MAX_W,
                                         MINCOS, mesh)
    assert float(pv.weight.max()) == 0.0  # value semantics
    got = got.gather()
    want = jax_fused["separable"]
    assert int((np.asarray(want.weight) > 0).sum()) > 1000
    compare_fused(got.val, got.weight, want.val, want.weight)
    _separable_vs_single(got, tsep.sdf_fuse_separable(pv, t(gt), t(norm), T_cw, port_K(K),
                                                      TRUNC, MAX_W, MINCOS, sweep_axis=0))


def test_sharded_separable_fuse_gate_and_inplace(scene, mesh, jax_fused):
    """enable=False passes every slab through exactly; ``inplace`` updates
    the slabs (views of the volume on a virtual mesh) and so the volume."""
    K, vol, T_wc, gt, norm, W, H, _ = scene
    T_cw = t(jse3.inverse(T_wc))
    pv = port_vol(vol)
    zs = tsh.shard_volume_z(pv, mesh)
    off = tsh.sharded_sdf_fuse_separable(zs, t(gt), t(norm), T_cw, port_K(K), TRUNC, MAX_W,
                                         MINCOS, mesh, enable=torch.tensor(False))
    assert torch.equal(off.gather().weight, pv.weight)
    assert torch.equal(off.gather().val, pv.val)
    on = tsh.sharded_sdf_fuse_separable(zs, t(gt), t(norm), T_cw, port_K(K), TRUNC, MAX_W,
                                        MINCOS, mesh, enable=torch.tensor(True), inplace=True)
    assert on.val[2] is zs.val[2]
    want = jax_fused["separable"]
    compare_fused(pv.val, pv.weight, want.val, want.weight)


def test_sharded_colour_fuse(scene, mesh, jax_fused):
    K, vol, T_wc, gt, norm, W, H, _ = scene
    T_cw = jse3.inverse(T_wc)
    cvol, rgb, T_iw = colour_inputs(vol, T_cw, W, H)
    pv = port_vol(vol)
    got_v, got_c = tsh.sharded_sdf_fuse_color_separable(
        pv, BoundedVolume(t(cvol.data), pv.bbox), t(gt), t(norm), t(T_cw), port_K(K),
        torch.from_numpy(rgb), t(T_iw), port_K(K), TRUNC, MAX_W, MINCOS, mesh)
    got_v, got_c = got_v.gather(), got_c.gather()
    want_v, want_c = jax_fused["colour"]
    compare_fused(got_v.val, got_v.weight, want_v.val, want_v.weight)
    both = (got_v.weight.numpy() > 0) & (np.asarray(want_v.weight) > 0)
    np.testing.assert_allclose(got_c.data.numpy()[both], np.asarray(want_c.data)[both],
                               atol=1e-5, rtol=0)
    assert np.ptp(got_c.data.numpy()[both]) > 0.3


def test_sharded_sphere_raycast(scene, mesh, jax_raycasts):
    K, vol, T_wc, gt, norm, W, H, fused = scene
    got_d, got_n, got_img = tsh.sharded_raycast(port_vol(fused), t(T_wc), port_K(K), W, H,
                                                mesh, near=0.5, far=8.0, trunc_dist=TRUNC)
    want_d, want_n, want_img = jax_raycasts["sphere"]
    _compare_images(got_d, want_d, 1e-4)
    hit = np.isfinite(np.asarray(want_d)) & np.isfinite(got_d.numpy())
    np.testing.assert_allclose(got_n.numpy()[hit], np.asarray(want_n)[hit], atol=1e-3)
    np.testing.assert_allclose(got_img.numpy()[hit], np.asarray(want_img)[hit], atol=1e-3)
    # tests/test_parallel.py's bounds against the single-device march
    d1, n1, _ = trc.raycast_sdf(port_vol(fused), t(T_wc), port_K(K), W, H, near=0.5, far=8.0,
                                trunc_dist=TRUNC)
    a, b = d1.numpy(), got_d.numpy()
    both = np.isfinite(a) & np.isfinite(b)
    assert both.sum() > 0.9 * np.isfinite(a).sum()
    diff = np.abs(a[both] - b[both])
    assert (diff < 2e-2).mean() > 0.95 and np.median(diff) < 1e-3
    close = both & (np.abs(a - b) < 1e-4)
    assert (np.sum(n1.numpy()[close] * got_n.numpy()[close], axis=-1) > 0.999).mean() > 0.99
    assert (got_n.numpy()[close] < -0.1).any(), "negative normal components clamped"


def test_sharded_separable_raycast(scene, mesh, jax_raycasts):
    K, vol, T_wc, gt, norm, W, H, fused = scene
    got_d, got_n, got_img = tsh.sharded_raycast_separable(
        port_vol(fused), t(T_wc), port_K(K), W, H, mesh, near=0.5, far=8.0, trunc_dist=TRUNC)
    want_d, want_n, want_img = jax_raycasts["separable"]
    assert np.isfinite(np.asarray(want_d)).sum() > 300
    _compare_images(got_d, want_d, 1e-4)
    hit = np.isfinite(np.asarray(want_d)) & np.isfinite(got_d.numpy())
    np.testing.assert_allclose(got_n.numpy()[hit], np.asarray(want_n)[hit], atol=1e-3)
    np.testing.assert_allclose(got_img.numpy()[hit], np.asarray(want_img)[hit], atol=1e-3)
    assert (got_n.numpy()[hit][:, :3] < -0.1).any(), "negative normal components clamped"
    unshaded = tsh.sharded_raycast_separable(port_vol(fused), t(T_wc), port_K(K), W, H, mesh,
                                             near=0.5, far=8.0, trunc_dist=TRUNC, shade=False)
    assert torch.equal(unshaded[0].nan_to_num(7.0), got_d.nan_to_num(7.0))
    assert float(unshaded[2].abs().max()) == 0.0
    d1, n1, _ = tsep.raycast_sdf_separable(port_vol(fused), t(T_wc), port_K(K), W, H,
                                           near=0.5, far=8.0, trunc_dist=TRUNC, sweep_axis=0)
    a, b = d1.numpy(), got_d.numpy()
    both = np.isfinite(a) & np.isfinite(b)
    assert both.sum() > 0.95 * np.isfinite(a).sum()
    diff = np.abs(a[both] - b[both])
    assert np.median(diff) < 0.2 * VOXEL and np.percentile(diff, 95) < 0.5 * VOXEL
    dot = np.sum(n1.numpy()[both][:, :3] * got_n.numpy()[both][:, :3], axis=-1)
    assert np.median(dot) > 0.98


def test_sharded_icp(jax_mesh, mesh):
    W, H = 64, 48
    K = kt.Intrinsics.centered(50.0, W, H)
    T_wc = jse3.make(np.eye(3), [0.0, 0.0, -3.0])
    gt, _ = jrc.raycast_sphere(jnp.full((H, W), jnp.nan), T_wc, K, (0.0, 0.0, 0.0), 0.9, W, H)
    pts = jdepth.depth_to_vbo(gt, K)
    norm = jdepth.normals_from_vbo(pts)
    Km = jnp.asarray(np.asarray(K.matrix()))
    T = jnp.asarray(jse3.identity())
    want = jax.jit(lambda p, n: jsh.sharded_icp_point_plane(p, p, n, Km @ T, T, 0.1,
                                                            jax_mesh))(pts, norm)
    args = (t(pts), t(pts), t(norm), t(Km @ T), t(T), 0.1)
    got = tsh.sharded_icp_point_plane(*args, mesh)
    single = ticp.icp_point_plane(*args)
    for name in ("JTJ", "JTy", "sqErr", "obs"):
        g = getattr(got, name).numpy()
        scale = max(float(np.abs(np.asarray(getattr(want, name))).max()), 1e-30)
        np.testing.assert_allclose(g, np.asarray(getattr(want, name)), rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
        np.testing.assert_allclose(g, getattr(single, name).numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(got.obs) == float(single.obs) > 500


def test_sharded_census_wta(jax_mesh, mesh):
    left, right, _ = jsyn.stereo_pair(64, 32, 16, seed=3)
    want = np.asarray(jax.jit(lambda l, r: jsh.sharded_census_wta(l, r, 16, jax_mesh, "9x7"))(
        left, right))
    got = tsh.sharded_census_wta(t(left), t(right), 16, mesh, "9x7")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    cl, cr = tcensus.census(t(left), "9x7"), tcensus.census(t(right), "9x7")
    single = tcv.cost_vol_minimum(tcensus.census_cost_volume(cl, cr, 16, -1, 64), 16)
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    with pytest.raises(ValueError):
        tsh.sharded_census_wta(t(left), t(right), 12, mesh, "9x7")


DTAM_ARGS = (20.0, 100.0, 0.7, 0.7, 0.002, 1e-5, 14.0, 2.5)


@pytest.mark.parametrize("iterations", [0, 12])
def test_sharded_dtam_solve(jax_mesh, mesh, iterations):
    rng = np.random.default_rng(7)
    D, H, W = 16, 24, 40
    vol = rng.random((D, H, W)).astype(np.float32)
    img = rng.random((H, W)).astype(np.float32)
    got = tsh.sharded_dtam_solve(t(vol), t(img), *DTAM_ARGS, mesh, iterations=iterations)
    want = np.asarray(jax.jit(lambda v, i: jsh.sharded_dtam_solve(
        v, i, *DTAM_ARGS, jax_mesh, iterations=iterations))(jnp.asarray(vol), jnp.asarray(img)))
    if iterations == 0:  # the seed: the subpixel WTA exactly
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), tcv.cost_vol_minimum_subpix(t(vol)).numpy())
        return
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    single = tst.dtam_solve(t(vol), t(img), *DTAM_ARGS, iterations=iterations)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0, atol=1e-5)


def test_sharded_stencil_rows(jax_mesh, mesh):
    img = np.random.default_rng(5).random((64, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jsh.sharded_stencil_rows(
        lambda x: jblur.gaussian_blur(x, 1.0, rad=1), jax_mesh, halo=1))(jnp.asarray(img)))
    fn = lambda x: tblur.gaussian_blur(x, 1.0, rad=1)  # noqa: E731
    got = tsh.sharded_stencil_rows(fn, mesh, halo=1)(t(img))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), fn(t(img)).numpy(), atol=1e-6, rtol=0)


def test_frame_parallel(jax_mesh, mesh):
    """tests/test_fast_paths.py's census-WTA body over 8 frames."""
    jcfg = jst.StereoConfig(max_disp=8, census_window="9x7")
    cfg = tst.StereoConfig.from_dict(jcfg.__dict__)

    def jax_one(l, r):
        lp, rp = jst.preprocess_intensity(l, jcfg), jst.preprocess_intensity(r, jcfg)
        return jfast.cost_vol_minimum_subpix(jst.cost_volume(lp, rp, jcfg))

    def one(l, r):
        lp, rp = tst.preprocess_intensity(l, cfg), tst.preprocess_intensity(r, cfg)
        return tfast.cost_vol_minimum_subpix(tst.cost_volume(lp, rp, cfg))

    pairs = [jsyn.stereo_pair(64, 32, 8, seed=s) for s in range(8)]
    lb, rb = (np.stack([np.asarray(p[i]) for p in pairs]) for i in (0, 1))
    got = tbatch.frame_parallel(one, mesh)(torch.from_numpy(lb), torch.from_numpy(rb))
    assert got.shape == (8, 32, 64)
    want = jax.jit(jbatch.frame_parallel(jax_one, jax_mesh))(jnp.asarray(lb), jnp.asarray(rb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), equal_nan=True, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[5].numpy(), one(t(lb[5]), t(rb[5])).numpy())
    pair = tbatch.frame_parallel(lambda l, r: (one(l, r), l), mesh, n_outputs=2)(
        torch.from_numpy(lb), torch.from_numpy(rb))
    assert torch.equal(pair[1], torch.from_numpy(lb))
    with pytest.raises(ValueError):
        tbatch.frame_parallel(one, mesh)(torch.from_numpy(lb[:6]), torch.from_numpy(rb[:6]))


def test_cpu_mesh_launches_no_kernel(scene, mesh):
    K, vol, T_wc, gt, norm, W, H, _ = scene
    before = separable_cuda.launches
    tsh.sharded_sdf_fuse_separable(port_vol(vol), t(gt), t(norm), t(jse3.inverse(T_wc)),
                                   port_K(K), TRUNC, MAX_W, MINCOS, mesh)
    assert separable_cuda.launches == before
    assert isinstance(tsh.shard_volume_z(port_vol(vol), mesh).slab(0), TsdfVolume)
