"""The KinectFusion frame's building blocks against kangaroo_tpu on the CPU:
containers (intrinsics, TSDF volume, pyramid), SE3, sampling, resampling,
the bilateral filters, depth to points and normals, the normal equations
and projective ICP. Inputs are NumPy arrays from a seed, fed to both.

Tolerances: 1e-6 absolute for elementwise float32 arithmetic in the same
order (XLA on the CPU may contract a product and a sum into one FMA,
which PyTorch rounds twice), 1e-5 where exp, sin/cos or a 3-term sum
enter, 1e-4 for normals (forward differences amplify the last bits) and
relative 1e-4 for the reduced normal equations (sums of thousands of rows
in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.containers import pyramid as jpyr
from kangaroo_tpu.core import reweighting as jrw
from kangaroo_tpu.core import sampling as jsamp
from kangaroo_tpu.core import se3 as jse3
from kangaroo_tpu.geometry import depth as jdepth
from kangaroo_tpu.ops import bilateral as jbf
from kangaroo_tpu.ops import resample as jres
from kangaroo_tpu.solvers import icp as jicp
from kangaroo_tpu.solvers import lss as jlss
from kangaroo_tpu_torch.containers import BoundingBox, Intrinsics, TsdfVolume
from kangaroo_tpu_torch.containers import pyramid as tpyr
from kangaroo_tpu_torch.core import reweighting as trw
from kangaroo_tpu_torch.core import sampling as tsamp
from kangaroo_tpu_torch.core import se3 as tse3
from kangaroo_tpu_torch.geometry import depth as tdepth
from kangaroo_tpu_torch.ops import bilateral as tbf
from kangaroo_tpu_torch.ops import resample as tres
from kangaroo_tpu_torch.solvers import icp as ticp
from kangaroo_tpu_torch.solvers import lss as tlss

H, W = 24, 32


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def depth_image(seed=0, holes=0.1):
    """A tilted plane with bumps and NaN holes, in metres."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    d = 2.0 + 0.01 * u + 0.02 * v + 0.05 * np.sin(u / 3.0) * np.cos(v / 4.0)
    d = (d + rng.normal(0, 0.003, d.shape)).astype(np.float32)
    d[rng.random(d.shape) < holes] = np.nan
    return d


def random_pose(seed):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.normal(0, 0.2, 3), rng.normal(0, 0.3, 3)]).astype(np.float32)
    return np.asarray(jse3.exp(jnp.asarray(xi)))


K_ARGS = (45.0, 44.0, 15.7, 11.2)


def test_intrinsics_match_jax():
    jK = kt.Intrinsics.create(*K_ARGS)
    tK = Intrinsics.create(*K_ARGS)
    for l in range(3):
        jl, tl = jK.level(l), tK.level(l)
        assert (tl.fu, tl.fv, tl.u0, tl.v0) == tuple(float(x) for x in (jl.fu, jl.fv, jl.u0,
                                                                          jl.v0))
        close(tl.matrix("cpu"), jl.matrix(), 0)
    z = depth_image(1)
    close(tK.unproject_grid(W, H, device="cpu"), jK.unproject_grid(W, H), 0)
    close(tK.unproject_grid(W, H, t(z)), jK.unproject_grid(W, H, jnp.asarray(z)), 1e-6)
    c = kt.Intrinsics.centered(550.0, 640, 480)
    assert Intrinsics.centered(550.0, 640, 480) == Intrinsics.create(
        float(c.fu), float(c.fv), float(c.u0), float(c.v0))


def _volumes(seed=2):
    rng = np.random.default_rng(seed)
    val = rng.uniform(-1, 1, (10, 12, 14)).astype(np.float32)
    lo, hi = (-1.0, -0.5, 0.2), (1.2, 0.9, 2.0)
    jv = kt.TsdfVolume(jnp.asarray(val), jnp.ones_like(jnp.asarray(val)),
                       kt.BoundingBox.create(lo, hi))
    tv = TsdfVolume(t(val), torch.ones(val.shape), BoundingBox.create(lo, hi, device="cpu"))
    pos = rng.uniform((-1.1, -0.6, 0.1), (1.3, 1.0, 2.1), (50, 3)).astype(np.float32)
    return jv, tv, pos


def test_volume_matches_jax():
    jv, tv, pos = _volumes()
    close(tv.voxel_size_units(), jv.voxel_size_units(), 0)
    close(tv.voxel_positions(), jv.voxel_positions(), 1e-6)
    close(tv.sample_trilinear_world(t(pos)), jv.sample_trilinear_world(jnp.asarray(pos)), 1e-6)
    close(tv.grad_backward_world(t(pos)), jv.grad_backward_world(jnp.asarray(pos)), 1e-4)
    reset = tv.reset(float("nan"))
    assert torch.isnan(reset.val).all() and not reset.weight.any()
    fresh = TsdfVolume.create(4, 3, 2, BoundingBox.create(device="cpu"), trunc_dist=0.5)
    assert fresh.val.shape == (2, 3, 4) and float(fresh.val[0, 0, 0]) == 0.5
    assert not fresh.weight.any()


def test_pyramid_and_box_half_match_jax():
    d = depth_image(3, holes=0.3)
    d[:4, :4] = np.nan  # a block with no valid entry
    for got, want in zip(tpyr.box_reduce_ignore_invalid(t(d), 3),
                         jpyr.box_reduce_ignore_invalid(jnp.asarray(d), 3)):
        close(got, want, 1e-6)
    odd = depth_image(4, holes=0.0)[:23, :31]
    close(tres.box_half(t(odd)), jres.box_half(jnp.asarray(odd)), 1e-6)
    u16 = np.random.default_rng(5).integers(0, 60000, (H, W)).astype(np.int32)
    close(tres.box_half(t(u16)), jres.box_half(jnp.asarray(u16)), 0)
    close(tres.box_half_ignore_invalid(t(u16)), jres.box_half_ignore_invalid(jnp.asarray(u16)), 0)


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic", "catmull_rom", 0, 1, 2, 3])
def test_resample_matches_jax(method):
    img = np.random.default_rng(6).random((H, W, 2)).astype(np.float32)
    for out in ((W // 2, H // 2), (W + 7, H + 5)):
        close(tres.resample(t(img), *out, method=method),
              jres.resample(jnp.asarray(img), *out, method=method), 1e-6)


def test_resample_refuses_unported_methods():
    """Every sampler of the JAX package is ported; a method neither package
    has raises as it does there."""
    with pytest.raises(KeyError, match="lanczos"):
        tres.resample(torch.zeros(4, 4), 2, 2, method="lanczos")


def test_sampling_matches_jax():
    rng = np.random.default_rng(7)
    img = rng.random((H, W, 3)).astype(np.float32)
    x = rng.uniform(-3, W + 3, 200).astype(np.float32)
    y = rng.uniform(-3, H + 3, 200).astype(np.float32)
    jimg, jx, jy = jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)
    close(tsamp.bilinear(t(img), t(x), t(y)), jsamp.bilinear(jimg, jx, jy), 1e-6)
    close(tsamp.nearest(t(img), t(x), t(y)), jsamp.nearest(jimg, jx, jy), 0)
    close(tsamp.get_clamped(t(img), t(x).long(), t(y).long()),
          jsamp.get_clamped(jimg, jx.astype(jnp.int32), jy.astype(jnp.int32)), 0)
    for border in (0, 2):
        assert np.array_equal(tsamp.in_bounds(t(img), t(x), t(y), border).numpy(),
                              np.asarray(jsamp.in_bounds(jimg, jx, jy, border)))


def test_se3_matches_jax():
    rng = np.random.default_rng(8)
    pts = rng.normal(0, 1, (20, 3)).astype(np.float32)
    for seed in range(4):
        xi = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 0.5 if seed else 1e-6, 3)])
        xi = xi.astype(np.float32)
        Tj = jse3.exp(jnp.asarray(xi))
        Tt = tse3.exp(t(xi))
        close(Tt, Tj, 1e-6)
        close(tse3.log(Tt), jse3.log(Tj), 1e-5)
        T2 = random_pose(seed + 10)
        close(tse3.compose(Tt, t(T2)), jse3.compose(Tj, jnp.asarray(T2)), 1e-6)
        close(tse3.inverse(Tt), jse3.inverse(Tj), 1e-6)
        for name in ("transform", "rotate", "rotate_inv", "transform_inv"):
            close(getattr(tse3, name)(Tt, t(pts)), getattr(jse3, name)(Tj, jnp.asarray(pts)),
                  1e-6)
    close(tse3.generator_products(t(pts)), jse3.generator_products(jnp.asarray(pts)), 0)
    n = np.array([0.1, -0.2, 0.3], np.float32)
    close(tse3.plane_b_from_a(t(random_pose(3)), t(n)),
          jse3.plane_b_from_a(jnp.asarray(random_pose(3)), jnp.asarray(n)), 1e-6)
    close(tse3.to_matrix4(t(random_pose(4))), jse3.to_matrix4(jnp.asarray(random_pose(4))), 0)
    close(tse3.identity("cpu"), jse3.identity(), 0)
    close(tse3.make(np.eye(3), [1, 2, 3]), jse3.make(np.eye(3), [1, 2, 3]), 0)


def test_tukey_weight_matches_jax():
    r = np.random.default_rng(9).normal(0, 0.2, 100).astype(np.float32)
    close(trw.weight_tukey(t(r), 0.1), jrw.weight_tukey(jnp.asarray(r), 0.1), 1e-6)


def test_bilateral_matches_jax():
    d = depth_image(10, holes=0.0)
    close(tbf.bilateral(t(d), 1.5, 0.1, 2), jbf.bilateral(jnp.asarray(d), 1.5, 0.1, 2), 1e-5)
    d = depth_image(11, holes=0.05)
    d[3, 4] = 0.0  # a sensor zero, below minval
    got = tbf.bilateral_above_min(t(d), 1.5, 0.1, 3, 0.2)
    want = np.asarray(jbf.bilateral_above_min(jnp.asarray(d), 1.5, 0.1, 3, 0.2))
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want[3, 4])
    close(got, want, 1e-5)


def test_depth_to_vbo_and_normals_match_jax():
    d = depth_image(12)
    jK, tK = kt.Intrinsics.create(*K_ARGS), Intrinsics.create(*K_ARGS)
    vj = jdepth.depth_to_vbo(jnp.asarray(d), jK)
    vt = tdepth.depth_to_vbo(t(d), tK)
    close(vt, vj, 1e-6)
    nj, nt = np.asarray(jdepth.normals_from_vbo(vj)), tdepth.normals_from_vbo(vt).numpy()
    assert np.array_equal(np.isnan(nt), np.isnan(nj))
    close(nt, nj, 1e-4)
    assert (nt[-1, :, 3] == 0).all() and (nt[:, -1, 3] == 0).all()


def test_normal_equations_and_solve_match_jax():
    rng = np.random.default_rng(13)
    J = rng.normal(0, 1, (H, W, 6)).astype(np.float32)
    y = rng.normal(0, 0.1, (H, W)).astype(np.float32)
    w = rng.random((H, W)).astype(np.float32)
    valid = rng.random((H, W)) > 0.2
    J[~valid] = np.nan  # masked rows must not poison the sums
    sj = jlss.reduce_system(jnp.asarray(J), jnp.asarray(y), jnp.asarray(w), jnp.asarray(valid))
    st = tlss.reduce_system(t(J), t(y), t(w), t(valid))
    for a, b in ((st.JTJ, sj.JTJ), (st.JTy, sj.JTy), (st.sqErr, sj.sqErr), (st.obs, sj.obs)):
        close(a, b, 1e-4, rtol=1e-4)
    close(st.rmse(), sj.rmse(), 1e-6)
    close(st.solve(), sj.solve(), 1e-5, rtol=1e-4)
    close(tlss.solve_spd(st.JTJ, st.JTy, 0.5), jlss.solve_spd(sj.JTJ, sj.JTy, 0.5), 1e-5,
          rtol=1e-4)
    # not positive definite -> NaN, as jnp.linalg.cholesky
    bad = -torch.eye(6)
    assert torch.isnan(tlss.solve_spd(bad, torch.ones(6))).all()
    assert np.isnan(np.asarray(jlss.solve_spd(-jnp.eye(6), jnp.ones(6)))).all()
    empty = tlss.reduce_system(t(J), t(y), t(w), torch.zeros(H, W, dtype=torch.bool))
    assert torch.isnan(empty.rmse())  # nothing observed: NaN, for the app's reset


def _icp_inputs(seed=14):
    """Live points/normals from a bumpy depth image, the model the same
    surface seen from a slightly moved camera."""
    jK = kt.Intrinsics.create(*K_ARGS)
    d = depth_image(seed, holes=0.05)
    live = jdepth.depth_to_vbo(jnp.asarray(d), jK)
    T_lr = jse3.exp(jnp.asarray([0.01, -0.005, 0.008, 0.004, -0.003, 0.002], jnp.float32))
    ref = jnp.concatenate([jse3.transform(jse3.inverse(T_lr), live[..., :3]),
                           live[..., 3:]], axis=-1)
    nrm = jdepth.normals_from_vbo(ref)
    KT = jK.matrix() @ T_lr
    Km = np.asarray(jK.matrix())
    return live, ref, nrm, KT, jse3.inverse(T_lr), Km


@pytest.mark.parametrize("assoc_radius", [None, 2])
@pytest.mark.parametrize("k_live", [True, False])
def test_icp_point_plane_matches_jax(assoc_radius, k_live):
    live, ref, nrm, KT, T_rl, Km = _icp_inputs()
    jK_live = (Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2]) if k_live else None
    tK_live = tuple(torch.tensor(v) for v in jK_live) if k_live else None
    sj = jicp.icp_point_plane(live, ref, nrm, KT, T_rl, 0.1, assoc_radius=assoc_radius,
                              K_live=jK_live)
    st = ticp.icp_point_plane(t(live), t(ref), t(nrm), t(KT), t(T_rl), 0.1,
                              assoc_radius=assoc_radius, K_live=tK_live)
    assert float(sj.obs) > 0.5 * H * W
    assert float(st.obs) == float(sj.obs)
    for a, b in ((st.JTJ, sj.JTJ), (st.JTy, sj.JTy), (st.sqErr, sj.sqErr)):
        close(a, b, 1e-5, rtol=1e-4)
    for rot in (False, True):
        close(ticp.solve_pose_update(st, rot), jicp.solve_pose_update(sj, rot), 1e-5, rtol=1e-3)


def test_icp_converges_to_the_motion():
    """A few Gauss-Newton steps of the port's ICP recover the camera motion."""
    live, ref, nrm, KT, T_rl, Km = _icp_inputs()
    Kt = t(Km)
    live_t, ref_t, nrm_t = t(live), t(ref), t(nrm)
    T_lp = tse3.identity("cpu")
    for _ in range(6):
        s = ticp.icp_point_plane(live_t, ref_t, nrm_t, Kt @ T_lp, tse3.inverse(T_lp), 0.1,
                                 K_live=(Kt[0, 0], Kt[1, 1], Kt[0, 2], Kt[1, 2]))
        x = -ticp.solve_pose_update(s)
        T_lp = tse3.compose(T_lp, tse3.exp(torch.where(torch.isfinite(x), x, 0.0)))
    close(T_lp, jse3.inverse(T_rl), 2e-3)
