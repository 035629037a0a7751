"""The remaining solvers and geometry of kangaroo_tpu_torch against
kangaroo_tpu's on the CPU: the photometric pose systems, the calibration
systems and the stereo intrinsics refinement, the Manhattan frame, scanline
rectification and the pose graph. Inputs are NumPy arrays from a seed, fed
to both, on 64x48 images and a graph of 6 keyframes.

Tolerances: LSS fields (JTJ, JTy, squared error, count) within 1e-5 of the
field's largest entry (float32 sums of about 3,000 rows in another order,
and XLA's contracted products); Jacobians from ``torch.func.jacfwd`` within
1e-5 of ``jax.jacfwd``'s, at xi = 0 and away from it; poses after the pose
graph and the intrinsics refinement within 1e-5 (the intrinsics 1e-5
relative); the Manhattan rotation within 1e-5; rectification tables within
1e-4 px and the rectified rig exactly as float32 of the same float64 math.

The JAX package's ``pose_refinement_from_disparity_esm``, and its
``discard_saturated=True`` paths, trace ``discard_saturated`` inside a jit
and raise TracerBoolConversionError; they are held here against the JAX
builder's unjitted body (``__wrapped__``), which is the same code.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.core import se3 as jse3
from kangaroo_tpu.geometry import depth as jdepth
from kangaroo_tpu.geometry import pose_graph as jpg
from kangaroo_tpu.geometry import rectify as jrect
from kangaroo_tpu.solvers import calibration as jcal
from kangaroo_tpu.solvers import manhattan as jman
from kangaroo_tpu.solvers import photometric as jphot
from kangaroo_tpu_torch.containers import Intrinsics
from kangaroo_tpu_torch.core import se3 as tse3
from kangaroo_tpu_torch.geometry import depth as tdepth
from kangaroo_tpu_torch.geometry import pose_graph as tpg
from kangaroo_tpu_torch.geometry import rectify as trect
from kangaroo_tpu_torch.solvers import calibration as tcal
from kangaroo_tpu_torch.solvers import manhattan as tman
from kangaroo_tpu_torch.solvers import photometric as tphot

W, H = 64, 48
LSS_RTOL, JAC_ATOL, POSE_ATOL = 1e-5, 1e-5, 1e-5


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def both_K(f, fv=None, u0=None, v0=None):
    """The same camera in both packages: (JAX Intrinsics, port Intrinsics)."""
    jK = (kt.Intrinsics.centered(f, W, H) if u0 is None
          else kt.Intrinsics.create(f, fv, u0, v0))
    return jK, Intrinsics.create(float(jK.fu), float(jK.fv), float(jK.u0), float(jK.v0))


def textured(seed, shape=(H, W), scale=255.0):
    """A smooth random texture on [0, scale]: box-blurred uniform noise."""
    rng = np.random.default_rng(seed)
    img = rng.random((shape[0] * 2, shape[1] * 2)).astype(np.float32) * scale
    k = np.ones(5, np.float32) / 5
    for ax in (0, 1):
        img = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), ax, img)
    return np.ascontiguousarray(img[:shape[0], :shape[1]], np.float32)


def slanted_depth():
    """A slanted plane 1.6-2.4 m away with a few holes (NaN)."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = 2.0 + 0.4 * (u / W - 0.5) + 0.2 * (v / H - 0.5)
    depth[5:8, 10:14] = np.nan
    return depth.astype(np.float32)


def pose(xi) -> np.ndarray:
    return np.asarray(jse3.exp(jnp.asarray(xi, jnp.float32)))


def pose4(xi) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3] = pose(xi)
    return T


def compare_lss(got, want, rtol=LSS_RTOL):
    for name in ("JTJ", "JTy", "sqErr", "obs"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=rtol * scale, rtol=0, err_msg=name)
    assert float(want.obs) > 100  # the inputs exercise the system


# --- photometric ------------------------------------------------------------------------


def test_kt_lr_matches_jax():
    jK, tK = both_K(55.0)
    T = pose([0.01, -0.02, 0.03, 0.01, 0.0, -0.02])
    np.testing.assert_array_equal(tphot.kt_lr(tK, t(T)).numpy(), np.asarray(jphot.kt_lr(jK, T)))
    Km = np.asarray(jK.matrix())
    np.testing.assert_array_equal(tphot.kt_lr(t(Km), t(T)).numpy(),
                                  np.asarray(jphot.kt_lr(jnp.asarray(Km), T)))


@pytest.mark.parametrize("xi", [[0.0] * 6, [0.02, -0.01, 0.03, 0.01, -0.015, 0.02]])
def test_pose_refinement_from_points_matches_jax(xi):
    jK, tK = both_K(55.0)
    live, ref = textured(1), textured(2)
    points = np.asarray(jdepth.depth_to_vbo(jnp.asarray(slanted_depth()), jK))
    KT = np.asarray(jphot.kt_lr(jK, pose(xi)))
    want = jphot.pose_refinement_from_points(live, ref, points, KT, 40.0)
    compare_lss(tphot.pose_refinement_from_points(t(live), t(ref), t(points), t(KT), 40.0), want)


def test_pose_refinement_from_disparity_matches_jax():
    jK, tK = both_K(55.0)
    live, ref = textured(3), textured(4)
    rng = np.random.default_rng(5)
    disp = rng.uniform(8.0, 30.0, (H, W)).astype(np.float32)
    disp[rng.random((H, W)) < 0.1] = 0.0
    KT = np.asarray(jphot.kt_lr(jK, pose([0.01, 0.0, -0.02, 0.0, 0.01, 0.0])))
    want = jphot.pose_refinement_from_disparity(live, ref, disp, KT, 40.0, 0.1, jK, 12.0)
    got = tphot.pose_refinement_from_disparity(t(live), t(ref), t(disp), t(KT), 40.0, 0.1, tK,
                                               12.0)
    compare_lss(got, want)


def esm_inputs(seed=6):
    """Live and reference grey images, a reference depth map, and three
    different cameras with a depth -> grey offset and a live motion."""
    jKg, _ = both_K(55.0)
    jKl, _ = both_K(57.0, 56.5, 31.0, 24.0)
    jKd, _ = both_K(54.0, 54.0, 32.5, 23.0)
    Klg, Krg, Krd = (np.asarray(K.matrix()) for K in (jKl, jKg, jKd))
    Tgd = pose4([0.025, 0.0, 0.0, 0.0, 0.004, 0.0])
    Tlr = pose4([0.01, -0.012, 0.02, 0.006, -0.008, 0.01])
    live, ref = textured(seed), textured(seed + 1)
    live[0:4, 0:6] = 255.0  # saturated corners for discard_saturated
    ref[40:44, 50:60] = 0.0
    return live, ref, Klg, Krg, Krd, Tgd, Tlr, Klg @ Tlr[:3]


@pytest.mark.parametrize("discard_saturated", [False, True])
def test_pose_refinement_from_depth_esm_matches_jax(discard_saturated):
    live, ref, Klg, Krg, Krd, Tgd, Tlr, KlgTlr = esm_inputs()
    depth = slanted_depth()
    jargs = (*map(jnp.asarray, (live, ref, depth, Klg, Krg, Krd, Tgd, Tlr, KlgTlr)), 40.0)
    # the jitted JAX builder traces a discard_saturated that is passed: run
    # its body unjitted then
    want = (jphot.pose_refinement_from_depth_esm.__wrapped__(*jargs, discard_saturated=True)
            if discard_saturated else jphot.pose_refinement_from_depth_esm(*jargs))
    got = tphot.pose_refinement_from_depth_esm(*map(t, (live, ref, depth, Klg, Krg, Krd, Tgd,
                                                        Tlr, KlgTlr)), 40.0,
                                               discard_saturated=discard_saturated)
    compare_lss(got, want)


def test_pose_refinement_from_disparity_esm_matches_jax(monkeypatch):
    live, ref, Klg, Krg, Krd, Tgd, Tlr, KlgTlr = esm_inputs(8)
    rng = np.random.default_rng(9)
    disp = rng.uniform(2.0, 4.0, (H, W)).astype(np.float32)
    disp[rng.random((H, W)) < 0.1] = 0.0
    monkeypatch.setattr(jphot, "pose_refinement_from_depth_esm",
                        jphot.pose_refinement_from_depth_esm.__wrapped__)
    args = (live, ref, disp)
    mats = (Klg, Krg, Krd, Tgd, Tlr, KlgTlr)
    want = jphot.pose_refinement_from_disparity_esm(*map(jnp.asarray, args), 0.1,
                                                    *map(jnp.asarray, mats), 40.0)
    got = tphot.pose_refinement_from_disparity_esm(*map(t, args), 0.1, *map(t, mats), 40.0)
    compare_lss(got, want)


def test_depth_esm_gauss_newton_matches_jax():
    """Damped GN steps on a textured plane 2 m away, seen from a camera
    moved 4 cm along x (tests/test_solvers.py's scene): the port's pose
    tracks the JAX package's step for step, and both recover the motion.
    The depth camera differs from the grey one: with the same camera and
    Tgd = I every reference pixel projects onto itself, and the border
    test at 2 px flips whole columns on an ulp of the matmul."""
    jK, _ = both_K(60.0)
    Km = np.asarray(jK.matrix())
    Kd = np.asarray(both_K(58.0, 58.0, 31.87, 23.29)[0].matrix())
    tex = np.random.default_rng(10).random((H * 2, W * 2)).astype(np.float32) * 255
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)

    def render(tx):
        from kangaroo_tpu.core import sampling as jsamp

        wx = tx + 2.0 * (u - float(jK.u0)) / float(jK.fu)
        wy = 2.0 * (v - float(jK.v0)) / float(jK.fv)
        return np.asarray(jsamp.bilinear(jnp.asarray(tex), jnp.asarray(wx * float(jK.fu) / 2 + W),
                                         jnp.asarray(wy * float(jK.fv) / 2 + H)))

    ref, live = render(0.0), render(0.04)
    depth = np.full((H, W), 2.0, np.float32)
    I4 = np.eye(4, dtype=np.float32)
    T_j = T_t = I4
    for _ in range(6):
        s = jphot.pose_refinement_from_depth_esm(*map(jnp.asarray, (live, ref, depth, Km, Km, Kd,
                                                                    I4, T_j, Km @ T_j[:3])), 50.0)
        T_j = np.vstack([np.asarray(jse3.compose(jnp.asarray(T_j[:3]),
                                                 jse3.exp(-s.solve(damping=1e-3)))), I4[3:]])
        s = tphot.pose_refinement_from_depth_esm(*map(t, (live, ref, depth, Km, Km, Kd, I4, T_t,
                                                          Km @ T_t[:3])), 50.0)
        T_t = np.vstack([tse3.compose(t(T_t[:3]), tse3.exp(-s.solve(damping=1e-3))).numpy(),
                         I4[3:]])
        np.testing.assert_allclose(T_t, T_j, atol=POSE_ATOL, rtol=0)
    assert abs(T_t[0, 3] + 0.04) < 0.01


# --- calibration ------------------------------------------------------------------------


@pytest.mark.parametrize("discard_saturated", [False, True])
def test_calibration_rgbd_matches_jax(discard_saturated):
    jK, _ = both_K(55.0)
    Km = np.asarray(jK.matrix())
    live, ref = textured(11), textured(12)
    live[0:4, 0:6] = 255.0
    points = np.asarray(jdepth.depth_to_vbo(jnp.asarray(slanted_depth()), jK))
    T_cd = pose([0.03, 0.002, -0.001, 0.004, -0.003, 0.002])
    T_lr = pose([0.02, 0.0, 0.01, 0.0, 0.01, 0.0])
    jargs = (*map(jnp.asarray, (live, ref, points, Km, T_cd, T_lr)), 50.0)
    want = (jcal.calibration_rgbd_from_depth_esm.__wrapped__(*jargs, discard_saturated=True)
            if discard_saturated else jcal.calibration_rgbd_from_depth_esm(*jargs))
    got = tcal.calibration_rgbd_from_depth_esm(*map(t, (live, ref, points, Km, T_cd, T_lr)), 50.0,
                                               discard_saturated=discard_saturated)
    compare_lss(got, want)


@pytest.mark.parametrize("channels", [1, 3])
def test_kinect_calibration_matches_jax(channels):
    jK, _ = both_K(55.0)
    if channels == 1:
        live, ref = textured(13), textured(14)
    else:
        live = np.stack([textured(13 + 2 * c) for c in range(3)], -1)
        ref = np.stack([textured(14 + 2 * c) for c in range(3)], -1)
    points = np.asarray(jdepth.depth_to_vbo(jnp.asarray(slanted_depth()), jK))
    KcT = np.asarray(jphot.kt_lr(jK, pose([0.04, 0.0, 0.0, 0.0, 0.005, 0.0])))
    T_lr = pose([0.01, -0.01, 0.02, 0.005, 0.0, -0.004])
    want = jcal.kinect_calibration(*map(jnp.asarray, (points, live, points, ref, KcT, T_lr)), 60.0)
    got = tcal.kinect_calibration(*map(t, (points, live, points, ref, KcT, T_lr)), 60.0)
    assert got.JTJ.shape == (12, 12)
    compare_lss(got, want)


def stereo_observations(seed=15):
    rng = np.random.default_rng(seed)
    jK_true, _ = both_K(52.0, 49.0, 31.0, 24.5)
    T_true = np.asarray(jse3.make(np.eye(3), [-0.1, 0.01, 0.0]))
    pts = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(2, 4, 60)
    obs_l = np.asarray(jK_true.project(jnp.asarray(pts)))
    obs_r = np.asarray(jK_true.project(jse3.transform(jnp.asarray(T_true), jnp.asarray(pts))))
    return pts, obs_l, obs_r, T_true


def jax_reprojection_residuals(theta, T_rl0, points_w, obs_l, obs_r):
    """The residual closure of the JAX package's stereo_intrinsics_refine."""
    fu, fv, u0, v0 = theta[0], theta[1], theta[2], theta[3]
    T_rl = jse3.compose(jse3.exp(theta[4:10]), T_rl0)
    P_r = points_w @ T_rl[:, :3].T + T_rl[:, 3]

    def proj(P):
        return jnp.stack([u0 + fu * P[..., 0] / P[..., 2], v0 + fv * P[..., 1] / P[..., 2]],
                         axis=-1)

    return jnp.concatenate([(proj(points_w) - obs_l).ravel(), (proj(P_r) - obs_r).ravel()])


@pytest.mark.parametrize("xi", [[0.0] * 6, [0.01, -0.02, 0.005, 0.02, -0.01, 0.015]])
def test_reprojection_jacobian_matches_jax(xi):
    pts, obs_l, obs_r, _ = stereo_observations()
    theta = np.array([45.0, 46.0, 32.0, 24.0] + xi, np.float32)
    T0 = np.asarray(jse3.make(np.eye(3), [-0.12, 0.0, 0.0]))
    want = jax.jacfwd(jax_reprojection_residuals)(*map(jnp.asarray, (theta, T0, pts, obs_l,
                                                                      obs_r)))
    got = torch.func.jacfwd(tcal.reprojection_residuals)(*map(t, (theta, T0, pts, obs_l, obs_r)))
    assert got.shape == (240, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAC_ATOL, rtol=1e-6)
    np.testing.assert_allclose(tcal.reprojection_residuals(*map(t, (theta, T0, pts, obs_l,
                                                                    obs_r))).numpy(),
                               np.asarray(jax_reprojection_residuals(
                                   *map(jnp.asarray, (theta, T0, pts, obs_l, obs_r)))),
                               atol=1e-4, rtol=0)


def test_stereo_intrinsics_refine_matches_jax():
    pts, obs_l, obs_r, T_true = stereo_observations()
    jK0, tK0 = both_K(45.0, 45.0, 32.0, 24.0)
    T0 = np.asarray(jse3.make(np.eye(3), [-0.12, 0.0, 0.0]))
    jK, jT = jcal.stereo_intrinsics_refine(pts, obs_l, obs_r, jK0, T0, iterations=8)
    tK, tT = tcal.stereo_intrinsics_refine(pts, obs_l, obs_r, tK0, t(T0), iterations=8,
                                           device="cpu")
    np.testing.assert_allclose([tK.fu, tK.fv, tK.u0, tK.v0],
                               [float(jK.fu), float(jK.fv), float(jK.u0), float(jK.v0)],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=POSE_ATOL, rtol=0)
    assert abs(tK.fu - 52.0) < 0.1 and np.abs(tT.numpy()[:, 3] - T_true[:, 3]).max() < 1e-3


# --- Manhattan frame --------------------------------------------------------------------


def grid_image():
    """Vertical and horizontal stripes (edges along the camera axes) over a
    little noise."""
    img = np.random.default_rng(16).uniform(0, 20, (H, W)).astype(np.float32)
    img[:, ::8] = 255.0
    img[::8, :] = 255.0
    return img


@pytest.mark.parametrize("xi", [[0.0] * 6, [0.0, 0.0, 0.0, 0.03, -0.02, 0.04]])
def test_manhattan_line_cost_matches_jax(xi):
    jK, tK = both_K(40.0)
    img = grid_image()
    R = pose(xi)[:, :3]
    want = jman.manhattan_line_cost(jnp.asarray(img), jnp.asarray(R), jK)
    compare_lss(tman.manhattan_line_cost(t(img), t(R), tK), want)
    jdx, jdy = jman._holoborodko(jnp.asarray(img))
    tdx, tdy = tman._holoborodko(t(img))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tdy.numpy(), np.asarray(jdy), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", ["tilted", "flat"])
def test_estimate_manhattan_rotation_matches_jax(case):
    """From a tilted start on the stripes; and a flat image, whose empty
    system is singular: both packages hold the start rotation."""
    jK, tK = both_K(40.0)
    img = grid_image() if case == "tilted" else np.full((H, W), 7.0, np.float32)
    R0 = pose([0.0, 0.0, 0.0, 0.02, -0.015, 0.03])[:, :3]
    want = np.asarray(jman.estimate_manhattan_rotation(jnp.asarray(img), jK, R0, iterations=5))
    got = tman.estimate_manhattan_rotation(t(img), tK, t(R0), iterations=5).numpy()
    np.testing.assert_allclose(got, want, atol=POSE_ATOL, rtol=0)
    if case == "flat":
        np.testing.assert_allclose(got, R0, atol=1e-6, rtol=0)


# --- rectification ----------------------------------------------------------------------


@pytest.mark.parametrize("rig", ["identity", "tilted"])
def test_scanline_rectification_matches_jax(rig):
    jKl, tKl = both_K(50.0)
    jKr, tKr = both_K(51.0, 50.5, 32.0, 23.0)
    if rig == "identity":
        T_rl, dist = np.asarray(jse3.make(np.eye(3), [-0.1, 0.0, 0.0])), (0.0,) * 4
    else:
        R = pose([0, 0, 0, 0.02, 0.03, 0.01])[:, :3]
        T_rl = np.asarray(jse3.make(R, R @ np.array([-0.1, 0.004, 0.002], np.float32)))
        dist = (-0.05, 0.01, 0.03, -0.002)
    want = jrect.create_scanline_rectified_lookup(W, H, T_rl, jKl, jKr, *dist)
    got = trect.create_scanline_rectified_lookup(W, H, t(T_rl), tKl, tKr, *dist, device="cpu")
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == (H, W, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert trect.baseline_from_t_rl(t(T_rl)) == jrect.baseline_from_t_rl(T_rl)


# --- pose graph -------------------------------------------------------------------------


def graph_inputs(n=6, seed=17):
    """A chain of n keyframes with noisy starts, its odometry edges, two
    loop closures and a prior on keyframe 2."""
    rng = np.random.default_rng(seed)
    true = [np.eye(3, 4, dtype=np.float32)]
    for k in range(n - 1):
        step = np.array([0.5, 0.0, 0.1 * k, 0.0, 0.02, 0.3], np.float32)
        true.append(np.asarray(jse3.compose(jnp.asarray(true[-1]), jse3.exp(jnp.asarray(step)))))
    starts = [true[0]] + [np.asarray(jse3.compose(jnp.asarray(T), jse3.exp(jnp.asarray(
        rng.normal(0, 0.05, 6).astype(np.float32))))) for T in true[1:]]
    rel = lambda i, j: np.asarray(jse3.compose(jse3.inverse(jnp.asarray(true[j])),  # noqa: E731
                                               jnp.asarray(true[i])))
    edges = [(k, k + 1, rel(k, k + 1)) for k in range(n - 1)] + [(0, n - 1, rel(0, n - 1)),
                                                                  (1, n - 2, rel(1, n - 2))]
    priors = [(2, true[2])]
    return true, starts, edges, priors


def graphs(starts, edges, priors):
    jg, tg = jpg.PoseGraph(), tpg.PoseGraph()
    for T in starts:
        jg.add_keyframe(T)
        tg.add_keyframe(t(T))
    for i, j, T in edges:
        jg.add_relative_edge(i, j, T)
        tg.add_relative_edge(i, j, T)
    for i, T in priors:
        jg.add_prior(i, T)
        tg.add_prior(i, T)
    return jg, tg


def jax_graph_residuals(xi_flat, poses, edges, priors):
    """The residual closure of the JAX package's PoseGraph.optimize."""
    n = poses.shape[0]
    xi = xi_flat.reshape(n, 6)
    Ts = [jse3.compose(jse3.exp(xi[k]), poses[k]) for k in range(n)]
    rs = [jse3.log(jse3.compose(jse3.inverse(T_ji), jse3.compose(jse3.inverse(Ts[j]), Ts[i])))
          for i, j, T_ji in edges]
    rs += [jse3.log(jse3.compose(jse3.inverse(T_wi), Ts[i])) for i, T_wi in priors]
    return jnp.concatenate(rs)


@pytest.mark.parametrize("at", ["zero", "away"])
def test_pose_graph_jacobian_matches_jax(at):
    """At xi = 0 the exp and log branches (torch.where / jnp.where) take the
    small-angle side, away from it the other; forward mode differentiates
    both sides and must pick the same one as JAX."""
    _, starts, edges, priors = graph_inputs()
    n = len(starts)
    x = (np.zeros(6 * n, np.float32) if at == "zero"
         else np.random.default_rng(18).normal(0, 0.05, 6 * n).astype(np.float32))
    jedges = [(i, j, jnp.asarray(T)) for i, j, T in edges]
    jpriors = [(i, jnp.asarray(T)) for i, T in priors]
    want = jax.jacfwd(jax_graph_residuals)(jnp.asarray(x), jnp.asarray(np.stack(starts)), jedges,
                                            jpriors)
    got = torch.func.jacfwd(tpg.graph_residuals)(
        t(x), t(np.stack(starts)), *tpg.pack_constraints(edges, priors, device="cpu"))
    assert got.shape == (6 * (len(edges) + len(priors)), 6 * n)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAC_ATOL, rtol=1e-5)


def test_pose_graph_optimize_matches_jax():
    true, starts, edges, priors = graph_inputs()
    jg, tg = graphs(starts, edges, priors)
    want = jg.optimize(iterations=4)
    got = tg.optimize(iterations=4, device="cpu")
    assert abs(got - want) <= 1e-5 + 1e-3 * want
    assert got < 1e-3
    for g, w in zip(tg.poses, jg.poses):
        assert g.dtype == np.float32 and g.shape == (3, 4)
        np.testing.assert_allclose(g, np.asarray(w), atol=POSE_ATOL, rtol=0)
    np.testing.assert_array_equal(tg.poses[0], starts[0])  # fix_first


def test_pose_graph_prior_and_background_solve():
    """fix_first=False with a prior moves the first pose as the JAX package
    does; start() runs the same solve on a thread, stop() ends it."""
    jg, tg = jpg.PoseGraph(), tpg.PoseGraph()
    for g in (jg, tg):
        g.add_keyframe(pose([0.3, 0, 0, 0, 0, 0.2]))
        g.add_prior(0, np.eye(3, 4, dtype=np.float32))
    jg.optimize(iterations=4, fix_first=False)
    tg.start(iterations=4, fix_first=False, device="cpu")
    tg.join()
    assert not tg.running
    np.testing.assert_allclose(tg.poses[0], np.asarray(jg.poses[0]), atol=POSE_ATOL, rtol=0)
    tg.start(iterations=1000, device="cpu")
    tg.stop()
    assert not tg.running and tg._thread is None
    assert tpg.PoseGraph().optimize(device="cpu") == 0.0


def test_pose_files_match_jax(tmp_path):
    src = tmp_path / "poses.txt"
    src.write_text("1 0 0 0 0 1 0 0 0 0 1 5\n0.1 0.2 0.3 0.05 -0.1 0.2\n\n"
                   "0.5, 0, 0, 1, 0, 1, 0, 2, 0, 0, 1, 3\n")
    got, want = tpg.load_poses_from_file(str(src)), jpg.load_poses_from_file(str(src))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tpg.save_poses_to_file(str(tmp_path / "t.txt"), [t(T) for T in got])
    jpg.save_poses_to_file(str(tmp_path / "j.txt"), want)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    (tmp_path / "bad.txt").write_text("1 2 3\n")
    for mod in (tpg, jpg):
        with pytest.raises(ValueError):
            mod.load_poses_from_file(str(tmp_path / "bad.txt"))
