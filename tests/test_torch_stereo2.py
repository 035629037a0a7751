"""The stereo2 app's tail: the robust plane fit, heightmap fusion and
``Stereo2App``, kangaroo_tpu_torch against kangaroo_tpu on the CPU. The same
NumPy inputs from a seed go through both.

Tolerances: one GN system (JTJ, JTy) 1e-5 of its largest entry (float32
sums over the image in another order); ``make_q_inv`` and the plane's pose
1e-6; the fitted normal n_c within 1e-4 of its length after the 105-step
reset (the GN steps compound the sums' last bits); heightmap counts exactly, means
1e-5 relative; the triangle-strip index buffer exactly, and the heightmap
mesh's .ply file byte for byte; the app's disparity
>= 99.5 % of pixels both NaN or within 1e-3 px, as the SGM frame's.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_stereo2.py``
prints the JAX package's ``Stereo2App`` figures at VGA/64 on
``stereo_pair(640, 480, 64, seed=0)`` (focal 500, baseline 0.08, an 8 m
heightmap of 0.1 m cells): the reset frame's and the steady frame's
invalid fraction and median error, n_c and the plane's depth -1/n_z, the
references of chip_smoke.py's limits.
"""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.apps import stereo_sgm as jss
from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu.core import se3 as jse3
from kangaroo_tpu.geometry import heightmap as jhm
from kangaroo_tpu.solvers import plane_fit as jpf
from kangaroo_tpu_torch.apps import stereo_sgm as tss
from kangaroo_tpu_torch.containers import Intrinsics
from kangaroo_tpu_torch.core import se3 as tse3
from kangaroo_tpu_torch.geometry import heightmap as thm
from kangaroo_tpu_torch.solvers import plane_fit as tpf


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def plane_points(W=40, H=30, seed=0, outliers=0.2):
    """A noisy plane z = 2.5 + 0.1 x - 0.05 y seen by a camera of focal 50,
    with a share of outlier points off it and a few NaN ones: (H, W, 4)."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    ray = np.stack([(u - W / 2) / 50, (v - H / 2) / 50, np.ones_like(u)], -1)
    # n . P = -1 with n = (0.04, -0.02, -0.4)
    n = np.array([0.04, -0.02, -0.4], np.float32)
    z = -1.0 / (ray @ n)
    z = z + rng.normal(0, 0.01, z.shape)
    off = rng.random(z.shape) < outliers
    z[off] *= rng.uniform(0.3, 0.8, off.sum())
    P = (ray * z[..., None]).astype(np.float32)
    P[rng.random(z.shape) < 0.02] = np.nan
    return np.concatenate([P, np.ones((H, W, 1), np.float32)], -1)


def close_normal(got, want, rel=1e-4):
    """Within ``rel`` of the normal's length (a component near 0 has no
    relative precision of its own)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.linalg.norm(want)))


def close_to_scale(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


# --- plane fit ------------------------------------------------------------------------


def test_make_q_inv_and_gn_system_match_jax():
    jK, tK = kt.Intrinsics.centered(50.0, 40, 30), Intrinsics.centered(50.0, 40, 30)
    want_q = np.asarray(jpf.make_q_inv(jK, 40, 30))
    got_q = tpf.make_q_inv(tK, 40, 30, device="cpu")
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=1e-6)
    pts = plane_points()
    for c in (0.1, 2.0):
        z = np.array([0.2, 0.3, 0.25], np.float32)
        want = jpf.plane_fit_gn(jnp.asarray(pts), jnp.asarray(want_q), jnp.asarray(z), c=c)
        got = tpf.plane_fit_gn(t(pts), got_q, t(z), c=c)
        close_to_scale(got.JTJ.numpy(), want.JTJ, 1e-5)
        close_to_scale(got.JTy.numpy(), want.JTy, 1e-5)
        assert float(got.obs) == float(want.obs)


@pytest.mark.parametrize("start", ["default", "near"])
def test_fit_plane_matches_jax(start):
    """The app's annealed 105-step reset, from the default z = 0.2 (a plane
    at 5 m) and from 10 % off the true plane."""
    pts = plane_points(128, 96, seed=1)
    jK, tK = kt.Intrinsics.centered(50.0, 128, 96), Intrinsics.centered(50.0, 128, 96)
    jq, tq = jpf.make_q_inv(jK, 128, 96), tpf.make_q_inv(tK, 128, 96, device="cpu")
    z0 = np.linalg.inv(np.asarray(jq)) @ np.array([0.04, -0.02, -0.4], np.float32) * 1.1
    jz = None if start == "default" else jnp.asarray(z0, jnp.float32)
    tz = None if start == "default" else torch.from_numpy(z0.astype(np.float32))
    for c, its in ((8.0, 35), (2.0, 35), (0.5, 35)):
        jn, jz = jpf.fit_plane(jnp.asarray(pts), jq, jz, iterations=its, c=c)
        tn, tz = tpf.fit_plane(t(pts), tq, tz, iterations=its, c=c)
    close_normal(tn.numpy(), jn)
    close_normal(tz.numpy(), jz)
    np.testing.assert_allclose(tn.numpy(), [0.04, -0.02, -0.4], atol=0.01)


def test_fit_plane_skips_a_degenerate_step():
    """No valid point: the solve is NaN, the step is skipped and z stays."""
    pts = np.full((4, 5, 4), np.nan, np.float32)
    q = tpf.make_q_inv(Intrinsics.centered(50.0, 5, 4), 5, 4, device="cpu")
    n, z = tpf.fit_plane(t(pts), q, iterations=3)
    assert torch.equal(z, torch.full((3,), 0.2))
    want_n, want_z = jpf.fit_plane(jnp.asarray(pts), jnp.asarray(q.numpy()), iterations=3)
    np.testing.assert_array_equal(z.numpy(), np.asarray(want_z))


@pytest.mark.parametrize("n", [(0.04, -0.02, -0.4), (0.3, 0.3, -0.1), (-0.5, 0.5, 0.5),
                               (0.0, 0.7, 0.0)])
def test_plane_basis_matches_jax(n):
    """Equal smallest components pick the first axis, as jnp.argmin does."""
    n = np.asarray(n, np.float32)
    got = tpf.plane_basis_wp(t(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(jpf.plane_basis_wp(n)), rtol=1e-6,
                               atol=1e-7)
    R = got[:, :3].numpy()
    np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-6)


# --- heightmap ------------------------------------------------------------------------


def heightmap_inputs(seed=2, H=12, W=16):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-1, 9, (H, W, 2)), rng.uniform(-2, 2, (H, W, 1)),
                          np.ones((H, W, 1))], -1).astype(np.float32)
    pts[rng.random((H, W)) < 0.1, 2] = np.nan
    image = rng.integers(0, 4, (H, W)).astype(np.uint8) * 60
    T = np.asarray(jse3.exp(jnp.asarray([0.2, -0.1, 0.05, 0.01, -0.02, 0.3], jnp.float32)))
    return pts, image, T


@pytest.mark.parametrize("with_image", [False, True])
@pytest.mark.parametrize("limits", [{}, dict(min_height=-1.0, max_height=1.5,
                                               max_distance=1.0)])
def test_update_heightmap_matches_jax(with_image, limits):
    pts, image, T = heightmap_inputs()
    want = jhm.init_heightmap(8, 6)
    got = thm.init_heightmap(8, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in range(3):  # three fuses: running means over repeated samples
        img = image if with_image else None
        want = jhm.update_heightmap(want, pts + k * 0.1, img, T, **limits)
        got = thm.update_heightmap(got, t(pts + k * 0.1), None if img is None else t(img), t(T),
                                   **limits)
    want = np.asarray(want)
    np.testing.assert_array_equal(got[..., 1].numpy(), want[..., 1])
    assert want[..., 1].max() >= 2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_heightmap_views_match_jax():
    pts, image, T = heightmap_inputs(seed=3)
    hm = np.asarray(jhm.update_heightmap(jhm.init_heightmap(8, 6), pts, image, T))
    T_wh = np.asarray(jse3.inverse(jnp.asarray(T)))
    for got, want in ((thm.vbo_from_heightmap(t(hm)), jhm.vbo_from_heightmap(hm)),
                      (thm.vbo_world_from_heightmap(t(hm), t(T_wh)),
                       jhm.vbo_world_from_heightmap(hm, T_wh)),
                      (thm.colour_heightmap(t(hm)), jhm.colour_heightmap(hm))):
        assert got.dtype == torch.from_numpy(np.array(want)).dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for got, want in zip(thm.generate_world_vbo_and_image(t(hm), t(T_wh)),
                         jhm.generate_world_vbo_and_image(hm, T_wh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("w,h", [(1, 1), (2, 3), (5, 4)])
def test_triangle_strip_index_buffer_matches_jax(w, h):
    got = thm.triangle_strip_index_buffer(w, h)
    want = jhm.triangle_strip_index_buffer(w, h)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_heightmap_fusion_matches_jax(tmp_path):
    pts, image, T = heightmap_inputs(seed=4)
    T_hw = np.asarray(jse3.exp(jnp.asarray([0.3, 0.4, 0.0, 0.0, 0.0, 0.1], jnp.float32)))
    want = jhm.HeightmapFusion(1.6, 1.2, 0.2, T_hw=T_hw)
    got = thm.HeightmapFusion(1.6, 1.2, 0.2, T_hw=T_hw, device="cpu")
    assert (got.w, got.h) == (want.w, want.h) == (8, 6)
    np.testing.assert_array_equal(got.T_hw.numpy(), np.asarray(want.T_hw))
    want.fuse(jnp.asarray(pts), jnp.asarray(image))
    got.fuse(t(pts), t(image))
    np.testing.assert_allclose(got.hm.numpy(), np.asarray(want.hm), rtol=1e-5, atol=1e-6)
    for g, w in zip(got.world_vbo(), want.world_vbo()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    assert got.save_mesh(str(tmp_path / "t.ply")) == want.save_mesh(str(tmp_path / "j.ply")) > 0
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


# --- Stereo2App -------------------------------------------------------------------------


W, H, D = 128, 96, 32


def agreement(a, b, tol=1e-3):
    a, b = np.asarray(a), np.asarray(b)
    return float(((np.isnan(a) & np.isnan(b)) | (np.abs(a - b) <= tol)).mean())


def apps(image=False):
    """The JAX package's app test: background depth 2.5 m, outside the fixed
    initial plane's Tukey basin, and a box the robust fit rejects."""
    jcfg = jss.SgmConfig(max_disp=D, census_window="9x7")
    jK, tK = kt.Intrinsics.centered(100.0, W, H), Intrinsics.centered(100.0, W, H)
    kw = dict(hm_size=(8.0, 8.0), hm_cell=0.1, min_disp=1.0)
    return (jss.Stereo2App(jK, 0.2, jcfg, **kw),
            tss.Stereo2App(tK, 0.2, tss.SgmConfig.from_dict(dataclasses.asdict(jcfg)), **kw))


def check_same_state(app, japp, disp, jdisp):
    assert agreement(disp.numpy(), jdisp) >= 0.995
    close_normal(app.n_c.numpy(), japp.n_c)
    want = np.asarray(japp.hm.hm)
    # a point binned differently (a last-bit flip of its cell) moves a count
    assert (app.hm.hm[..., 1].numpy() == want[..., 1]).mean() >= 0.999
    np.testing.assert_allclose(app.hm.T_hw.numpy(), np.asarray(japp.hm.T_hw), rtol=1e-4,
                               atol=1e-5)


def test_stereo2_app_matches_jax():
    left, right, _ = jsyn.stereo_pair(W, H, D, seed=1)
    japp, app = apps()
    for frame in range(2):
        jdisp, jd3d = japp(left, right, image=left)
        disp, d3d = app(t(left), t(right), image=t(left))
        assert disp.shape == (H, W) and d3d.shape == (H, W, 4) and app.hm_initialised
        check_same_state(app, japp, disp, np.asarray(jdisp))
        fin = np.isfinite(np.asarray(jd3d)) & np.isfinite(d3d.numpy())
        np.testing.assert_allclose(d3d.numpy()[fin], np.asarray(jd3d)[fin], rtol=1e-3)
    assert abs(-1.0 / float(app.n_c[2]) - 2.5) < 0.2


def test_stereo2_app_resumes_from_the_jax_state():
    """The port takes the JAX app's state after its reset frame and runs the
    steady frame: the same plane and heightmap as the JAX app's frame 2."""
    left, right, _ = jsyn.stereo_pair(W, H, D, seed=1)
    japp, app = apps()
    japp(left, right)
    tss.state_from_numpy(app, japp.z, japp.n_c, japp.hm.hm, japp.hm.T_hw, japp._hm_init,
                         device="cpu")
    assert app.hm.w == japp.hm.w and app.hm.h == japp.hm.h
    jdisp, _ = japp(left, right)
    disp, _ = app(t(left), t(right))
    check_same_state(app, japp, disp, np.asarray(jdisp))


def test_stereo2_app_without_plane_or_heightmap():
    left, right, _ = jsyn.stereo_pair(64, 32, 16, seed=2)
    K = Intrinsics.centered(60.0, 64, 32)
    app = tss.Stereo2App(K, 0.2, tss.SgmConfig(max_disp=16, census_window="9x7"),
                         plane_fit=False, hm_size=(4.0, 4.0))
    app(t(left), t(right), T_wc=tse3.identity(device="cpu"))
    assert app.n_c is None and app.hm.w == 40 and bool(app.hm.hm[..., 1].sum() > 0)
    # the grid without a plane: the identity scaled to cells
    assert torch.equal(app.hm.T_hw, torch.tensor([[10.0, 0.0, 0.0, 0.0], [0.0, 10.0, 0.0, 0.0],
                                                  [0.0, 0.0, 1.0, 0.0]]))
    app = tss.Stereo2App(K, 0.2, tss.SgmConfig(max_disp=16, census_window="9x7"),
                         heightmap=False)
    app(t(left), t(right))
    assert app.hm is None and app.n_c is not None


def jax_reference(w=640, h=480, max_disp=64):
    """The JAX package's Stereo2App on stereo_pair(w, h, max_disp, seed=0):
    focal 500 (background depth 500 * 0.08 / 16 = 2.5 m), 16x16 census,
    8 m heightmap of 0.1 m cells; the reset frame and one steady frame."""
    left, right, gt = jsyn.stereo_pair(w, h, max_disp, seed=0)
    app = jss.Stereo2App(kt.Intrinsics.centered(500.0, w, h), 0.08,
                         jss.SgmConfig(max_disp=max_disp), hm_size=(8.0, 8.0), hm_cell=0.1)
    out = {}
    for name in ("reset", "steady"):
        disp, _ = app(left, right, image=left)
        d, g = np.asarray(disp), np.asarray(gt)
        inner = np.zeros(d.shape, bool)
        inner[8:-8, max_disp + 8:-8] = True
        m = np.isfinite(d) & inner
        n = np.asarray(app.n_c, np.float64)
        out[name] = {"invalid_frac": float(1.0 - m.sum() / inner.sum()),
                     "median_err_px": float(np.median(np.abs(d[m] - g[m]))),
                     "n_c": n.tolist(), "plane_depth_m": float(-1.0 / n[2]),
                     "heightmap_cells": int((np.asarray(app.hm.hm[..., 1]) > 0).sum())}
    return out


if __name__ == "__main__":
    import json

    print(json.dumps(jax_reference(*map(int, sys.argv[1:]))))
