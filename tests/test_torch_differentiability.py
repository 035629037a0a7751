"""The fuses' reverse mode against ``jax.grad``: the port's gradients of
tests/test_differentiability.py's fuse and raycast cases (a 16^3 volume,
32x24 depth of a plane at 3 m; the separable raycast of a sphere at 24x16)
and of the colour fuse on the same scene, through
``kangaroo_tpu_torch.fusion`` on the CPU (the separable fuse's autograd op:
its forward the plain loop on copies of the volume, its backward the
out-of-place plain loop's vector-Jacobian product).

Tolerance: every gradient within 1e-4 of the largest entry of the JAX
package's (the two packages' forward passes agree to 1e-5 and the
gradients run through the same float32 formulas in another order), the
raycast's within 5e-4 (1.6e-4 measured: the crossing's interpolation
divides by the difference of two planes' values), and nonzero where the
JAX package's is. The JAX package differentiates its windowed fuse with
respect to the depth only (its custom_vjp cannot close over a traced
volume or pose), so the gradients with respect to the volume and the pose
are held to ``jax.grad`` of its full sweep (``clip_planes=False``, equal to
the window by construction). At voxels of zero weight that the fuse does not update, the
JAX package's gradient with respect to the weight is NaN: the backward of
its blend's division by max(w, 1e-20) squares 1e-20 into a subnormal that
XLA on the CPU flushes to zero (0 / 0). The port's is 0 there, the
gradient of the passthrough; elsewhere the two are held to the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.core import se3 as jse3
from kangaroo_tpu.fusion import sdf as jsdf
from kangaroo_tpu.fusion import separable as jsep
from kangaroo_tpu.geometry import depth as jdepth
from kangaroo_tpu_torch.containers import BoundedVolume, BoundingBox, Intrinsics, TsdfVolume
from kangaroo_tpu_torch.fusion import sdf as tsdf
from kangaroo_tpu_torch.fusion import separable as tsep
from kangaroo_tpu_torch.geometry import depth as tdepth

W, H = 32, 24
GRAD_RTOL = 1e-4


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _jax_grad(fn, **kw):
    """``jax.grad`` compiled as one program (op by op it takes seconds)."""
    return jax.jit(jax.grad(fn, **kw))


def _close(got, want, rtol=GRAD_RTOL, where=None):
    got, want = got.numpy(), np.asarray(want)
    if where is not None:
        got, want = got[where], want[where]
    scale = float(np.abs(want).max())
    assert scale > 0.0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def plane():
    """tests/test_differentiability.py's fuse scene: the JAX and port
    intrinsics, an empty 16^3 volume (trunc 0.2), T_cw and depth 3 m."""
    K = kt.Intrinsics.centered(30.0, W, H)
    bbox = kt.BoundingBox.create((-1, -1, -1), (1, 1, 1))
    vol = kt.TsdfVolume.create(16, 16, 16, bbox, trunc_dist=0.2)
    T_cw = jse3.inverse(jnp.asarray(jse3.make(np.eye(3), [0.0, 0.0, -3.0])))
    tK = Intrinsics.create(float(K.fu), float(K.fv), float(K.u0), float(K.v0))
    tvol = TsdfVolume(t(vol.val), t(vol.weight),
                      BoundingBox.create(np.asarray(bbox.lo), np.asarray(bbox.hi), device="cpu"))
    return K, tK, vol, tvol, T_cw, np.full((H, W), 3.0, np.float32)


def _jax_loss(fuse, K, vol, T_cw):
    def loss(depth):
        norm = jdepth.normals_from_vbo(jdepth.depth_to_vbo(depth, K))
        out = fuse(vol, depth, norm, T_cw, K)
        return jnp.sum(jnp.where(out.weight > 0, out.val, 0.0) ** 2)

    return loss


def _port_grad(fuse, tK, tvol, T_cw, depth0):
    depth = t(depth0).requires_grad_(True)
    norm = tdepth.normals_from_vbo(tdepth.depth_to_vbo(depth, tK))
    out = fuse(tvol, depth, norm, t(T_cw), tK)
    torch.sum(torch.where(out.weight > 0, out.val, 0.0) ** 2).backward()
    return depth.grad


def test_voxel_fuse_grad_wrt_depth(plane):
    K, tK, vol, tvol, T_cw, depth0 = plane
    want = _jax_grad(_jax_loss(lambda v, d, n, T, K_: jsdf.sdf_fuse(v, d, n, T, K_, 0.2),
                               K, vol, T_cw))(jnp.asarray(depth0))
    got = _port_grad(lambda v, d, n, T, K_: tsdf.sdf_fuse(v, d, n, T, K_, 0.2), tK, tvol, T_cw,
                     depth0)
    _close(got, want)


def test_separable_fuse_grad_wrt_depth(plane):
    K, tK, vol, tvol, T_cw, depth0 = plane
    want = _jax_grad(_jax_loss(
        lambda v, d, n, T, K_: jsep.sdf_fuse_separable(v, d, n, T, K_, 0.2, 1000.0, 0.1,
                                                       sweep_axis=0), K, vol, T_cw))(
        jnp.asarray(depth0))
    got = _port_grad(lambda v, d, n, T, K_: tsep.sdf_fuse_separable(v, d, n, T, K_, 0.2, 1000.0,
                                                                    0.1, sweep_axis=0),
                     tK, tvol, T_cw, depth0)
    _close(got, want)


def _fused_twice(plane):
    """The JAX package's volume after one fuse at 3 m, and the port's copy:
    the second fuse then blends over nonzero weights."""
    K, tK, vol, tvol, T_cw, depth0 = plane
    d = jnp.asarray(depth0) - 0.1
    norm = jdepth.normals_from_vbo(jdepth.depth_to_vbo(d, K))
    v1 = jsep.sdf_fuse_separable(vol, d, norm, T_cw, K, 0.2, 1000.0, 0.1, sweep_axis=0)
    return v1, TsdfVolume(t(v1.val), t(v1.weight), tvol.bbox)


@pytest.mark.parametrize("enable", [True, False])
def test_separable_fuse_grads_wrt_every_input(plane, enable):
    """Gradients with respect to the volume, the depth, the normals and the
    pose on a fused volume (the port's windowed fuse against the JAX
    package's full sweep); enable=False passes the volume through, so the
    gradient with respect to val is the identity's and the others vanish."""
    K, tK, vol, tvol, T_cw, depth0 = plane
    v1, tv1 = _fused_twice(plane)
    norm0 = np.asarray(jdepth.normals_from_vbo(jdepth.depth_to_vbo(jnp.asarray(depth0), K)))
    rng = np.random.default_rng(3)
    depth0 = depth0 + 0.05 * rng.standard_normal(depth0.shape).astype(np.float32)
    wv = rng.standard_normal(vol.val.shape).astype(np.float32)

    def jloss(val, weight, depth, normals, T):
        out = jsep.sdf_fuse_separable(kt.TsdfVolume(val, weight, vol.bbox), depth, normals, T, K,
                                      0.2, 1000.0, 0.1, sweep_axis=0,
                                      enable=jnp.asarray(enable), clip_planes=False)
        return jnp.sum(jnp.asarray(wv) * out.val) + 0.01 * jnp.sum(out.weight ** 2)

    want = _jax_grad(jloss, argnums=(0, 1, 2, 3, 4))(v1.val, v1.weight, jnp.asarray(depth0),
                                                    jnp.asarray(norm0), T_cw)

    leaves = [t(a).requires_grad_(True) for a in (v1.val, v1.weight, depth0, norm0, T_cw)]
    out = tsep.sdf_fuse_separable(TsdfVolume(leaves[0], leaves[1], tv1.bbox), *leaves[2:], tK,
                                  0.2, 1000.0, 0.1, sweep_axis=0, enable=torch.tensor(enable))
    (torch.sum(t(wv) * out.val) + 0.01 * torch.sum(out.weight ** 2)).backward()
    fused = np.asarray(v1.weight) > 0
    nan_w = np.isnan(np.asarray(want[1]))
    assert not (nan_w & fused).any() and nan_w.sum() > 1000
    assert float(leaves[1].grad[torch.from_numpy(nan_w)].abs().max()) == 0.0
    for name, leaf, w in zip(("val", "weight", "depth", "normals", "T_cw"), leaves, want):
        if np.nanmax(np.abs(np.asarray(w))) == 0.0:
            assert float(leaf.grad.abs().max()) == 0.0, name
        else:
            _close(leaf.grad, w, where=~nan_w if name == "weight" else None)
    if not enable:
        assert torch.equal(leaves[0].grad, t(wv))
        assert float(leaves[2].grad.abs().max()) == float(leaves[4].grad.abs().max()) == 0.0


def test_colour_fuse_grads(plane):
    """The colour fuse on the same scene: gradients with respect to the
    depth, the colour volume and the image."""
    K, tK, vol, tvol, T_cw, depth0 = plane
    cvol = kt.BoundedVolume.create(16, 16, 16, vol.bbox, fill=0.5)
    rgb = np.random.default_rng(1).uniform(0, 255, (H, W, 3)).astype(np.float32)
    T_iw = jse3.compose(jnp.asarray(jse3.inverse(jse3.make(np.eye(3), [0.05, 0.0, 0.0]))), T_cw)

    def jloss(depth, colour, img):
        norm = jdepth.normals_from_vbo(jdepth.depth_to_vbo(depth, K))
        v, c = jsep.sdf_fuse_color_separable(vol, kt.BoundedVolume(colour, vol.bbox), depth, norm,
                                             T_cw, K, img, T_iw, K, 0.2, 1000.0, 0.1,
                                             sweep_axis=0)
        return jnp.sum(jnp.where(v.weight > 0, v.val, 0.0) ** 2) + jnp.sum(c.data ** 2)

    want = _jax_grad(jloss, argnums=(0, 1, 2))(jnp.asarray(depth0), cvol.data, jnp.asarray(rgb))
    depth, colour, img = (t(a).requires_grad_(True) for a in (depth0, cvol.data, rgb))
    norm = tdepth.normals_from_vbo(tdepth.depth_to_vbo(depth, tK))
    v, c = tsep.sdf_fuse_color_separable(tvol, BoundedVolume(colour, tvol.bbox), depth, norm,
                                         t(T_cw), tK, img, t(T_iw), tK, 0.2, 1000.0, 0.1,
                                         sweep_axis=0)
    assert float(colour.detach().max()) == 0.5  # value semantics under grad
    (torch.sum(torch.where(v.weight > 0, v.val, 0.0) ** 2) + torch.sum(c.data ** 2)).backward()
    for leaf, w in zip((depth, colour, img), want):
        _close(leaf.grad, w)


def test_separable_raycast_grad_wrt_volume():
    """tests/test_differentiability.py's sphere at 24x16."""
    w, h = 24, 16
    K = kt.Intrinsics.centered(22.0, w, h)
    bbox = kt.BoundingBox.create((-1, -1, -1), (1, 1, 1))
    vol = jsdf.sdf_sphere(kt.TsdfVolume.create(16, 16, 16, bbox, trunc_dist=0.3),
                          (0.0, 0.0, 0.0), 0.6)
    T_wc = jnp.asarray(jse3.make(np.eye(3), [0.0, 0.0, -3.0]))

    def jloss(val):
        d, _, _ = jsep.raycast_sdf_separable(kt.TsdfVolume(val, vol.weight + 1.0, bbox), T_wc,
                                             K, w, h, near=0.5, far=6.0, trunc_dist=0.3,
                                             sweep_axis=0)
        return jnp.sum(jnp.where(jnp.isfinite(d), d, 0.0))

    want = _jax_grad(jloss)(vol.val)
    val = t(vol.val).requires_grad_(True)
    tb = BoundingBox.create(np.asarray(bbox.lo), np.asarray(bbox.hi), device="cpu")
    d, _, _ = tsep.raycast_sdf_separable(
        TsdfVolume(val, t(vol.weight) + 1.0, tb),
        t(T_wc), Intrinsics.create(float(K.fu), float(K.fv), float(K.u0), float(K.v0)), w, h,
        near=0.5, far=6.0, trunc_dist=0.3, sweep_axis=0)
    torch.sum(torch.where(torch.isfinite(d), d, 0.0)).backward()
    _close(val.grad, want, rtol=5e-4)


def test_inplace_with_grad_raises(plane):
    K, tK, vol, tvol, T_cw, depth0 = plane
    depth = t(depth0).requires_grad_(True)
    norm = tdepth.normals_from_vbo(tdepth.depth_to_vbo(depth, tK))
    with pytest.raises(ValueError, match="inplace"):
        tsep.sdf_fuse_separable(tvol, depth, norm, t(T_cw), tK, 0.2, inplace=True)
    cvol = BoundedVolume(torch.full((16, 16, 16), 0.5), tvol.bbox)
    with pytest.raises(ValueError, match="inplace"):
        tsep.sdf_fuse_color_separable(tvol, cvol, depth, norm, t(T_cw), tK,
                                      torch.zeros(H, W, 3), t(T_cw), tK, 0.2, inplace=True)
    copy = TsdfVolume(tvol.val.clone(), tvol.weight.clone(), tvol.bbox)
    with torch.no_grad():  # no graph: in place is fine
        out = tsep.sdf_fuse_separable(copy, depth, norm, t(T_cw), tK, 0.2, inplace=True)
    assert out.val is copy.val and float(copy.weight.max()) > 0
