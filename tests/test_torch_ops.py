"""The image ops of kangaroo_tpu_torch against kangaroo_tpu on the CPU:
invalid sentinels, elementwise arithmetic, pixel conversion, the cubic
samplers and central differences, the rectification lookup and warp, the
feature detectors and the visualisation helpers. Inputs are NumPy arrays
from a seed, fed to both, at two small sizes (one odd each way).

Tolerances: exact for the sentinels, conversions, segment test,
non-maximal suppression, index compaction, anaglyph and painting; uint8
warps within 1 LSB (a truncation at an integer boundary can flip, because
XLA on the CPU may contract a product and a sum into one FMA, which
PyTorch rounds twice); float outputs within 1e-5 relative and 1e-6
absolute ([0, 1] images; coordinates and lookups, in pixels, 1e-5
relative and 1e-4 absolute).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kangaroo_tpu.core import invalid as jinv
from kangaroo_tpu.core import sampling as jsamp
from kangaroo_tpu.ops import convert as jconv
from kangaroo_tpu.ops import elementwise as jel
from kangaroo_tpu.ops import features as jfeat
from kangaroo_tpu.ops import viz as jviz
from kangaroo_tpu.ops import warp as jwarp
from kangaroo_tpu_torch.core import invalid as tinv
from kangaroo_tpu_torch.core import sampling as tsamp
from kangaroo_tpu_torch.ops import convert as tconv
from kangaroo_tpu_torch.ops import elementwise as tel
from kangaroo_tpu_torch.ops import features as tfeat
from kangaroo_tpu_torch.ops import viz as tviz
from kangaroo_tpu_torch.ops import warp as twarp

SIZES = [(23, 37), (24, 32)]
RTOL, ATOL = 1e-5, 1e-6


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def image(shape, seed=0):
    """A [0, 1] image with texture, an edge and noise."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    img = 0.5 + 0.3 * np.sin(u / 3.0) * np.cos(v / 4.0) + 0.2 * (u > shape[1] / 2)
    return np.clip(img + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)


def corners_image(shape, seed=0):
    """uint8 blocks and dots on noise: corners for the segment test."""
    rng = np.random.default_rng(seed)
    img = rng.integers(90, 110, shape).astype(np.uint8)
    img[5:12, 6:15] = 200
    img[14:19, 20:27] = 20
    img[rng.random(shape) < 0.03] = 250
    return img


@pytest.mark.parametrize("dtype", ["float32", "uint8", "uint16", "int32", "int8"])
def test_invalid_like_and_np_invalid_value(dtype):
    a = np.arange(6, dtype=dtype).reshape(2, 3)
    same(tinv.invalid_like(t(a)).numpy(), jinv.invalid_like(jnp.asarray(a)))
    got, want = tinv.np_invalid_value(dtype), jinv.np_invalid_value(dtype)
    assert type(got) is type(want) and (got == want or (np.isnan(got) and np.isnan(want)))


@pytest.mark.parametrize("shape", SIZES)
def test_elementwise_matches_jax(shape):
    a, b, c = image(shape, 1), image(shape, 2), image(shape, 3)
    u8 = (255 * a).astype(np.uint8)
    same(tel.fill(t(u8), 7).numpy(), jel.fill(u8, 7))
    for got, want in (
            (tel.scale_bias(t(u8), 1.0 / 255.0, 0.25), jel.scale_bias(u8, 1.0 / 255.0, 0.25)),
            (tel.add(t(a), t(b), 0.3, -0.7, 0.1), jel.add(a, b, 0.3, -0.7, 0.1)),
            (tel.multiply(t(a), t(u8), 0.5), jel.multiply(a, u8, 0.5)),
            (tel.divide(t(a), t(b), 2.0, 3.0, 0.1), jel.divide(a, b, 2.0, 3.0, 0.1)),
            (tel.square(t(u8)), jel.square(u8)),
            (tel.multiply_add(t(a), t(b), t(c), 0.7, -1.3), jel.multiply_add(a, b, c, 0.7, -1.3)),
            (tel.image_l1(t(a - 0.5)), jel.image_l1(a - 0.5))):
        assert got.dtype == torch.float32
        close(got, want)


@pytest.mark.parametrize("shape", SIZES)
def test_convert_matches_jax(shape):
    rng = np.random.default_rng(4)
    g8 = rng.integers(0, 256, shape).astype(np.uint8)
    rgb8 = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    rgba8 = rng.integers(0, 256, shape + (4,)).astype(np.uint8)
    rgbf = rng.random(shape + (3,)).astype(np.float32)
    for name, args in (("gray_to_rgb", (g8,)), ("gray_to_rgba", (g8,)),
                       ("gray_to_rgba", (g8, 17)), ("rgb_to_gray", (rgb8,)),
                       ("rgb_to_gray", (rgba8,)), ("rgb_to_gray", (rgbf,)),
                       ("rgb_to_rgba", (rgb8,)), ("rgba_to_rgb", (rgba8,)),
                       ("to_float", (g8,)), ("to_float", (rgbf,)), ("to_float", (g8, 0.5)),
                       ("to_uint8", (g8,)), ("to_uint8", (1.2 * rgbf - 0.1,)),
                       ("to_uint8", (g8.astype(np.int32) * 2,))):
        got = getattr(tconv, name)(*(t(a) if isinstance(a, np.ndarray) else a for a in args))
        same(got.numpy(), getattr(jconv, name)(*args))


def coords(shape, n=300, seed=5):
    """Float coordinates inside and around the image, and integer ones."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, shape[1] + 3, n).astype(np.float32)
    y = rng.uniform(-3, shape[0] + 3, n).astype(np.float32)
    return x, y


@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("channels", [None, 3])
def test_cubic_samplers_and_central_diffs_match_jax(shape, channels):
    img = image(shape, 6)
    if channels:
        img = np.stack([img, img[::-1], 1 - img], axis=-1)
    x, y = coords(shape)
    for name in ("bicubic", "catmull_rom"):
        close(getattr(tsamp, name)(t(img), t(x), t(y)),
              getattr(jsamp, name)(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    xi, yi = np.floor(x).astype(np.int32), np.floor(y).astype(np.int32)
    for got, want in zip(tsamp.central_diff(t(img), t(xi), t(yi)),
                         jsamp.central_diff(jnp.asarray(img), jnp.asarray(xi), jnp.asarray(yi))):
        close(got, want)
    if channels:  # the bilinear blend is for (H, W) images in both packages
        return
    for got, want in zip(tsamp.central_diff_bilinear(t(img), t(x), t(y)),
                         jsamp.central_diff_bilinear(jnp.asarray(img), jnp.asarray(x),
                                                     jnp.asarray(y))):
        close(got, want)


# fu, fv, u0, v0, k1, k2 of a VGA-like camera scaled to the test sizes, and
# a homography close to the identity (a small rotation and shift)
LENS = (30.0, 31.0, 17.3, 11.6, -0.21, 0.08)
H_ON = [[0.998, -0.03, 0.6], [0.031, 1.001, -0.4], [1e-4, -2e-4, 1.0]]


@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("H_on", [None, H_ON])
def test_lookup_table_and_warp_match_jax(shape, H_on):
    h, w = shape
    got = twarp.create_matlab_lookup_table(w, h, *LENS, H_on=H_on, device="cpu")
    want = jwarp.create_matlab_lookup_table(w, h, *LENS, H_on=H_on)
    assert got.shape == (h, w, 2) and got.dtype == torch.float32
    close(got, want, atol=1e-4)
    lut = np.asarray(want)
    f = image(shape, 7)
    close(twarp.warp(t(f), t(lut)), jwarp.warp(f, lut))
    u8 = (255 * f).astype(np.uint8)
    g8, w8 = twarp.warp(t(u8), t(lut)).numpy(), np.asarray(jwarp.warp(u8, lut))
    assert g8.dtype == w8.dtype == np.uint8
    assert np.abs(g8.astype(np.int32) - w8.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("shape", SIZES)
def test_features_match_jax(shape):
    img = corners_image(shape, 8)
    for threshold, n in ((20, 6), (40, 3), (5, 9)):
        got = tfeat.segment_test(t(img), threshold, n)
        same(got.numpy(), jfeat.segment_test(img, threshold, n))
    assert tfeat.segment_test(t(img), 20, 6).any()
    f = image(shape, 9)
    score = tfeat.harris_score(t(f))
    close(score, jfeat.harris_score(f), atol=1e-7)
    close(tfeat.harris_score(t(img), 0.06), jfeat.harris_score(img, 0.06), atol=1e-2)
    s = np.asarray(jfeat.harris_score(f))
    for rad, thr in ((1, 0.0), (2, 1e-5), (3, -1.0)):
        same(tfeat.non_maximal_suppression(t(s), rad, thr).numpy(),
             jfeat.non_maximal_suppression(s, rad, thr))
    nms = np.asarray(jfeat.non_maximal_suppression(s, 1, 0.0))
    assert nms.any()
    got_idx = tfeat.get_indices(t(nms), 0)
    same(got_idx, jfeat.get_indices(nms, 0))
    same(tfeat.get_indices(nms, 0), got_idx)


@pytest.mark.parametrize("shape", SIZES)
def test_viz_matches_jax(shape):
    rng = np.random.default_rng(10)
    l8 = rng.integers(0, 256, shape).astype(np.uint8)
    r8 = rng.integers(0, 256, shape).astype(np.uint8)
    same(tviz.make_anaglyph(t(l8), t(r8)).numpy(), jviz.make_anaglyph(l8, r8))
    img = 200 * image(shape, 11)
    img[2, 3] = np.nan
    score = rng.normal(0.0, 1.0, shape).astype(np.float32)
    close(tviz.remap_heat(t(img), t(score), -1.5, 2.0), jviz.remap_heat(img, score, -1.5, 2.0))
    for value, cx, cy, r in ((255, 10.3, 7.7, 5.5), (0, -2.0, 30.0, 9.0)):
        same(tviz.paint_circle(t(l8), value, cx, cy, r).numpy(),
             jviz.paint_circle(l8, value, cx, cy, r))
        same(tviz.paint_circle(t(img), 0.5, cx, cy, r).numpy(),
             jviz.paint_circle(img, 0.5, cx, cy, r))
    vol = rng.random((8,) + shape).astype(np.float32)
    disp = rng.uniform(0, 8, shape).astype(np.float32)
    for y in (0, shape[0] // 2):
        close(tviz.disparity_cross_section(t(vol), t(disp), y),
              jviz.disparity_cross_section(jnp.asarray(vol), jnp.asarray(disp), y))
