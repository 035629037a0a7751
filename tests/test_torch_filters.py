"""The filters of kangaroo_tpu_torch against kangaroo_tpu on the CPU: the
binomial and Gaussian blurs, the cross and volume bilateral filters, the
named medians, integral images and the box mean from one, and the
pyramids. Inputs are NumPy arrays from a seed, fed to both, at two small
sizes (one odd each way).

Tolerances: float outputs within 1e-5 relative and 1e-6 absolute (the
images lie in [0, 1]; XLA on the CPU may contract a product and a sum into
one FMA, which PyTorch rounds twice, and exp differs in the last bit);
integral images and row scans 1e-5 relative (the scans may sum in another
order); uint8 outputs within 1 LSB (a truncation at an integer boundary
can flip); the medians exactly. The volume filter at the SGM frame's
default window (size 18, 1,369 taps) is held to the float64 golden model
``reference_impl.bilateral_cross3`` instead of the JAX package, whose
compile at that size takes minutes.

Run as a script, the file prints the JAX package's CPU-JAX quality of the
bilateral SGM frame at VGA/64 (size 3), which ``chip_smoke.py`` holds the
port's frame on the card to:
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_filters.py``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from kangaroo_tpu.containers import pyramid as jpyr
from kangaroo_tpu.ops import bilateral as jbf
from kangaroo_tpu.ops import blur as jblur
from kangaroo_tpu.ops import integral_image as jii
from kangaroo_tpu.ops import median as jm
from kangaroo_tpu_torch.containers import pyramid as tpyr
from kangaroo_tpu_torch.ops import bilateral as tbf
from kangaroo_tpu_torch.ops import blur as tblur
from kangaroo_tpu_torch.ops import integral_image as tii
from kangaroo_tpu_torch.ops import median as tm

import reference_impl as ref

SIZES = [(23, 37), (24, 32)]
RTOL, ATOL = 1e-5, 1e-6


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def within_1lsb(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def image(shape, seed=0):
    """A smooth [0, 1] image with edges and noise."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    img = 0.5 + 0.3 * np.sin(u / 4.0) * np.cos(v / 5.0) + 0.2 * (u > shape[1] / 2)
    return np.clip(img + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)


def uint8_image(shape, seed=0):
    return (255 * image(shape, seed)).astype(np.uint8)


def volume(shape, D=4, seed=0):
    """A census-like cost volume: k / 256 in [0, 0.5]."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 129, (D,) + shape) / 256.0).astype(np.float32)


@pytest.mark.parametrize("shape", SIZES + [(2, 5)])
def test_blur_matches_jax(shape):
    f = image(shape, 1)
    close(tblur.blur(t(f)), jblur.blur(f))
    u8 = uint8_image(shape, 2)
    within_1lsb(tblur.blur(t(u8)), jblur.blur(u8))


@pytest.mark.parametrize("shape", [(1, 1), (1, 6), (6, 1), (1, 16), (16, 1)])
def test_blur_of_one_row_or_column_matches_jax(shape):
    """An axis of one entry is its own neighbour on both sides: the JAX
    package gives (2 f + f) / 3 there, and its blur_reduce levels below
    come out empty along that axis."""
    for img in (image(shape, 5), uint8_image(shape, 6)):
        got, want = tblur.blur(t(img)), jblur.blur(img)
        assert got.numpy().dtype == np.asarray(want).dtype
        (within_1lsb if img.dtype == np.uint8 else close)(got, want)
        for levels in (1, 3, 5):
            gp, wp = tpyr.blur_reduce(t(img), levels), jpyr.blur_reduce(img, levels)
            assert [tuple(g.shape) for g in gp] == [tuple(w.shape) for w in wp]
            for g, w in zip(gp, wp):
                if g.numel():  # an empty level has nothing more to compare
                    (within_1lsb if img.dtype == np.uint8 else close)(g, w)


@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("sigma,rad", [(2.0, 10), (0.7, 3), (0.0, 2)])
def test_gaussian_blur_matches_jax(shape, sigma, rad):
    """(2.0, 10) is bench.py bench_filters' call; sigma 0 takes the 1e-6
    clamp; rad 10 exceeds the odd image's rows on both sides."""
    f = image(shape, 3)
    close(tblur.gaussian_blur(t(f), sigma, rad=rad), jblur.gaussian_blur(f, sigma, rad=rad))
    u8 = uint8_image(shape, 4)
    within_1lsb(tblur.gaussian_blur(t(u8), sigma, rad=rad),
                jblur.gaussian_blur(u8, sigma, rad=rad))
    # a float image on the 0-255 scale, clamped on request
    f255 = 300.0 * f - 20.0
    close(tblur.gaussian_blur(t(f255), sigma, rad=rad, clamp255=True),
          jblur.gaussian_blur(f255, sigma, rad=rad, clamp255=True), atol=255 * ATOL)


@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("gc", [None, 0.05])
def test_bilateral_cross_matches_jax(shape, gc):
    f, g = image(shape, 5), image(shape, 6)
    close(tbf.bilateral_cross(t(f), t(g), 2.0, 0.1, 3, gc=gc),
          jbf.bilateral_cross(f, g, 2.0, 0.1, 3, gc=gc))


@pytest.mark.parametrize("shape", SIZES)
@pytest.mark.parametrize("size,gc", [(1, None), (2, 0.01), (3, 0.01)])
def test_bilateral_volume_matches_jax(shape, size, gc):
    """The SGM frame's parameters (gs 10, gr 6, gc 0.01) at small windows."""
    vol, g = volume(shape, 4, 7), image(shape, 8)
    got = tbf.bilateral_volume(t(vol), t(g), 10.0, 6.0, size, gc=gc)
    assert got.dtype == torch.float32 and got.shape == vol.shape
    close(got, jbf.bilateral_volume(vol, g, 10.0, 6.0, size, gc=gc))


def test_bilateral_volume_default_window_matches_golden():
    """Size 18 (the SgmConfig default) against the float64 scalar loop, each
    slice alone; the window is wider than the image, so most taps clamp."""
    vol, g = volume((10, 12), 2, 9), image((10, 12), 10)
    got = tbf.bilateral_volume(t(vol), t(g), 10.0, 6.0, 18, gc=0.01).numpy()
    for d in range(vol.shape[0]):
        close(got[d], ref.bilateral_cross3(vol[d], g, 10.0, 6.0, 0.01, 18), atol=0.0)


@pytest.mark.parametrize("shape", SIZES)
def test_named_medians_match_jax(shape):
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 16, shape).astype(np.float32)
    np.testing.assert_array_equal(tm.median_filter_3x3(t(img)).numpy(),
                                  np.asarray(jm.median_filter_3x3(img)))
    np.testing.assert_array_equal(tm.median_filter_5x5(t(img)).numpy(),
                                  np.asarray(jm.median_filter_5x5(img)))
    img[rng.random(shape) < 0.2] = np.nan
    for name in ("5x5", "7x7", "9x9"):
        for max_bad in (0, 12, 81):
            got = getattr(tm, f"median_filter_reject_negative_{name}")(t(img), max_bad)
            want = getattr(jm, f"median_filter_reject_negative_{name}")(img, max_bad)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SIZES)
def test_integral_images_match_jax(shape):
    f = image(shape, 12)
    close(tii.prefix_sum_rows(t(f)), jii.prefix_sum_rows(f), atol=0.0)
    close(tii.integral_image(t(f)), jii.integral_image(f), atol=0.0)
    np.testing.assert_array_equal(tii.transpose(t(f)).numpy(), np.asarray(jii.transpose(f)))
    ii = np.pad(np.asarray(jii.integral_image(f)), ((1, 0), (1, 0)))
    for rad in (1, 4, 20):
        close(tii.box_filter_integral_image(t(ii), rad),
              jii.box_filter_integral_image(ii, rad))
    # the port's box_filter takes the integral-image route above rad 16
    close(tii.box_filter(t(f), 20), jii.box_filter(f, 20))


@pytest.mark.parametrize("shape", SIZES)
def test_pyramids_match_jax(shape):
    for img in (image(shape, 13), uint8_image(shape, 14)):
        pyrs = {"box_reduce": (tpyr.box_reduce(t(img), 3), jpyr.box_reduce(img, 3)),
                "blur_reduce": (tpyr.blur_reduce(t(img), 3), jpyr.blur_reduce(img, 3)),
                "allocate": (tpyr.allocate(t(img), 4), jpyr.allocate(img, 4))}
        for name, (got, want) in pyrs.items():
            assert len(got) == len(want), name
            for level, (g, w) in enumerate(zip(got, want)):
                g, w = g.numpy(), np.asarray(w)
                assert g.shape == w.shape and g.dtype == w.dtype, (name, level)
                if g.dtype == np.uint8:
                    within_1lsb(g, w)
                else:
                    close(g, w)
        sub = tpyr.sub_pyramid(pyrs["box_reduce"][0], 1)
        assert len(sub) == 2 and sub[0] is pyrs["box_reduce"][0][1]


def jax_bilateral_frame_quality():
    """The JAX package's bilateral SGM frame (size 3) on
    stereo_pair(640, 480, 64, seed=0), scored as chip_smoke.py scores the
    port's (bench.py disp_stats)."""
    import jax

    from kangaroo_tpu.apps import stereo_sgm as jss
    from kangaroo_tpu.apps import synthetic as jsyn

    left, right, gt = jsyn.stereo_pair(640, 480, 64, seed=0)
    cfg = jss.SgmConfig(bilateral_filter=True, bilateral_size=3)
    d = np.asarray(jax.jit(lambda a, b: jss.sgm_pipeline(a, b, cfg))(left, right))
    g = np.asarray(gt)
    inner = np.zeros(d.shape, bool)
    inner[8:-8, 64 + 8:-8] = True
    m = np.isfinite(d) & inner
    err = np.abs(d[m] - g[m])
    return {"config": dataclasses.asdict(cfg),
            "invalid_frac": float(1.0 - m.sum() / inner.sum()),
            "median_err_px": float(np.median(err))}


if __name__ == "__main__":
    print(json.dumps(jax_bilateral_frame_quality()))
