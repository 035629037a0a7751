"""Census words and WTA Hamming stereo, patch scores and scanline dense
stereo: kangaroo_tpu_torch against kangaroo_tpu on the CPU. The same NumPy
inputs from a seed go through both.

Tolerances: the census words, ``census_stereo`` (integer WTA) exactly;
``score_shifted`` and ``dense_stereo_subpixel_refine`` within 1e-5 of the
largest score (box sums from float32 cumsums, which XLA and PyTorch may
add in another order); ``dense_stereo`` >= 99.9 % of pixels equal (a score
a last bit apart can flip a near tie of the WTA or its acceptance test).
"""
import jax
import numpy as np
import pytest
import torch

from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu.core import patch_score as jps
from kangaroo_tpu.stereo import census as jcen
from kangaroo_tpu.stereo import dense_stereo as jds
from kangaroo_tpu_torch.core import patch_score as tps
from kangaroo_tpu_torch.stereo import census as tcen
from kangaroo_tpu_torch.stereo import dense_stereo as tds

# the JAX package's stereo app test sizes
SIZES = [(96, 64, 16), (128, 96, 32)]
KINDS = ["pixel", "sad", "ssd", "sand", "ssnd", "ssnd_line"]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def pair(W, H, D, seed=0):
    left, right, gt = jsyn.stereo_pair(W, H, D, seed=seed)
    return np.asarray(left), np.asarray(right), np.asarray(gt)


def jax_census(img, window):
    return np.asarray(jax.jit(jcen.census, static_argnames="window")(img, window))


def close_to_scale(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["census9x7", "census11x11", "census16x16"])
def test_named_census_words_match_jax(name):
    img = np.random.default_rng(0).integers(0, 256, (23, 37)).astype(np.uint8)
    want = np.asarray(jax.jit(getattr(jcen, name))(img)).astype(np.int64)
    got = getattr(tcen, name)(t(img))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("W,H,D", SIZES)
@pytest.mark.parametrize("window", ["9x7", "16x16"])
def test_census_stereo_matches_jax(W, H, D, window):
    left, right, gt = pair(W, H, D, seed=1)
    cl, cr = jax_census(left, window), jax_census(right, window)
    want = np.asarray(jcen.census_stereo(cl, cr, D))
    got = tcen.census_stereo(t(cl).to(torch.int64), t(cr).to(torch.int64), D)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0] == -1).all()  # no candidate d < x at x = 0
    ok = got.numpy()[8:-8, D + 8:-8]
    assert (ok == gt[8:-8, D + 8:-8]).mean() > 0.8


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dx,rad", [(0, 1), (-5, 1), (3, 2), (-20, 2)])
def test_score_shifted_matches_jax(kind, dx, rad):
    rng = np.random.default_rng(2)
    a = (255 * rng.random((23, 37))).astype(np.float32)
    b = (255 * rng.random((23, 37))).astype(np.float32)
    want = jps.score_shifted(a, b, dx, rad, kind)
    got = tps.score_shifted(t(a), t(b), dx, rad, kind)
    assert got.dtype == torch.float32
    close_to_scale(got.numpy(), want)


def test_score_shifted_rejects_an_unknown_kind():
    with pytest.raises(ValueError):
        tps.score_shifted(torch.zeros(4, 4), torch.zeros(4, 4), 0, 1, "ncc")


@pytest.mark.parametrize("W,H,D", SIZES)
@pytest.mark.parametrize("kind,thresh", [("sand", 0.0), ("ssd", 0.05)])
def test_dense_stereo_matches_jax(W, H, D, kind, thresh):
    left, right, gt = pair(W, H, D, seed=3)
    want = np.asarray(jds.dense_stereo(left, right, D, 1, kind, thresh))
    got = tds.dense_stereo(t(left), t(right), D, 1, kind, thresh)
    assert got.dtype == torch.int32 and got.shape == (H, W)
    assert (got.numpy() == want).mean() >= 0.999
    inner = got.numpy()[8:-8, D + 8:-8]
    assert (inner == gt[8:-8, D + 8:-8]).mean() > 0.7


@pytest.mark.parametrize("kind", ["sand", "ssd"])
def test_dense_stereo_subpixel_refine_matches_jax(kind):
    W, H, D = SIZES[0]
    left, right, _ = pair(W, H, D, seed=4)
    disp = np.asarray(jds.dense_stereo(left, right, D, 1, kind))
    want = np.asarray(jds.dense_stereo_subpixel_refine(disp, left, right, 1, kind))
    got = tds.dense_stereo_subpixel_refine(t(disp), t(left), t(right), 1, kind).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert fin.mean() > 0.3
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5 * D)
