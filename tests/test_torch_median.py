"""kangaroo_tpu_torch.ops.median and the median kernel's wrapper against
kangaroo_tpu: the XLA sort twins, and the Pallas Batcher-network kernel in
interpret mode, on single images and on (N, H, W) stacks frame by frame.
Medians select an input value, so every comparison is exact, NaN positions
included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kangaroo_tpu.ops import median as jm
from kangaroo_tpu.ops import median_pallas
from kangaroo_tpu_torch import _build
from kangaroo_tpu_torch.ops import median as tm
from kangaroo_tpu_torch.ops import median_cuda
from kangaroo_tpu_torch.stereo import dispatch

H, W = 24, 40
CASES = [(1, 4), (2, 12), (3, 20)]  # (rad, max_bad)


@pytest.fixture(scope="module")
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _image(seed, bad=True):
    """Disparity-like image with NaN and inf taps, in blobs and alone."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 16, (H, W)).astype(np.float32)
    if bad:
        img[rng.random((H, W)) < 0.15] = np.nan
        img[rng.random((H, W)) < 0.03] = np.inf
        img[4:12, 6:16] = np.nan  # a hole wider than the window
    return img


@pytest.mark.parametrize("rad", [1, 2])
def test_median_filter_matches(rad):
    img = _image(0, bad=False)
    want = np.asarray(jm.median_filter(jnp.asarray(img), rad))
    np.testing.assert_array_equal(tm.median_filter(torch.from_numpy(img), rad).numpy(), want)


@pytest.mark.parametrize("rad,max_bad", CASES)
def test_reject_invalid_matches_xla_twin(rad, max_bad):
    img = _image(1)
    want = np.asarray(jm.median_filter_reject_invalid(jnp.asarray(img), max_bad, rad))
    got = tm.median_filter_reject_invalid(torch.from_numpy(img), max_bad, rad).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rad,max_bad", CASES)
def test_reject_invalid_matches_pallas_kernel(interpret, rad, max_bad):
    img = _image(2)
    want = np.asarray(median_pallas.median_filter(jnp.asarray(img), max_bad, rad, reject=True))
    got = dispatch.median_filter_reject_invalid(torch.from_numpy(img), max_bad, rad).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [9, 25, 49])
def test_network_matches_tpu_kernel(n):
    """The kernel sorts with the TPU kernel's pair list, written out in full."""
    pairs = median_cuda.batcher_pairs(n)
    assert pairs == median_pallas._batcher_pairs(n)
    header = _build.generated_headers()["median_network.cuh"]
    body = header.split(f"void batcher_sort<{n}>(float* v) {{", 1)[1].split("}", 1)[0]
    listed = [tuple(int(i) for i in line.split("fminf(v[", 1)[1].split("])", 1)[0].split("], v["))
              for line in body.splitlines() if "fminf" in line]
    assert listed == pairs


def test_network_sorts():
    """Batcher's pairs sort every window size the kernel takes."""
    rng = np.random.default_rng(3)
    for rad in median_cuda.RADII:
        n = (2 * rad + 1) ** 2
        v = list(rng.permutation(n))
        for a, b in median_cuda.batcher_pairs(n):
            v[a], v[b] = min(v[a], v[b]), max(v[a], v[b])
        assert v == sorted(v)


@pytest.mark.parametrize("rad,max_bad", CASES)
def test_stack_matches_pallas_kernel_frame_by_frame(interpret, rad, max_bad):
    """An (N, H, W) stack: each image filtered alone, with its own edges,
    equal to the Pallas kernel on that image and to the plain median of it."""
    stack = np.stack([_image(10 + k) for k in range(3)])
    got = dispatch.median_filter_reject_invalid(torch.from_numpy(stack), max_bad, rad).numpy()
    assert got.shape == stack.shape
    for k in range(len(stack)):
        want = np.asarray(median_pallas.median_filter(jnp.asarray(stack[k]), max_bad, rad,
                                                      reject=True))
        np.testing.assert_array_equal(got[k], want)
        np.testing.assert_array_equal(
            got[k], tm.median_filter_reject_invalid(torch.from_numpy(stack[k]), max_bad, rad))


def test_kernel_wrapper_refuses_cpu_tensor():
    before = median_cuda.launches
    for shape in ((H, W), (2, H, W)):
        with pytest.raises(RuntimeError, match="sm_90"):
            median_cuda.median_filter_reject_invalid(torch.zeros(shape), 12, 2)
    assert median_cuda.launches == before

