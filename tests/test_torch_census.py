"""kangaroo_tpu_torch.stereo.census against kangaroo_tpu.stereo.census.

Census words, Hamming distances and cost volumes are integer-valued (costs
are k/bits with a power-of-two bits), so every comparison is exact, for
float32 and bfloat16 volumes alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kangaroo_tpu.stereo import census as jc
from kangaroo_tpu_torch.stereo import census as tc

H, W, D = 24, 72, 16
# jitted: the eager JAX census dispatches a few hundred small ops
_jax_census = jax.jit(jc.census, static_argnames="window")


def _image(seed, dtype):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, (H, W), dtype=np.uint8)
    # few grey levels, so equal neighbours (no bit) occur as well
    return (rng.integers(0, 8, (H, W)) / 7.0).astype(np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("window", ["9x7", "11x11", "16x16"])
def test_census_words_exact(window, dtype):
    img = _image(0, dtype)
    want = np.asarray(_jax_census(jnp.asarray(img), window)).astype(np.int64)
    got = tc.census(torch.from_numpy(img), window)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_hamming_distance_exact():
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 2**32, (H, W, 4), dtype=np.uint64) for _ in range(2))
    want = np.asarray(jc.hamming_distance(jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32)))
    got = tc.hamming_distance(torch.from_numpy(a.astype(np.int64)),
                              torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("window", ["9x7", "11x11", "16x16"])
def test_norm_bits(window):
    assert tc.norm_bits(window) == jc.norm_bits(window)


@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cost_volume_exact(dtype, sd):
    left, right = _image(2, "uint8"), _image(3, "uint8")
    bits = jc.norm_bits("16x16")
    want = jc.census_cost_volume(_jax_census(jnp.asarray(left)), _jax_census(jnp.asarray(right)),
                                 D, sd, bits, dtype=getattr(jnp, dtype))
    got = tc.census_cost_volume(tc.census(torch.from_numpy(left)),
                                tc.census(torch.from_numpy(right)), D, sd, bits,
                                dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (D, H, W)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_cost_volume_default_bits_exact():
    left, right = _image(4, "float32"), _image(5, "float32")
    cl_j, cr_j = _jax_census(jnp.asarray(left), "9x7"), _jax_census(jnp.asarray(right), "9x7")
    want = jc.census_cost_volume(cl_j, cr_j, D, -1)
    got = tc.census_cost_volume(tc.census(torch.from_numpy(left), "9x7"),
                                tc.census(torch.from_numpy(right), "9x7"), D, -1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
