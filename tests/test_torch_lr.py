"""kangaroo_tpu_torch's left-right check and its kernel's wrapper against
kangaroo_tpu: the XLA gather twin (no sweep bound), and the Pallas sweep
kernel in interpret mode (with ``max_disp``), one direction and the pair of
both in the reference's order. Exact, NaN positions included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kangaroo_tpu.stereo import costvolume as jcv
from kangaroo_tpu.stereo import lr_pallas
from kangaroo_tpu_torch.stereo import costvolume as tcv
from kangaroo_tpu_torch.stereo import dispatch, lr_cuda

H, W, D = 16, 128, 16


@pytest.fixture(scope="module")
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _disparities(seed):
    """Disparities spilling past [0, D) both ways, with NaNs, and a right
    image that agrees with the left one to within ~1 px in most places."""
    rng = np.random.default_rng(seed)
    dl = rng.uniform(-3, D + 3, (H, W)).astype(np.float32)
    dr = (dl + rng.normal(0, 0.8, (H, W))).astype(np.float32)
    dl[rng.random((H, W)) < 0.1] = np.nan
    dr[rng.random((H, W)) < 0.1] = np.nan
    return dl, dr


@pytest.mark.parametrize("sd", [-1, 1])
def test_matches_xla_twin(sd):
    dl, dr = _disparities(0)
    want = np.asarray(jcv.left_right_check(jnp.asarray(dl), jnp.asarray(dr), sd, 1.0))
    got = tcv.left_right_check(torch.from_numpy(dl), torch.from_numpy(dr), sd, 1.0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sd", [-1, 1])
def test_matches_pallas_kernel(interpret, sd):
    dl, dr = _disparities(1)
    want = np.asarray(lr_pallas.left_right_check(jnp.asarray(dl), jnp.asarray(dr), sd, 1.0,
                                                 max_disp=D))
    got = dispatch.left_right_check(torch.from_numpy(dl), torch.from_numpy(dr), sd, 1.0,
                                    max_disp=D).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [2, 3])
def test_pair_matches_two_pallas_calls(interpret, seed):
    """The pair equals the JAX package's two checks in its order: the right
    image against the left, then the left against the checked right."""
    dl, dr = _disparities(seed)
    want_r = lr_pallas.left_right_check(jnp.asarray(dr), jnp.asarray(dl), 1, 1.0, max_disp=D)
    want_l = lr_pallas.left_right_check(jnp.asarray(dl), want_r, -1, 1.0, max_disp=D)
    got_l, got_r = dispatch.left_right_check_pair(torch.from_numpy(dl), torch.from_numpy(dr),
                                                  1.0, max_disp=D)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_sweep_bound_rejects_far_offsets():
    """An offset past the TPU kernel's sweep reads NaN there: rejected with
    max_disp, kept by the unbounded gather."""
    dl = np.full((1, 64), np.nan, np.float32)
    dr = np.full((1, 64), 20.5, np.float32)
    dl[0, 40] = 20.5  # sd=-1: offset 21 >= max_disp 16
    kw = dict(sd=-1, max_diff=1.0)
    free = tcv.left_right_check(torch.from_numpy(dl), torch.from_numpy(dr), **kw)
    bound = tcv.left_right_check(torch.from_numpy(dl), torch.from_numpy(dr), max_disp=D, **kw)
    assert free[0, 40] == 20.5 and torch.isnan(bound[0, 40])


def test_kernel_wrapper_refuses_cpu_tensor():
    before = lr_cuda.launches
    with pytest.raises(RuntimeError, match="sm_90"):
        lr_cuda.left_right_check(torch.zeros(H, W), torch.zeros(H, W), -1, 1.0, D)
    with pytest.raises(RuntimeError, match="sm_90"):
        lr_cuda.left_right_check_pair(torch.zeros(H, W), torch.zeros(H, W), 1.0, D)
    assert lr_cuda.launches == before

