"""kangaroo_tpu_torch.stereo.costvolume and the WTA kernel's wrapper against
kangaroo_tpu: the XLA twins, and the Pallas WTA kernel in interpret mode.

Costs are multiples of 1/64, exact in bfloat16 and full of ties, so the
first-index argmin rule is exercised. The subpixel step divides, so it is
held to 1e-6; the integer WTA and the re-anchoring are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kangaroo_tpu.stereo import costvolume as jcv
from kangaroo_tpu.stereo import wta_pallas
from kangaroo_tpu_torch.stereo import costvolume as tcv
from kangaroo_tpu_torch.stereo import dispatch, wta_cuda

D, H, W = 16, 16, 128


@pytest.fixture(scope="module")
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _vol(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, (D, H, W)) / 64.0).astype(np.float32)


def _pair(vol, dtype):
    return (jnp.asarray(vol).astype(getattr(jnp, dtype)),
            torch.from_numpy(vol).to(getattr(torch, dtype)))


@pytest.mark.parametrize("max_disp", [None, 10])
def test_cost_vol_minimum_exact(max_disp):
    vol = _vol(0)
    want = np.asarray(jcv.cost_vol_minimum(jnp.asarray(vol), max_disp))
    got = tcv.cost_vol_minimum(torch.from_numpy(vol), max_disp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sd", [-1, 1])
def test_subpix_matches_xla_twin(sd, dtype):
    vj, vt = _pair(_vol(1), dtype)
    want = np.asarray(jcv.cost_vol_minimum_subpix(vj, sd))
    np.testing.assert_allclose(tcv.cost_vol_minimum_subpix(vt, sd).numpy(), want, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sd", [-1, 1])
def test_subpix_matches_pallas_kernel(interpret, sd, dtype):
    vj, vt = _pair(_vol(2), dtype)
    want = np.asarray(wta_pallas.cost_vol_minimum_subpix(vj, sd))
    got = dispatch.cost_vol_minimum_subpix(vt, sd)  # the plain version on the CPU
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_reanchor_right_exact_on_lattice():
    vol = _vol(3)
    want = np.asarray(jcv.reanchor_right(jnp.asarray(vol)))
    got = tcv.reanchor_right(torch.from_numpy(vol)).numpy()
    lattice = np.broadcast_to((np.arange(W)[None, None, :] + np.arange(D)[:, None, None]) < W,
                              vol.shape)
    np.testing.assert_array_equal(got[lattice], want[lattice])


def test_wta_wrapper_refuses_cpu_tensor():
    before = wta_cuda.launches
    with pytest.raises(RuntimeError, match="sm_90"):
        wta_cuda.cost_vol_minimum_subpix(torch.zeros(D, H, W))
    assert wta_cuda.launches == before

