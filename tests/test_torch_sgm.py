"""kangaroo_tpu_torch.stereo.sgm and the SGM kernel's wrapper against
kangaroo_tpu: the lax.scan twin, and the Pallas path kernel in interpret
mode. Held on the disparity lattice only (masked entries are sentinels),
to 1e-5: the twins sum the four directions in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kangaroo_tpu.stereo import sgm as jsgm
from kangaroo_tpu.stereo import sgm_pallas
from kangaroo_tpu_torch.stereo import dispatch, sgm_cuda
from kangaroo_tpu_torch.stereo import sgm as tsgm

D, H, W = 16, 16, 128


@pytest.fixture(scope="module")
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(seed, shape=(D, H, W)):
    rng = np.random.default_rng(seed)
    return (rng.random(shape).astype(np.float32),
            rng.random(shape[1:]).astype(np.float32))


def _lattice(sd, shape=(D, H, W)):
    d = np.arange(shape[0])[:, None, None]
    x = np.arange(shape[2])[None, None, :]
    return np.broadcast_to((d <= x) if sd < 0 else (x + d < shape[2]), shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sd", [-1, 1])
def test_matches_scan_twin(sd, dtype):
    vol, img = _inputs(0)
    vj = jnp.asarray(vol).astype(getattr(jnp, dtype))
    want = np.asarray(jsgm.semi_global_matching(vj, jnp.asarray(img), 0.01, 0.02, sd=sd))
    got = tsgm.semi_global_matching(torch.from_numpy(vol).to(getattr(torch, dtype)),
                                    torch.from_numpy(img), 0.01, 0.02, sd=sd).numpy()
    m = _lattice(sd)
    np.testing.assert_allclose(got[m], want[m], atol=1e-5)


@pytest.mark.parametrize("sd", [-1, 1])
def test_matches_pallas_kernel(interpret, sd):
    vol, img = _inputs(1)
    want = np.asarray(sgm_pallas.semi_global_matching(jnp.asarray(vol), jnp.asarray(img),
                                                      0.01, 0.02, sd=sd))
    got = dispatch.semi_global_matching(torch.from_numpy(vol), torch.from_numpy(img),
                                        0.01, 0.02, sd=sd).numpy()
    m = _lattice(sd)
    np.testing.assert_allclose(got[m], want[m], atol=1e-5)


@pytest.mark.parametrize("do_horiz,do_vert,do_reverse",
                         [(True, False, True), (False, True, False), (True, True, False)])
def test_direction_flags_match_scan_twin(do_horiz, do_vert, do_reverse):
    vol, img = _inputs(2, (8, 12, 40))
    want = np.asarray(jsgm.semi_global_matching(jnp.asarray(vol), jnp.asarray(img), 0.05, 0.1,
                                                do_horiz, do_vert, do_reverse))
    got = tsgm.semi_global_matching(torch.from_numpy(vol), torch.from_numpy(img), 0.05, 0.1,
                                    do_horiz, do_vert, do_reverse).numpy()
    m = _lattice(-1, vol.shape)
    np.testing.assert_allclose(got[m], want[m], atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sd", [-1, 1])
def test_eight_path_matches_scan_twin(sd, dtype):
    vol, img = _inputs(3)
    vj = jnp.asarray(vol).astype(getattr(jnp, dtype))
    want = np.asarray(jsgm.semi_global_matching(vj, jnp.asarray(img), 0.01, 0.02,
                                                do_diagonal=True, sd=sd))
    got = tsgm.semi_global_matching(torch.from_numpy(vol).to(getattr(torch, dtype)),
                                    torch.from_numpy(img), 0.01, 0.02, do_diagonal=True,
                                    sd=sd).numpy()
    m = _lattice(sd)
    np.testing.assert_allclose(got[m], want[m], atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sd", [-1, 1])
def test_eight_path_matches_pallas_kernel(interpret, sd, dtype):
    """The Pallas 8-path kernel sums per row, the vertical and diagonal
    directions first; the port sums direction by direction."""
    vol, img = _inputs(5)
    vj = jnp.asarray(vol).astype(getattr(jnp, dtype))
    want = np.asarray(sgm_pallas.semi_global_matching(vj, jnp.asarray(img), 0.01, 0.02,
                                                      do_diagonal=True, sd=sd))
    got = dispatch.semi_global_matching(torch.from_numpy(vol).to(getattr(torch, dtype)),
                                        torch.from_numpy(img), 0.01, 0.02,
                                        do_diagonal=True, sd=sd).numpy()
    m = _lattice(sd)
    np.testing.assert_allclose(got[m], want[m], atol=1e-5)


@pytest.mark.parametrize("do_horiz,do_vert,do_reverse",
                         [(True, False, True), (True, True, False), (False, False, False)])
def test_eight_path_flags_match_both_twins(interpret, do_horiz, do_vert, do_reverse):
    """The four diagonals run whatever do_vert and do_reverse say; only the
    straight pairs follow the flags."""
    vol, img = _inputs(6)
    args = (0.05, 0.1, do_horiz, do_vert, do_reverse, True)
    got = tsgm.semi_global_matching(torch.from_numpy(vol), torch.from_numpy(img), *args).numpy()
    m = _lattice(-1)
    for twin in (jsgm.semi_global_matching, sgm_pallas.semi_global_matching):
        want = np.asarray(twin(jnp.asarray(vol), jnp.asarray(img), *args))
        np.testing.assert_allclose(got[m], want[m], atol=1e-5)


def test_diagonal_paths_reseed_at_the_image_edge():
    """A single diagonal direction on a volume one pixel wide: every pixel's
    predecessor is off the image, so every pixel starts a path (Lr = C)."""
    vol, img = _inputs(7, (4, 9, 1))
    agg = tsgm.semi_global_matching(torch.from_numpy(vol), torch.from_numpy(img),
                                    do_horiz=False, do_vert=False, do_diagonal=True).numpy()
    m = _lattice(-1, vol.shape)
    np.testing.assert_allclose(agg[m], 4 * vol[m], rtol=1e-6)


def test_kernel_wrapper_refuses_cpu_tensor():
    vol, img = _inputs(4, (8, 8, 16))
    before = sgm_cuda.launches
    with pytest.raises(RuntimeError, match="sm_90"):
        sgm_cuda.semi_global_matching(torch.from_numpy(vol), torch.from_numpy(img))
    assert sgm_cuda.launches == before

