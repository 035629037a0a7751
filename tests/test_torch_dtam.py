"""DTAM variational stereo: kangaroo_tpu_torch against kangaroo_tpu.

The same NumPy inputs go through the JAX package on CPU-JAX (its XLA twins,
and its Pallas kernels in interpret mode) and through the port's plain
path. Tolerances:

- the auxiliary search 1e-6: one float32 formula, but XLA on the CPU may
  contract a product and a sum into an FMA where PyTorch rounds both;
- the edge weight and the gradient filter 1e-6 (XLA's and PyTorch's pow,
  exp and sqrt may differ in the last bit), the truncated abs-and-gradient
  volume exactly, the box and guided filters 1e-5 (another summation
  order in the integral image, and 19-tap window sums);
- the solve and the incremental steps 1e-5 after 6 iterations, the bound
  the JAX package holds between its own two formulations
  (tests/test_pallas_kernels.py TestDtamPallas);
- the pipelines >= 99 % of pixels both NaN or within 1e-4 px, and their
  quality figures within 1e-3: a last-bit difference can move a subpixel
  step or flip the LR check of a pixel.

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_dtam.py`` prints
the JAX package's quality figures at VGA/64 on ``stereo_pair(640, 480, 64,
seed=0)`` (cold-50 solve, and the incremental schedule after 10 frames):
the references beside which chip_smoke.py sets its DTAM quality limits.
"""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kangaroo_tpu.apps import stereo as jst
from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu.ops import integral_image as jii
from kangaroo_tpu.stereo import costvolume as jcv
from kangaroo_tpu.stereo import dtam_pallas
from kangaroo_tpu.stereo import wta_pallas
from kangaroo_tpu_torch.apps import stereo as tst
from kangaroo_tpu_torch.apps import synthetic as tsyn
from kangaroo_tpu_torch.ops import integral_image as tii
from kangaroo_tpu_torch.ops import median_cuda
from kangaroo_tpu_torch.parallel import mesh as tmesh
from kangaroo_tpu_torch.stereo import costvolume as tcv
from kangaroo_tpu_torch.stereo import dispatch, dtam_cuda, lr_cuda, wta_cuda

D, H, W = 8, 16, 128
# lam, sigma_q, sigma_d, huber_alpha, beta of the JAX package's own DTAM tests
LAM, SQ, SDT, ALPHA = 20.0, 0.7, 0.7, 0.002
# the pipeline of tests/test_apps.py test_dtam_pipeline_runs_and_is_accurate
PIPE = dict(max_disp=16, census_window="9x7", dtam_iterations=30, lam=20.0, lr_check=True)


@pytest.fixture(scope="module")
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _rng(seed):
    return np.random.default_rng(seed)


def _vol(seed, dtype="float32"):
    """Costs k/256 (exact in bfloat16) as a (JAX, torch) pair."""
    v = (_rng(seed).integers(0, 257, (D, H, W)) / 256.0).astype(np.float32)
    return jnp.asarray(v).astype(getattr(jnp, dtype)), torch.from_numpy(v).to(getattr(torch, dtype))


def _image(seed, shape=(H, W)):
    return _rng(seed).random(shape).astype(np.float32)


def _agreement(a, b, tol=1e-4):
    a, b = np.asarray(a), np.asarray(b)
    return float(((np.isnan(a) & np.isnan(b)) | (np.abs(a - b) <= tol)).mean())


def disp_stats(disp, gt, band: int):
    """bench.py's disp_stats: invalid fraction and median error inside the
    frame, skipping the ``band`` columns of the max-disparity band and an
    8-pixel border."""
    d, g = np.asarray(disp), np.asarray(gt)
    inner = np.zeros(d.shape, bool)
    inner[8:-8, band:-8] = True
    m = np.isfinite(d) & inner
    err = np.abs(d[m] - g[m])
    return {"invalid_frac": float(1.0 - m.sum() / inner.sum()),
            "median_err_px": float(np.median(err))}


# --- the auxiliary search ---------------------------------------------------


@pytest.mark.parametrize("theta", [0.5, 100.0, 1e-3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sd", [-1, 1])
def test_square_penalty_matches_xla(sd, dtype, theta):
    vj, vt = _vol(0, dtype)
    last = (_rng(1).random((H, W)) * D).astype(np.float32)
    want = np.asarray(jcv.cost_vol_minimum_square_penalty_subpix(vj, jnp.asarray(last), 2.0,
                                                                 theta, sd))
    got = tcv.cost_vol_minimum_square_penalty_subpix(vt, torch.from_numpy(last), 2.0, theta, sd)
    assert got.dtype == torch.float32 and got.shape == (H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sd", [-1, 1])
def test_square_penalty_matches_pallas(interpret, sd):
    vj, vt = _vol(2)
    last = (_rng(3).random((H, W)) * D).astype(np.float32)
    want = np.asarray(wta_pallas.cost_vol_minimum_square_penalty_subpix(
        vj, jnp.asarray(last), 2.0, 0.5, sd))
    got = dispatch.cost_vol_minimum_square_penalty_subpix(vt, torch.from_numpy(last), 2.0, 0.5,
                                                          sd)  # the plain version on the CPU
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_square_penalty_gradient_matches_jax():
    """The plain version is the backward of the kernel's autograd op: its
    gradient with respect to the volume, the last disparity, lam and theta
    is the JAX package's (the backward of its custom_vjp). Continuous costs:
    a parabola through three collinear costs has no finite gradient."""
    import jax

    v = _rng(4).random((D, H, W), dtype=np.float32)
    vj, vt = jnp.asarray(v), torch.from_numpy(v)
    last = (_rng(5).random((H, W)) * D).astype(np.float32)
    ct = _image(17)
    _, vjp = jax.vjp(lambda v, d, l, t: jcv.cost_vol_minimum_square_penalty_subpix(v, d, l, t),
                     vj, jnp.asarray(last), jnp.float32(2.0), jnp.float32(0.5))
    want = vjp(jnp.asarray(ct))
    xs = [vt.clone(), torch.from_numpy(last), torch.tensor(2.0), torch.tensor(0.5)]
    xs = [x.requires_grad_(True) for x in xs]
    dispatch.cost_vol_minimum_square_penalty_subpix(*xs).backward(torch.from_numpy(ct))
    for name, x, w in zip(("vol", "last", "lam", "theta"), xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# --- the plain stages ---------------------------------------------------------


def test_exponential_edge_weight_matches():
    img = _image(6)
    want = np.asarray(jcv.exponential_edge_weight(jnp.asarray(img), 14.0, 2.5))
    got = tcv.exponential_edge_weight(torch.from_numpy(img), 14.0, 2.5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_filter_disp_grad_matches():
    disp = (_image(7) * D).astype(np.float32)
    want = np.asarray(jcv.filter_disp_grad(jnp.asarray(disp), 4.0))
    got = tcv.filter_disp_grad(torch.from_numpy(disp), 4.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got == -1.0).any() and (got != -1.0).any()


@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("tag", [dict(), dict(alpha=0.9, r1=0.3, r2=0.2)])
def test_truncated_abs_and_grad_volume_matches(sd, tag):
    left, right = _image(8), _image(9)
    want = np.asarray(jcv.cost_volume_from_stereo_truncated_abs_and_grad(
        jnp.asarray(left), jnp.asarray(right), D, sd, **tag))
    got = tcv.cost_volume_from_stereo_truncated_abs_and_grad(
        torch.from_numpy(left), torch.from_numpy(right), D, sd, **tag)
    assert got.shape == (D, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rad", [2, 20])  # the direct sum and the integral image
def test_box_filter_matches(rad):
    img = _image(10, (40, 56))
    want = np.asarray(jii.box_filter(jnp.asarray(img), rad))
    np.testing.assert_allclose(tii.box_filter(torch.from_numpy(img), rad).numpy(), want,
                               rtol=0, atol=1e-5)


def test_guided_filter_matches():
    p, guide = _image(11, (40, 56)), _image(12, (40, 56))
    want = np.asarray(jii.guided_filter(jnp.asarray(p), jnp.asarray(guide), 4, 1e-3))
    got = tii.guided_filter(torch.from_numpy(p), torch.from_numpy(guide), 4, 1e-3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_guided_filter_volume_matches():
    vj, vt = _vol(13)
    guide = _image(14)
    want = np.asarray(jii.guided_filter_volume(vj, jnp.asarray(guide), 9, 1e-4))
    got = tii.guided_filter_volume(vt, torch.from_numpy(guide), 9, 1e-4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# --- the alternation ----------------------------------------------------------


@pytest.fixture(scope="module")
def dtam_inputs():
    vj, vt = _vol(15)
    img = _image(16)
    g = np.array(jcv.exponential_edge_weight(jnp.asarray(img), 1.0, 2.5))
    d0 = np.array(jcv.cost_vol_minimum_subpix(vj, -1))
    return vj, vt, img, g, d0


def test_dtam_solve_matches_xla_loop(dtam_inputs):
    vj, vt, img, _, _ = dtam_inputs
    args = (LAM, 100.0, SQ, SDT, ALPHA, 1e-5, 1.0, 2.5)
    want = np.asarray(jst.dtam_solve(vj, jnp.asarray(img), *args, iterations=6))
    got = tst.dtam_solve(vt, torch.from_numpy(img), *args, iterations=6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dtam_solve_matches_pallas(interpret, dtam_inputs):
    vj, vt, img, g, d0 = dtam_inputs
    want = np.asarray(dtam_pallas.dtam_solve(vj, jnp.asarray(g), jnp.asarray(d0), LAM, 100.0,
                                             SQ, SDT, ALPHA, 1e-5, iterations=6))
    got = tst.dtam_solve(vt, torch.from_numpy(img), LAM, 100.0, SQ, SDT, ALPHA, 1e-5, 1.0, 2.5,
                         iterations=6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _increment_jax(vj, g, d, a, q, theta, n, its):
    return jst.dtam_increment(vj, jnp.asarray(g), d, a, q, jnp.float32(theta), jnp.float32(n),
                              LAM, SQ, SDT, ALPHA, 1e-3, iterations=its)


def test_dtam_increment_matches_xla_loop_and_chains(dtam_inputs):
    """6 steps against the XLA loop, and 3 + 3 steps equal to 6 (the state
    round-trips), with beta = 1e-3 so the global counter's anneal shows."""
    vj, vt, _, g, d0 = dtam_inputs
    want = _increment_jax(vj, g, jnp.asarray(d0), jnp.asarray(d0),
                          jnp.zeros((H, W, 2), jnp.float32), 100.0, 0.0, 6)
    t0 = torch.from_numpy(d0)
    state = (t0, t0, torch.zeros(H, W, 2), 100.0, 0.0)
    six = tst.dtam_increment(vt, torch.from_numpy(g), *state, LAM, SQ, SDT, ALPHA, 1e-3,
                             iterations=6)
    s1 = tst.dtam_increment(vt, torch.from_numpy(g), *state, LAM, SQ, SDT, ALPHA, 1e-3,
                            iterations=3)
    s2 = tst.dtam_increment(vt, torch.from_numpy(g), *s1, LAM, SQ, SDT, ALPHA, 1e-3,
                            iterations=3)
    for name, w, a, b in zip("d a q theta n".split(), want, six, s2):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)


def test_dtam_increment_matches_pallas_step(interpret, dtam_inputs):
    vj, vt, _, g, d0 = dtam_inputs
    want = dtam_pallas.dtam_step(vj, jnp.asarray(g), jnp.asarray(d0), jnp.asarray(d0),
                                 jnp.zeros((H, W, 2), jnp.float32), jnp.float32(100.0),
                                 jnp.float32(3.0), LAM, SQ, SDT, ALPHA, 1e-3, iterations=4)
    t0 = torch.from_numpy(d0)
    got = tst.dtam_increment(vt, torch.from_numpy(g), t0, t0, torch.zeros(H, W, 2), 100.0, 3.0,
                             LAM, SQ, SDT, ALPHA, 1e-3, iterations=4)
    for name, w, a in zip("d a q theta n".split(), want, got):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n0,beta", [(1.0, 1e-5), (7.0, 1e-3)])
def test_anneal_is_the_loops_schedule(n0, beta):
    """The kernel's theta array equals the plain loop's float32 carry to the
    bit, for the cold (n0 = 1) and the incremental (global n) schedule."""
    thetas = dtam_cuda.anneal(100.0, beta, n0, 50)
    theta = torch.tensor(100.0)
    b = torch.tensor(beta, dtype=torch.float32)
    for i in range(51):
        assert thetas[i] == theta.item(), i
        theta = theta * (1.0 - b * (n0 + i))


# --- the pipelines ------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    left, right, gt = jsyn.stereo_pair(128, 64, 16, seed=0)
    return left, right, np.asarray(gt)


@pytest.mark.parametrize("use_dtam", [True, False])
def test_stereo_pipeline_matches_jax(pair, use_dtam):
    left, right, gt = pair
    jcfg = jst.StereoConfig(**PIPE)
    want = np.asarray(jst.stereo_pipeline(left, right, jcfg, use_dtam=use_dtam))
    got = tst.stereo_pipeline(torch.from_numpy(np.array(left)), torch.from_numpy(np.array(right)),
                              tst.StereoConfig.from_dict(dataclasses.asdict(jcfg)),
                              use_dtam=use_dtam)
    assert got.dtype == torch.float32 and got.shape == (64, 128)
    assert _agreement(got.numpy(), want) >= 0.99
    q_got, q_want = disp_stats(got, gt, 20), disp_stats(want, gt, 20)
    for k in q_want:
        assert q_got[k] == pytest.approx(q_want[k], abs=1e-3), k
    # a disparity map, not noise
    assert q_got["invalid_frac"] < 0.6 and q_got["median_err_px"] < 1.5


@pytest.mark.parametrize("overrides", [dict(use_census=False, avg_rad=8),
                                       dict(filter_volume=True, filter_rad=4),
                                       dict(filt_grad_thresh=2.0, median_its=2)])
def test_stereo_pipeline_options_match_jax(pair, overrides):
    left, right, _ = pair
    jcfg = jst.StereoConfig(**{**PIPE, "dtam_iterations": 10, **overrides})
    want = np.asarray(jst.stereo_pipeline(left, right, jcfg))
    got = tst.stereo_pipeline(torch.from_numpy(np.array(left)), torch.from_numpy(np.array(right)),
                              tst.StereoConfig.from_dict(dataclasses.asdict(jcfg)))
    assert _agreement(got.numpy(), want) >= 0.99


def test_variational_stereo_matches_jax(pair):
    left, right, gt = pair
    jcfg = jst.StereoConfig(**PIPE)
    cfg = tst.StereoConfig.from_dict(dataclasses.asdict(jcfg))
    jvs, tvs = jst.VariationalStereo(jcfg, its_per_frame=5), tst.VariationalStereo(cfg, 5)
    lt, rt = torch.from_numpy(np.array(left)), torch.from_numpy(np.array(right))
    for frame in range(3):
        want = np.asarray(jvs.process_frame(left, right))
        got = tvs.process_frame(lt, rt).numpy()
        assert _agreement(got, want) >= 0.99, frame
        assert tvs.theta == pytest.approx(jvs.theta, rel=1e-6)
        for name, w, a in zip("d a q".split(), jvs.state, tvs.state):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=1e-4, err_msg=name)
    assert float(tvs.state[4]) == float(jvs.state[4]) == 15.0
    tvs.reset()
    assert tvs.state is None


def test_config_from_dict_carries_every_field():
    jcfg = jst.StereoConfig(max_disp=32, census_window="9x7", use_census=False, lam=7.0,
                            avg_rad=3, filter_volume=True, filt_grad_thresh=1.5,
                            dtam_iterations=11, coarse_iterations=7)
    cfg = tst.StereoConfig.from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tst.StereoConfig()) == dataclasses.asdict(jst.StereoConfig())


# coarse_init runs since the stereo apps' slice (tests/test_torch_stereo_apps.py), mesh since
# the multi-device slice (tests/test_torch_kinectfusion_mesh.py)
@pytest.mark.parametrize("cfg,mesh,piece", [(
    tst.StereoConfig(max_disp=8, census_window="9x7", dtam_iterations=4, lr_check=False),
    tmesh.make_mesh(devices=["cpu"] * 2), "mesh")])
def test_unported_options_raise(cfg, mesh, piece):
    """No option is refused any more: without DTAM the pipeline ignores
    ``mesh`` (bit-equal to no mesh), with DTAM it runs the sharded solve,
    within 1e-4 px of the single-device frame (tests/test_parallel.py)."""
    left, right, _ = tsyn.stereo_pair(32, 16, 8, seed=1, device="cpu")
    for use_dtam in (False, True):
        got = tst.stereo_pipeline(left, right, cfg, use_dtam=use_dtam, mesh=mesh)
        want = tst.stereo_pipeline(left, right, cfg, use_dtam=use_dtam)
        same = (torch.isnan(got) & torch.isnan(want)) | ((got - want).abs() <= 1e-4)
        assert bool(same.all()), (piece, use_dtam)
        if not use_dtam:
            assert torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0))


def test_cpu_path_launches_no_kernel():
    counts = lambda: (dtam_cuda.launches, wta_cuda.sq_launches, wta_cuda.launches,  # noqa: E731
                      median_cuda.launches, lr_cuda.launches)
    before = counts()
    left, right, _ = tsyn.stereo_pair(48, 16, 8, seed=1, device="cpu")
    cfg = tst.StereoConfig(max_disp=8, census_window="9x7", dtam_iterations=3)
    tst.stereo_pipeline(left, right, cfg)
    tst.VariationalStereo(cfg, its_per_frame=2).process_frame(left, right)
    assert counts() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    vol, plane = torch.zeros(D, H, W), torch.zeros(H, W)
    before = (dtam_cuda.launches, wta_cuda.sq_launches)
    with pytest.raises(RuntimeError, match="sm_90"):
        wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, plane, 2.0, 0.5)
    with pytest.raises(RuntimeError, match="sm_90"):
        dtam_cuda.dtam_solve(vol, plane, plane, LAM, 100.0, SQ, SDT, ALPHA, 1e-5, iterations=2)
    assert (dtam_cuda.launches, wta_cuda.sq_launches) == before


def jax_reference_quality(w=640, h=480, max_disp=64, frames=10):
    """The JAX package's DTAM quality on stereo_pair(w, h, max_disp, seed=0)
    with the 16x16 census and 50 iterations (bench.py's quality config):
    the cold solve, and the incremental schedule after ``frames`` frames."""
    left, right, gt = jsyn.stereo_pair(w, h, max_disp, seed=0)
    cfg = jst.StereoConfig(max_disp=max_disp, census_window="16x16", dtam_iterations=50)
    out = {"cold50": disp_stats(jst.stereo_pipeline(left, right, cfg), gt, max_disp + 8)}
    vs = jst.VariationalStereo(cfg, its_per_frame=5)
    for _ in range(frames):
        disp = vs.process_frame(left, right)
    out[f"incremental_{frames}"] = disp_stats(disp, gt, max_disp + 8)
    return out


if __name__ == "__main__":
    import json

    print(json.dumps(jax_reference_quality(*map(int, sys.argv[1:]))))
