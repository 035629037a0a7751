"""kangaroo_tpu_torch.variational and ops.convolution against kangaroo_tpu.

The operators are held exactly. The solves are held to 1e-5 after 40
iterations at (48, 128), against the XLA loops and against the Pallas
solvers in interpret mode: the JAX package's XLA fuses the loop and its
Pallas body sums the divergence in another order, so they differ from the
port, and from each other, in the last bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kangaroo_tpu.ops import convolution as jconv
from kangaroo_tpu.variational import deconvolution as jdec
from kangaroo_tpu.variational import ops as jops
from kangaroo_tpu.variational import pallas_solvers as jps
from kangaroo_tpu.variational import rof as jrof
from kangaroo_tpu.variational import tgv as jtgv
from kangaroo_tpu_torch.ops import convolution
from kangaroo_tpu_torch.variational import deconvolution, ops, rof, solvers_cuda, tgv

ITERS = 40


@pytest.fixture(scope="module")
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(scope="module")
def noisy():
    rng = np.random.default_rng(11)
    clean = np.zeros((48, 128), np.float32)
    clean[12:30, 40:90] = 0.8
    return clean + 0.15 * rng.standard_normal((48, 128)).astype(np.float32)


@pytest.fixture(scope="module")
def mask():
    m = np.ones((48, 128), np.float32)
    m[20:28, 60:100] = 0.0
    return m


def _field(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name,shape", [
    ("grad_forward", (9, 13)), ("divergence", (9, 13, 2)), ("epsilon", (9, 13, 2)),
    ("divergence_sym", (9, 13, 3)), ("project_unit_ball", (9, 13, 2)),
    ("project_unit_ball_sym", (9, 13, 3)), ("project_unit_ball_scalar", (9, 13)),
])
def test_operator_matches_exactly(name, shape):
    x = 2.0 * _field(0, shape)
    want = np.asarray(getattr(jops, name)(jnp.asarray(x)))
    got = getattr(ops, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_div_adjoint_of_grad():
    """<grad u, p> == -<u, div p> on the subspace the solver keeps (p zero
    on the far boundary), as tests/test_variational.py holds the JAX pair."""
    u = torch.from_numpy(_field(1, (6, 7)))
    p = _field(2, (6, 7, 2))
    p[:, -1, 0] = 0.0
    p[-1, :, 1] = 0.0
    p = torch.from_numpy(p)
    lhs = float((ops.grad_forward(u) * p).sum())
    rhs = float((u * ops.divergence(p)).sum())
    assert lhs == pytest.approx(-rhs, rel=1e-4)


def test_epsilon_adjoint():
    """<Eps v, q>_sym == -<v, div_sym q> with the off-diagonal counted twice."""
    v = torch.from_numpy(_field(3, (6, 7, 2)))
    q = _field(4, (6, 7, 3))
    q[:, -1, :] = 0.0
    q[-1, :, :] = 0.0
    q = torch.from_numpy(q)
    e = ops.epsilon(v)
    lhs = float((e[..., 0] * q[..., 0] + e[..., 1] * q[..., 1] + 2 * e[..., 2] * q[..., 2]).sum())
    rhs = float((v * ops.divergence_sym(q)).sum())
    assert lhs == pytest.approx(-rhs, rel=1e-3)


@pytest.mark.parametrize("step", ["tvl1", "huber", "weighted_huber", "l2", "l2_lambda_weight",
                                  "weighted_l2"])
def test_half_steps_match(step):
    u, g, w = (np.abs(_field(s, (9, 13))) for s in (5, 6, 7))
    p = 0.3 * _field(8, (9, 13, 2))
    j = {k: jnp.asarray(v) for k, v in dict(u=u, g=g, w=w, p=p).items()}
    t = {k: torch.from_numpy(v) for k, v in dict(u=u, g=g, w=w, p=p).items()}
    calls = {
        "tvl1": lambda m, a: m.tvl1_dual_ascent_p(a["p"], a["u"], 0.7),
        "huber": lambda m, a: m.huber_dual_ascent_p(a["p"], a["u"], 0.7, 0.002),
        "weighted_huber": lambda m, a: m.weighted_huber_dual_ascent_p(a["p"], a["u"], a["w"],
                                                                       0.7, 0.002),
        "l2": lambda m, a: m.l2_primal_descent(a["u"], a["p"], a["g"], 0.7, 5.0),
        "l2_lambda_weight": lambda m, a: m.l2_primal_descent(a["u"], a["p"], a["g"], 0.7, 5.0,
                                                             lambda_weight=a["w"]),
        "weighted_l2": lambda m, a: m.weighted_l2_primal_descent(a["u"], a["p"], a["g"], a["w"],
                                                                 0.7, 12.5),
    }
    want = np.asarray(calls[step](jrof, j))
    np.testing.assert_allclose(calls[step](rof, t).numpy(), want, rtol=0, atol=1e-6)


def test_tgv_iteration_matches():
    f = _field(9, (9, 13))
    consts = (2.0, 1.0, 0.5, 0.25, 0.1)
    js, ts = jtgv.init(jnp.asarray(f)), tgv.init(torch.from_numpy(f))
    for _ in range(3):
        js = jtgv.iteration(js, jnp.asarray(f), *consts)
        ts = tgv.iteration(ts, torch.from_numpy(f), *consts)
    for name in jtgv.TgvState._fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("model", ["tv", "huber"])
def test_rof_matches_xla(noisy, model):
    want = np.asarray(jrof._denoise_xla(jnp.asarray(noisy), 8.0, iterations=ITERS, model=model))
    got = rof.denoise(torch.from_numpy(noisy), 8.0, iterations=ITERS, model=model).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("model", ["tv", "huber"])
def test_rof_matches_pallas(interpret, noisy, model):
    want = np.asarray(jps.rof_denoise(jnp.asarray(noisy), 8.0, iterations=ITERS, model=model))
    got = rof.denoise(torch.from_numpy(noisy), 8.0, iterations=ITERS, model=model).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_inpaint_matches_xla(noisy, mask):
    want = np.asarray(jdec._inpaint_xla(jnp.asarray(noisy), jnp.asarray(mask), iterations=ITERS))
    got = deconvolution.inpaint(torch.from_numpy(noisy), torch.from_numpy(mask),
                                iterations=ITERS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_inpaint_matches_pallas(interpret, noisy, mask):
    want = np.asarray(jps.rof_denoise(jnp.asarray(noisy), 10.0, iterations=ITERS, model="huber",
                                      lam_weight=jnp.asarray(mask)))
    got = deconvolution.inpaint(torch.from_numpy(noisy), torch.from_numpy(mask),
                                iterations=ITERS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_tgv_matches_xla(noisy):
    want = np.asarray(jtgv._denoise_xla(jnp.asarray(noisy), iterations=ITERS))
    got = tgv.denoise(torch.from_numpy(noisy), iterations=ITERS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_tgv_matches_pallas(interpret, noisy):
    want = np.asarray(jps.tgv_denoise(jnp.asarray(noisy), iterations=ITERS))
    got = tgv.denoise(torch.from_numpy(noisy), iterations=ITERS).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kshape,kx,ky,normalize", [((5, 3), None, None, True),
                                                    ((5, 3), 0, 4, False),
                                                    ((4, 4), 2, 1, True)])
def test_convolve_matches(noisy, kshape, kx, ky, normalize):
    k = np.random.default_rng(12).random(kshape).astype(np.float32)
    want = np.asarray(jconv.convolve(jnp.asarray(noisy), jnp.asarray(k), kx, ky, normalize))
    got = convolution.convolve(torch.from_numpy(noisy), torch.from_numpy(k), kx, ky,
                               normalize).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_deconvolve_matches(noisy):
    k = np.random.default_rng(13).random((5, 5)).astype(np.float32)
    blurry = np.array(jconv.convolve(jnp.asarray(noisy), jnp.asarray(k)))
    want = np.asarray(jdec.deconvolve(jnp.asarray(blurry), jnp.asarray(k), iterations=20))
    got = deconvolution.deconvolve(torch.from_numpy(blurry), torch.from_numpy(k),
                                   iterations=20).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_solves_denoise(noisy):
    """The mean error against the clean image falls: ROF 0.120 -> 0.021 and
    TGV -> 0.086 at the default 100 iterations; inpainting with a fifth of
    the pixels dropped -> 0.026."""
    clean = np.zeros_like(noisy)
    clean[12:30, 40:90] = 0.8
    g = torch.from_numpy(noisy)
    err_in = np.abs(noisy - clean).mean()
    assert np.abs(rof.denoise(g, 8.0).numpy() - clean).mean() < 0.5 * err_in
    assert np.abs(tgv.denoise(g).numpy() - clean).mean() < 0.8 * err_in
    keep = (np.random.default_rng(14).random(noisy.shape) > 0.2).astype(np.float32)
    out = deconvolution.inpaint(torch.from_numpy(noisy * keep), torch.from_numpy(keep),
                                iterations=100)
    assert np.abs(out.numpy() - clean).mean() < 0.5 * err_in


def test_cpu_solves_launch_no_kernel(noisy, mask):
    before = (solvers_cuda.rof_launches, solvers_cuda.tgv_launches)
    g = torch.from_numpy(noisy)
    rof.denoise(g, 8.0, iterations=2)
    tgv.denoise(g, iterations=2)
    deconvolution.inpaint(g, torch.from_numpy(mask), iterations=2)
    assert (solvers_cuda.rof_launches, solvers_cuda.tgv_launches) == before


def test_kernel_wrappers_refuse_cpu_tensors(noisy):
    g = torch.from_numpy(noisy)
    before = (solvers_cuda.rof_launches, solvers_cuda.tgv_launches)
    with pytest.raises(RuntimeError, match="sm_90"):
        solvers_cuda.rof_denoise(g, 8.0)
    with pytest.raises(RuntimeError, match="sm_90"):
        solvers_cuda.tgv_denoise(g)
    assert (solvers_cuda.rof_launches, solvers_cuda.tgv_launches) == before
