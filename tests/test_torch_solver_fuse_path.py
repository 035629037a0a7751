"""The routing and argument marshalling of the ROF, TGV and fuse wrappers
(``variational/solvers_cuda.py``, ``fusion/separable_cuda.py``), checked on
the CPU through a stand-in for the kernels' library that records each call:
the entry points launch ``kt_rof_denoise`` and ``kt_tgv_denoise``
(``ROF_STEPS`` and ``TGV_STEPS`` iterations a launch on tiles in shared
memory, reading one copy of the state and writing the other) and
``kt_separable_fuse`` (plane tiles) and count them; the private helpers of
the designs they replaced (``kt_rof_denoise_steps``,
``kt_tgv_denoise_steps``, ``kt_separable_fuse_voxel``), which only the card
checks call, pass the same arguments and count nothing. PyTorch emulations
of the ROF and TGV kernels' tile schedule (tiles with a halo, the cone,
ping-pong copies, a last launch of fewer steps, the image's edge rules by
global coordinate) are held to the plain versions exactly. The kernels
themselves are held against the replaced designs and the plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import contextlib
import re

import numpy as np
import pytest
import torch

from kangaroo_tpu_torch import _build, backend
from kangaroo_tpu_torch.backend import f32_scalars
from kangaroo_tpu_torch.fusion import separable_cuda
from kangaroo_tpu_torch.variational import deconvolution, rof, solvers_cuda, tgv

ROF_NAMES = ("g", "lam_weight", "u", "scratch", "H", "W", "lam", "sigma", "tau", "alpha",
             "huber", "iterations", "stream")
TGV_NAMES = ("f", "u", "scratch", "H", "W", "alpha0", "alpha1", "sigma", "tau", "delta",
             "iterations", "stream")
FUSE_NAMES = ("val", "weight", "gmd", "gct", "params", "window", "D", "H", "W", "axis", "gh",
              "gw", "Wi", "Hi", "stream")


class _Library:
    """Records the kernels' C entry calls by name; each returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        if not name.startswith("kt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or self.rc


@pytest.fixture
def library(monkeypatch):
    """The wrappers on CPU (or meta) tensors, launching into a recording
    stand-in; ``library.scratch`` records the shapes of the solvers' scratch."""
    lib = _Library()
    lib.scratch = []
    empty = torch.empty

    def recording_empty(*shape, **kwargs):
        t = empty(*shape, **kwargs)
        lib.scratch.append(tuple(t.shape))
        return t

    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(backend, "require_kernels", lambda t, op: None)
    monkeypatch.setattr(backend, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(solvers_cuda.torch, "empty", recording_empty)
    monkeypatch.setattr(solvers_cuda, "rof_launches", 0)
    monkeypatch.setattr(solvers_cuda, "tgv_launches", 0)
    monkeypatch.setattr(separable_cuda, "launches", 0)
    return lib


def _named(names, entry, args):
    assert len(args) == len(names) == len(_build.SIGNATURES[entry])
    return dict(zip(names, args))


def test_the_old_designs_share_the_argument_lists():
    assert _build.SIGNATURES["kt_rof_denoise_steps"] == _build.SIGNATURES["kt_rof_denoise"]
    assert _build.SIGNATURES["kt_separable_fuse_voxel"] == _build.SIGNATURES["kt_separable_fuse"]


def test_rof_steps_is_the_kernels_constant():
    """``solvers_cuda.ROF_STEPS`` is ``kSteps`` of ``csrc/rof.cu``."""
    src = (_build.CSRC_DIR / "rof.cu").read_text()
    assert re.findall(r"constexpr int kSteps = (\d+);", src) == [str(solvers_cuda.ROF_STEPS)]


@pytest.mark.parametrize("iterations", [1, solvers_cuda.ROF_STEPS + 1, 100])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("model", ["tv", "huber"])
def test_rof_launches_the_tile_solve(library, model, weighted, iterations):
    g = torch.ones(5, 9)
    weight = torch.full((5, 9), 0.5) if weighted else None
    u = solvers_cuda.rof_denoise(g, 8.0, 0.4, 0.3, 0.01, iterations, model, lam_weight=weight)
    (name, args), = library.calls
    c = _named(ROF_NAMES, name, args)
    assert name == "kt_rof_denoise" and u.shape == (5, 9) and u.dtype == torch.float32
    assert (c["g"], c["u"]) == (g.data_ptr(), u.data_ptr())
    assert c["lam_weight"] == (weight.data_ptr() if weighted else None)
    # the scratch: the second copy of u and both copies of p0, p1
    assert library.scratch[-1] == (5, 5, 9)
    assert c["scratch"] not in (g.data_ptr(), u.data_ptr())
    assert (c["H"], c["W"], c["huber"], c["iterations"], c["stream"]) == (
        5, 9, int(model == "huber"), iterations, 0)
    assert np.float32(c["lam"]) == np.float32(8.0) and c["sigma"] == 0.4
    assert (c["tau"], c["alpha"]) == (0.3, 0.01)
    assert solvers_cuda.rof_launches == 1


def test_rof_zero_iterations_count_nothing(library):
    solvers_cuda.rof_denoise(torch.ones(3, 4), 8.0, iterations=0)
    (name, args), = library.calls
    assert name == "kt_rof_denoise" and _named(ROF_NAMES, name, args)["iterations"] == 0
    assert solvers_cuda.rof_launches == 0


def test_rof_steps_design_takes_the_same_arguments(library):
    """``_rof_denoise_steps`` passes ``kt_rof_denoise_steps`` what
    ``rof_denoise`` passes ``kt_rof_denoise`` (the output and a scratch of
    two planes aside), counting nothing."""
    g, weight = torch.ones(6, 7), torch.zeros(6, 7)
    new = solvers_cuda.rof_denoise(g, 2.0, iterations=13, model="tv", lam_weight=weight)
    old = solvers_cuda._rof_denoise_steps(g, 2.0, iterations=13, model="tv", lam_weight=weight)
    (n_new, a_new), (n_old, a_old) = library.calls
    assert (n_new, n_old) == ("kt_rof_denoise", "kt_rof_denoise_steps")
    c_new, c_old = _named(ROF_NAMES, n_new, a_new), _named(ROF_NAMES, n_old, a_old)
    assert c_new.pop("u") == new.data_ptr() and c_old.pop("u") == old.data_ptr()
    c_new.pop("scratch"), c_old.pop("scratch")
    assert c_new == c_old
    assert library.scratch[-2:] == [(5, 6, 7), (2, 6, 7)]
    assert solvers_cuda.rof_launches == 1


def test_denoise_and_inpaint_run_one_tile_solve_each(library):
    """Off the CPU (meta tensors stand in for the card's) ``rof.denoise``
    and ``deconvolution.inpaint`` launch ``kt_rof_denoise`` once a solve;
    inpaint's mask is the lambda weight."""
    g = torch.empty(12, 20, device="meta")
    rof.denoise(g, 8.0, iterations=30, model="tv")
    deconvolution.inpaint(g, torch.empty(12, 20, device="meta"), iterations=300)
    assert [name for name, _ in library.calls] == ["kt_rof_denoise"] * 2
    (_, a_rof), (_, a_inp) = library.calls
    c_rof, c_inp = _named(ROF_NAMES, "kt_rof_denoise", a_rof), _named(ROF_NAMES,
                                                                      "kt_rof_denoise", a_inp)
    assert (c_rof["lam_weight"], c_rof["huber"], c_rof["iterations"]) == (None, 0, 30)
    assert c_inp["lam_weight"] is not None and (c_inp["huber"], c_inp["iterations"]) == (1, 300)
    assert (c_inp["lam"], c_inp["H"], c_inp["W"]) == (10.0, 12, 20)
    assert solvers_cuda.rof_launches == 2


def test_rof_checks_before_it_launches(library):
    g = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="lam_weight"):
        solvers_cuda.rof_denoise(g, 1.0, lam_weight=torch.zeros(4, 5))
    with pytest.raises(ValueError, match="model"):
        solvers_cuda._rof_denoise_steps(g, 1.0, model="l1")
    with pytest.raises(ValueError, match="iterations"):
        solvers_cuda.rof_denoise(g, 1.0, iterations=-1)
    with pytest.raises(RuntimeError, match="requires grad"):
        solvers_cuda.rof_denoise(g.clone().requires_grad_(True), 1.0)
    with pytest.raises(TypeError):
        solvers_cuda.rof_denoise(g.double(), 1.0)
    assert library.calls == [] and solvers_cuda.rof_launches == 0


def test_tgv_steps_is_the_kernels_constant():
    """``solvers_cuda.TGV_STEPS`` is ``kSteps`` of ``csrc/tgv.cu``."""
    src = (_build.CSRC_DIR / "tgv.cu").read_text()
    assert re.findall(r"constexpr int kSteps = (\d+);", src) == [str(solvers_cuda.TGV_STEPS)]
    assert _build.SIGNATURES["kt_tgv_denoise_steps"] == _build.SIGNATURES["kt_tgv_denoise"]


@pytest.mark.parametrize("iterations", [1, solvers_cuda.TGV_STEPS + 1, 100])
def test_tgv_launches_the_tile_solve(library, iterations):
    f = torch.ones(5, 9)
    u = solvers_cuda.tgv_denoise(f, 3.0, 1.5, 0.4, 0.3, 0.05, iterations)
    (name, args), = library.calls
    c = _named(TGV_NAMES, name, args)
    assert name == "kt_tgv_denoise" and u.shape == (5, 9) and u.dtype == torch.float32
    assert (c["f"], c["u"]) == (f.data_ptr(), u.data_ptr())
    # the scratch: the second copy of u and both copies of the other eight planes
    assert library.scratch[-1] == (17, 5, 9)
    assert c["scratch"] not in (f.data_ptr(), u.data_ptr())
    assert (c["H"], c["W"], c["iterations"], c["stream"]) == (5, 9, iterations, 0)
    assert [c[k] for k in ("alpha0", "alpha1", "sigma", "tau", "delta")] == [
        3.0, 1.5, 0.4, 0.3, 0.05]
    assert solvers_cuda.tgv_launches == 1


def test_tgv_zero_iterations_count_nothing(library):
    solvers_cuda.tgv_denoise(torch.ones(3, 4), iterations=0)
    (name, args), = library.calls
    assert name == "kt_tgv_denoise" and _named(TGV_NAMES, name, args)["iterations"] == 0
    assert solvers_cuda.tgv_launches == 0


def test_tgv_steps_design_takes_the_same_arguments(library):
    """``_tgv_denoise_steps`` passes ``kt_tgv_denoise_steps`` what
    ``tgv_denoise`` passes ``kt_tgv_denoise`` (the output and a scratch of
    eight planes aside), counting nothing."""
    f = torch.ones(6, 7)
    new = solvers_cuda.tgv_denoise(f, 2.5, iterations=13)
    old = solvers_cuda._tgv_denoise_steps(f, 2.5, iterations=13)
    (n_new, a_new), (n_old, a_old) = library.calls
    assert (n_new, n_old) == ("kt_tgv_denoise", "kt_tgv_denoise_steps")
    c_new, c_old = _named(TGV_NAMES, n_new, a_new), _named(TGV_NAMES, n_old, a_old)
    assert c_new.pop("u") == new.data_ptr() and c_old.pop("u") == old.data_ptr()
    c_new.pop("scratch"), c_old.pop("scratch")
    assert c_new == c_old
    assert library.scratch[-2:] == [(17, 6, 7), (8, 6, 7)]
    assert solvers_cuda.tgv_launches == 1


def test_tgv_denoise_runs_one_tile_solve(library):
    """Off the CPU (a meta tensor stands in for the card's) ``tgv.denoise``
    launches ``kt_tgv_denoise`` once a solve, with its own defaults."""
    tgv.denoise(torch.empty(12, 20, device="meta"), iterations=30)
    (name, args), = library.calls
    c = _named(TGV_NAMES, name, args)
    assert name == "kt_tgv_denoise" and (c["H"], c["W"], c["iterations"]) == (12, 20, 30)
    assert [c[k] for k in ("alpha0", "alpha1", "sigma", "tau", "delta")] == [
        2.0, 1.0, 0.5, 0.25, 0.1]
    assert solvers_cuda.tgv_launches == 1


def test_tgv_checks_before_it_launches(library):
    f = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="iterations"):
        solvers_cuda.tgv_denoise(f, iterations=-1)
    with pytest.raises(ValueError, match="iterations"):
        solvers_cuda._tgv_denoise_steps(f, iterations=-2)
    with pytest.raises(RuntimeError, match="requires grad"):
        solvers_cuda.tgv_denoise(f.clone().requires_grad_(True))
    with pytest.raises(TypeError):
        solvers_cuda.tgv_denoise(f.double())
    assert library.calls == [] and solvers_cuda.tgv_launches == 0


def test_tgv_failed_launch_raises_and_counts_nothing(library):
    library.rc = 1
    with pytest.raises(RuntimeError, match="cudaError 1"):
        solvers_cuda.tgv_denoise(torch.ones(3, 4), iterations=3)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        solvers_cuda._tgv_denoise_steps(torch.ones(3, 4), iterations=3)
    assert solvers_cuda.tgv_launches == 0


def test_cpu_tensors_take_the_plain_tgv_solve(library):
    f = torch.from_numpy(np.random.default_rng(5).random((9, 11), dtype=np.float32))
    assert torch.equal(tgv.denoise(f, iterations=4), tgv.denoise_plain(f, iterations=4))
    assert library.calls == [] and solvers_cuda.tgv_launches == 0


def _fuse_inputs(shape=(6, 5, 9)):
    val, weight = torch.zeros(shape), torch.ones(shape)
    gmd, gct = torch.zeros(4, 7), torch.ones(4, 7)
    return val, weight, gmd, gct, torch.zeros(20), torch.tensor([1, 4], dtype=torch.int32)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fuse_launches_the_plane_tiles(library, axis):
    val, weight, gmd, gct, params, window = _fuse_inputs()
    out = separable_cuda.fuse_planes(val, weight, gmd, gct, params, window, axis, 64, 48)
    (name, args), = library.calls
    c = _named(FUSE_NAMES, name, args)
    assert name == "kt_separable_fuse" and out[0] is val and out[1] is weight
    assert [c[k] for k in ("val", "weight", "gmd", "gct", "params", "window")] == [
        t.data_ptr() for t in (val, weight, gmd, gct, params, window)]
    assert [c[k] for k in ("D", "H", "W", "axis", "gh", "gw", "Wi", "Hi", "stream")] == [
        6, 5, 9, axis, 4, 7, 64, 48, 0]
    assert separable_cuda.launches == 1


def test_fuse_voxel_design_takes_the_same_arguments(library):
    inputs = _fuse_inputs((7, 3, 8))
    separable_cuda.fuse_planes(*inputs, 2, 32, 24)
    separable_cuda._fuse_planes_voxel(*inputs, 2, 32, 24)
    (n_new, a_new), (n_old, a_old) = library.calls
    assert (n_new, n_old) == ("kt_separable_fuse", "kt_separable_fuse_voxel")
    assert a_new == a_old
    assert separable_cuda.launches == 1


def test_fuse_checks_before_it_launches(library):
    val, weight, gmd, gct, params, window = _fuse_inputs()
    with pytest.raises(ValueError, match="params"):
        separable_cuda.fuse_planes(val, weight, gmd, gct, params[:19], window, 0, 64, 48)
    with pytest.raises(ValueError, match="axis"):
        separable_cuda._fuse_planes_voxel(val, weight, gmd, gct, params, window, 3, 64, 48)
    with pytest.raises(TypeError):
        separable_cuda.fuse_planes(val, weight, gmd, gct, params, window.long(), 0, 64, 48)
    with pytest.raises(ValueError, match="do not match"):
        separable_cuda.fuse_planes(val, weight[:5], gmd, gct, params, window, 0, 64, 48)
    assert library.calls == [] and separable_cuda.launches == 0


def test_failed_launch_raises_and_counts_nothing(library):
    library.rc = 1
    with pytest.raises(RuntimeError, match="cudaError 1"):
        solvers_cuda.rof_denoise(torch.ones(3, 4), 1.0, iterations=3)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        separable_cuda.fuse_planes(*_fuse_inputs(), 0, 64, 48)
    assert solvers_cuda.rof_launches == 0 and separable_cuda.launches == 0


def test_cpu_tensors_take_the_plain_solve(library):
    g = torch.from_numpy(np.random.default_rng(3).random((9, 11), dtype=np.float32))
    assert torch.equal(rof.denoise(g, 8.0, iterations=4), rof.denoise_plain(g, 8.0,
                                                                            iterations=4))
    assert library.calls == [] and solvers_cuda.rof_launches == 0


# --- the ROF kernel's tile schedule, emulated ------------------------------

def tiled_rof(g, lam, sigma, tau, alpha, iterations, model, lam_weight, steps, tile):
    """``kt_rof_denoise``'s schedule in PyTorch: launches of ``steps``
    iterations (the last of what is left), each tile of ``tile`` (rows,
    columns) with a halo ``steps`` wide, clipped to the image, read from one
    copy of (u, p) (the first launch from u = g, p = 0) and run there; step
    m updates p at depth >= m and u at depth >= m + 1, depth being the
    distance from the nearest side of the halo with image beyond it; the
    tile's interior goes to the other copy."""
    lam, sigma, tau, alpha = f32_scalars(g.device, lam, sigma, tau, alpha)
    H, W = g.shape
    TY, TX = tile
    launches = -(-iterations // steps)
    copies = [(torch.full_like(g, float("nan")), torch.full((H, W, 2), float("nan")))
              for _ in range(2)]
    for launch in range(launches):
        src, dst = copies[(launches - launch) % 2], copies[(launches - 1 - launch) % 2]
        n = min(steps, iterations - launch * steps)
        for y0 in range(0, H, TY):
            for x0 in range(0, W, TX):
                ya, yb = max(y0 - steps, 0), min(y0 + TY + steps, H)
                xa, xb = max(x0 - steps, 0), min(x0 + TX + steps, W)
                ys, xs = torch.arange(ya, yb)[:, None], torch.arange(xa, xb)[None, :]
                big = torch.tensor(1 << 20)
                depth = torch.minimum(
                    torch.minimum(ys - ya if ya > 0 else big, yb - 1 - ys if yb < H else big),
                    torch.minimum(xs - xa if xa > 0 else big, xb - 1 - xs if xb < W else big))
                gt = g[ya:yb, xa:xb]
                wt = None if lam_weight is None else lam_weight[ya:yb, xa:xb]
                if launch == 0:
                    u, p = gt, torch.zeros(gt.shape + (2,))
                else:
                    u, p = src[0][ya:yb, xa:xb], src[1][ya:yb, xa:xb]
                for m in range(n):
                    if model == "tv":
                        p_new = rof.tvl1_dual_ascent_p(p, u, sigma)
                    else:
                        p_new = rof.huber_dual_ascent_p(p, u, sigma, alpha)
                    p = torch.where((depth >= m)[..., None], p_new, p)
                    u_new = rof.l2_primal_descent(u, p, gt, tau, lam, lambda_weight=wt)
                    u = torch.where(depth >= m + 1, u_new, u)
                ty, tx = slice(y0 - ya, y0 - ya + TY), slice(x0 - xa, x0 - xa + TX)
                dst[0][y0:y0 + TY, x0:x0 + TX] = u[ty, tx]
                dst[1][y0:y0 + TY, x0:x0 + TX] = p[ty, tx]
    return copies[0][0] if iterations else g.clone()


@pytest.mark.parametrize("steps,iterations", [(1, 5), (3, 7), (3, 11), (8, 11), (8, 21)])
@pytest.mark.parametrize("mode", ["tv", "huber", "lambda_weight"])
def test_tile_schedule_equals_the_plain_solve(mode, steps, iterations):
    """The schedule on 4x8 tiles of a 13x27 image (ragged tiles, halos
    wider than a tile, cut and uncut sides) equals ``denoise_plain`` bit
    for bit, NaN and infinity included."""
    rng = np.random.default_rng(steps * 100 + iterations)
    g = torch.from_numpy(rng.standard_normal((13, 27)).astype(np.float32))
    g[3, 5], g[9, 20], g[0, 26] = float("nan"), float("inf"), float("-inf")
    weight = (torch.from_numpy((rng.random((13, 27)) > 0.3).astype(np.float32))
              if mode == "lambda_weight" else None)
    model = "tv" if mode == "tv" else "huber"
    got = tiled_rof(g, 8.0, 0.5, 0.25, 0.002, iterations, model, weight, steps, (4, 8))
    want = rof.denoise_plain(g, 8.0, 0.5, 0.25, 0.002, iterations, model, lam_weight=weight)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


@pytest.mark.parametrize("shape", [(1, 1), (1, 19), (19, 1), (3, 5)])
def test_tile_schedule_on_images_smaller_than_a_tile(shape):
    g = torch.from_numpy(np.random.default_rng(4).random(shape, dtype=np.float32))
    for iterations in (0, 3, 8):
        got = tiled_rof(g, 8.0, 0.5, 0.25, 0.002, iterations, "huber", None, 3, (4, 8))
        assert torch.equal(got, rof.denoise_plain(g, 8.0, iterations=iterations))


# --- the TGV kernel's tile schedule, emulated -------------------------------

def tiled_tgv(f, alpha0, alpha1, sigma, tau, delta, iterations, steps, tile):
    """``kt_tgv_denoise``'s schedule in PyTorch: launches of ``steps``
    iterations (the last of what is left), each tile of ``tile`` (rows,
    columns) with a halo ``steps`` wide, clipped to the image, read from one
    copy of the nine planes (the first launch from u = f, the rest 0) and run
    there; step m's ascent updates p, q, r at depth >= m and its descent u, v
    at depth >= m + 1, depth being the distance from the nearest side of the
    halo with image beyond it; the tile's interior goes to the other copy."""
    alpha0, alpha1, sigma, tau, delta = f32_scalars(f.device, alpha0, alpha1, sigma, tau, delta)
    H, W = f.shape
    TY, TX = tile
    launches = -(-iterations // steps)
    copies = [tgv.TgvState(*(torch.full(t.shape, float("nan")) for t in tgv.init(f)))
              for _ in range(2)]
    for launch in range(launches):
        src, dst = copies[(launches - launch) % 2], copies[(launches - 1 - launch) % 2]
        n = min(steps, iterations - launch * steps)
        for y0 in range(0, H, TY):
            for x0 in range(0, W, TX):
                ya, yb = max(y0 - steps, 0), min(y0 + TY + steps, H)
                xa, xb = max(x0 - steps, 0), min(x0 + TX + steps, W)
                ys, xs = torch.arange(ya, yb)[:, None], torch.arange(xa, xb)[None, :]
                big = torch.tensor(1 << 20)
                depth = torch.minimum(
                    torch.minimum(ys - ya if ya > 0 else big, yb - 1 - ys if yb < H else big),
                    torch.minimum(xs - xa if xa > 0 else big, xb - 1 - xs if xb < W else big))
                ft = f[ya:yb, xa:xb]
                s = (tgv.init(ft) if launch == 0
                     else tgv.TgvState(*(t[ya:yb, xa:xb] for t in src)))
                for m in range(n):
                    p, q, r = tgv.ascent(s, ft, alpha0, alpha1, sigma, delta)
                    on = depth >= m
                    p = torch.where(on[..., None], p, s.p)
                    q = torch.where(on[..., None], q, s.q)
                    r = torch.where(on, r, s.r)
                    u, v = tgv.descent(s, p, q, r, alpha0, alpha1, tau)
                    on = depth >= m + 1
                    s = tgv.TgvState(torch.where(on, u, s.u), torch.where(on[..., None], v, s.v),
                                     p, q, r)
                ty, tx = slice(y0 - ya, y0 - ya + TY), slice(x0 - xa, x0 - xa + TX)
                for d, t in zip(dst, s):
                    d[y0:y0 + TY, x0:x0 + TX] = t[ty, tx]
    return copies[0].u if iterations else f.clone()


TGV_ARGS = (2.0, 1.0, 0.5, 0.25, 0.1)  # alpha0, alpha1, sigma, tau, delta: the defaults


@pytest.mark.parametrize("steps,iterations", [(1, 5), (3, 7), (3, 11), (8, 21)])
def test_tgv_tile_schedule_equals_the_plain_solve(steps, iterations):
    """The schedule on 4x8 tiles of a 13x27 image (ragged tiles, halos
    wider than a tile, cut and uncut sides) equals ``denoise_plain`` bit
    for bit, NaN and infinity included."""
    rng = np.random.default_rng(steps * 100 + iterations + 7)
    f = torch.from_numpy(rng.standard_normal((13, 27)).astype(np.float32))
    f[3, 5], f[9, 20], f[0, 26] = float("nan"), float("inf"), float("-inf")
    got = tiled_tgv(f, *TGV_ARGS, iterations, steps, (4, 8))
    want = tgv.denoise_plain(f, *TGV_ARGS, iterations)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


@pytest.mark.parametrize("shape", [(1, 1), (1, 19), (19, 1), (3, 5)])
def test_tgv_tile_schedule_on_images_smaller_than_a_tile(shape):
    f = torch.from_numpy(np.random.default_rng(6).random(shape, dtype=np.float32))
    for iterations in (0, 3, 8):
        got = tiled_tgv(f, *TGV_ARGS, iterations, 3, (4, 8))
        assert torch.equal(got, tgv.denoise_plain(f, *TGV_ARGS, iterations))
