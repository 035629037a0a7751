"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device of compute capability 9.0 and nvcc; it
skips elsewhere. The file imports nothing of JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.) Tolerances: SGM
1e-4 on the disparity lattice (one float32 recurrence, the same operation
order, but the compiler may differ), 8-path too; WTA 1e-5; median and LR
check exact, NaN positions included; ROF and TGV 1e-4 max abs after 100
iterations (the same operations in the same order as the plain version,
but TGV amplifies any last-bit difference); the DTAM auxiliary search
1e-5 and the DTAM alternation 1e-4 px (the same operations in the same
order, each rounded on its own, so 0 is expected). The whole-image path
kernel and the segment kernel (``csrc/sgm_path.cu``) equal the warp-per-line
design (``csrc/sgm.cu``, ``kt_sgm_segment_lines``) exactly: the same
operations per element in the same order (the horizontal directions also
equal the plain version exactly); so do the ROF and TGV solves on
tiles and the fuse on plane tiles the designs they replaced
(``kt_rof_denoise_steps``, ``kt_tgv_denoise_steps``,
``kt_separable_fuse_voxel``). The median on tiles equals
``kt_median_reject_invalid_pixel`` (another exact sorting network selects
the same value; +0 and -0 count as equal), and the LR check on rows, one
way and as the pair of both directions, ``kt_lr_check_pixel`` exactly.
The census transform and its Hamming volume (``csrc/census.cu``) equal
their plain versions bit for bit: integer words, and integer counts scaled
by a power of two.
"""
import numpy as np
import pytest
import torch

from kangaroo_tpu_torch.apps import stereo, stereo_sgm, synthetic
from kangaroo_tpu_torch.ops import median as median_plain
from kangaroo_tpu_torch.ops import median_cuda
from kangaroo_tpu_torch.stereo import (census, costvolume, costvolume_cuda, dispatch, dtam_cuda,
                                       lr_cuda, sgm_cuda, wta_cuda)
from kangaroo_tpu_torch.stereo import sgm as sgm_plain
from kangaroo_tpu_torch.utils import profiling
from kangaroo_tpu_torch.variational import deconvolution, rof, solvers_cuda, tgv

pytestmark = pytest.mark.cuda
SHAPES = [(16, 16, 128), (200, 37, 61)]  # (D, H, W): one small, one odd
# (D, H, W) of the 8-path kernel tests: VGA and KITTI-sized
FRAME_SHAPES = [(64, 480, 640), (128, 375, 1242)]
# (H, W) of the solver tests: VGA, KITTI-sized, and KITTI-sized transposed
IMAGE_SHAPES = [(480, 640), (375, 1242), (1242, 375)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of compute capability 9.0 (H100)")
    return torch.device("cuda:0")


def _lattice(D, W, sd, dev):
    d = torch.arange(D, device=dev)[:, None, None]
    x = torch.arange(W, device=dev)[None, None, :]
    return (d <= x) if sd < 0 else (x + d < W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_sgm_kernel_matches_plain(dev, shape, sd, dtype):
    D, H, W = shape
    rng = np.random.default_rng(0)
    vol = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev, dtype)
    img = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
    m = _lattice(D, W, sd, dev).expand(shape)
    got = sgm_cuda.semi_global_matching(vol, img, 0.01, 0.02, sd=sd)
    want = sgm_plain.semi_global_matching(vol, img, 0.01, 0.02, sd=sd)
    torch.testing.assert_close(got[m], want[m], atol=1e-4, rtol=0)


@pytest.mark.parametrize("do_horiz,do_vert,do_reverse",
                         [(True, False, True), (False, True, False), (False, False, True)])
def test_sgm_direction_flags(dev, do_horiz, do_vert, do_reverse):
    rng = np.random.default_rng(1)
    vol = torch.from_numpy(rng.random((8, 12, 40), dtype=np.float32)).to(dev)
    img = torch.from_numpy(rng.random((12, 40), dtype=np.float32)).to(dev)
    args = (vol, img, 0.05, 0.1, do_horiz, do_vert, do_reverse)
    m = _lattice(8, 40, -1, dev).expand(vol.shape)
    torch.testing.assert_close(sgm_cuda.semi_global_matching(*args)[m],
                               sgm_plain.semi_global_matching(*args)[m], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_wta_kernel_matches_plain(dev, shape, sd, dtype):
    rng = np.random.default_rng(2)
    # multiples of 1/64: exact in bfloat16 and full of ties
    vol = torch.from_numpy((rng.integers(0, 64, shape) / 64.0).astype(np.float32)).to(dev, dtype)
    torch.testing.assert_close(wta_cuda.cost_vol_minimum_subpix(vol, sd),
                               costvolume.cost_vol_minimum_subpix(vol, sd), atol=1e-5, rtol=0)


@pytest.mark.parametrize("rad,max_bad", [(1, 4), (2, 12), (3, 20)])
def test_median_kernel_matches_plain(dev, rad, max_bad):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 16, (37, 61)).astype(np.float32)
    img[rng.random(img.shape) < 0.15] = np.nan
    img[rng.random(img.shape) < 0.03] = np.inf
    img[4:12, 6:16] = np.nan
    img = torch.from_numpy(img).to(dev)
    torch.testing.assert_close(median_cuda.median_filter_reject_invalid(img, max_bad, rad),
                               median_plain.median_filter_reject_invalid(img, max_bad, rad),
                               atol=0, rtol=0, equal_nan=True)


@pytest.mark.parametrize("sd", [-1, 1])
def test_lr_kernel_matches_plain(dev, sd):
    rng = np.random.default_rng(4)
    D, H, W = 16, 37, 61
    dl = rng.uniform(-3, D + 3, (H, W)).astype(np.float32)
    dr = (dl + rng.normal(0, 0.8, (H, W))).astype(np.float32)
    dl[rng.random((H, W)) < 0.1] = np.nan
    dr[rng.random((H, W)) < 0.1] = np.nan
    dl, dr = torch.from_numpy(dl).to(dev), torch.from_numpy(dr).to(dev)
    torch.testing.assert_close(lr_cuda.left_right_check(dl, dr, sd, 1.0, max_disp=D),
                               costvolume.left_right_check(dl, dr, sd, 1.0, max_disp=D),
                               atol=0, rtol=0, equal_nan=True)


@pytest.mark.parametrize("overrides", [{}, dict(bilateral_filter=True, bilateral_size=3)])
def test_pipeline_on_card_matches_cpu(dev, overrides):
    left, right, _ = synthetic.stereo_pair(96, 32, 16, seed=0, device="cpu")
    cfg = stereo_sgm.SgmConfig(max_disp=16, **overrides)
    counts = [m.launches for m in (sgm_cuda, wta_cuda, median_cuda, lr_cuda)]
    got = stereo_sgm.sgm_pipeline(left.to(dev), right.to(dev), cfg).cpu()
    assert [m.launches for m in (sgm_cuda, wta_cuda, median_cuda, lr_cuda)] == \
        [c + n for c, n in zip(counts, (4, 2, 2, 1))]
    want = stereo_sgm.sgm_pipeline(left, right, cfg)
    agree = (torch.isnan(got) & torch.isnan(want)) | ((got - want).abs() <= 1e-3)
    assert agree.float().mean().item() >= 0.995


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", FRAME_SHAPES)
def test_sgm_eight_path_kernel_matches_plain(dev, shape, sd, dtype):
    D, H, W = shape
    rng = np.random.default_rng(5)
    vol = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev, dtype)
    img = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
    m = _lattice(D, W, sd, dev).expand(shape)
    got = sgm_cuda.semi_global_matching(vol, img, 0.01, 0.02, do_diagonal=True, sd=sd)
    want = sgm_plain.semi_global_matching(vol, img, 0.01, 0.02, do_diagonal=True, sd=sd)
    torch.testing.assert_close(got[m], want[m], atol=1e-4, rtol=0)


@pytest.mark.parametrize("do_horiz,do_vert,do_reverse",
                         [(True, False, True), (True, True, False), (False, False, False)])
def test_sgm_eight_path_flags(dev, do_horiz, do_vert, do_reverse):
    rng = np.random.default_rng(6)
    vol = torch.from_numpy(rng.random((8, 12, 40), dtype=np.float32)).to(dev)
    img = torch.from_numpy(rng.random((12, 40), dtype=np.float32)).to(dev)
    args = (vol, img, 0.05, 0.1, do_horiz, do_vert, do_reverse, True)
    m = _lattice(8, 40, -1, dev).expand(vol.shape)
    before = sgm_cuda.diagonal_launches
    got = sgm_cuda.semi_global_matching(*args)
    assert sgm_cuda.diagonal_launches == before + 4
    torch.testing.assert_close(got[m], sgm_plain.semi_global_matching(*args)[m], atol=1e-4,
                               rtol=0)


def _noisy_image(shape, dev, seed=7):
    rng = np.random.default_rng(seed)
    H, W = shape
    clean = np.zeros(shape, np.float32)
    clean[H // 4:H // 2, W // 4:W // 2] = 0.8
    noisy = clean + 0.15 * rng.standard_normal(shape).astype(np.float32)
    keep = (rng.random(shape) > 0.2).astype(np.float32)
    return (torch.from_numpy(noisy).to(dev), torch.from_numpy(keep).to(dev))


@pytest.mark.parametrize("mode", ["tv", "huber", "lambda_weight"])
@pytest.mark.parametrize("shape", IMAGE_SHAPES)
def test_rof_kernel_matches_plain(dev, shape, mode):
    g, keep = _noisy_image(shape, dev)
    weight = keep if mode == "lambda_weight" else None
    model = "tv" if mode == "tv" else "huber"
    got = solvers_cuda.rof_denoise(g, 8.0, model=model, lam_weight=weight)
    want = rof.denoise_plain(g, 8.0, model=model, lam_weight=weight)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", IMAGE_SHAPES)
def test_tgv_kernel_matches_plain(dev, shape):
    f, _ = _noisy_image(shape, dev)
    torch.testing.assert_close(solvers_cuda.tgv_denoise(f), tgv.denoise_plain(f), atol=1e-4,
                               rtol=0)


def test_solver_entry_points_launch_the_kernels(dev):
    g, keep = _noisy_image((37, 61), dev)
    before = (solvers_cuda.rof_launches, solvers_cuda.tgv_launches)
    outs = (rof.denoise(g, 8.0, iterations=10), tgv.denoise(g, iterations=10),
            deconvolution.inpaint(g, keep, iterations=10))
    assert (solvers_cuda.rof_launches, solvers_cuda.tgv_launches) == (before[0] + 2,
                                                                      before[1] + 1)
    for out in outs:
        assert out.shape == g.shape and bool(torch.isfinite(out).all())
    # zero iterations return the input and count no launch
    torch.testing.assert_close(solvers_cuda.tgv_denoise(g, iterations=0), g, atol=0, rtol=0)
    assert solvers_cuda.tgv_launches == before[1] + 1


def test_eight_path_pipeline_on_card_matches_cpu(dev):
    left, right, _ = synthetic.stereo_pair(96, 32, 16, seed=0, device="cpu")
    cfg = stereo_sgm.SgmConfig(max_disp=16, do_diagonal=True)
    counts = (sgm_cuda.launches, sgm_cuda.diagonal_launches)
    got = stereo_sgm.sgm_pipeline(left.to(dev), right.to(dev), cfg).cpu()
    assert (sgm_cuda.launches, sgm_cuda.diagonal_launches) == (counts[0] + 4, counts[1] + 4)
    want = stereo_sgm.sgm_pipeline(left, right, cfg)
    agree = (torch.isnan(got) & torch.isnan(want)) | ((got - want).abs() <= 1e-3)
    assert agree.float().mean().item() >= 0.995


def test_wrappers_check_their_arguments(dev):
    vol = torch.zeros(8, 12, 40, device=dev)
    with pytest.raises(TypeError):
        wta_cuda.cost_vol_minimum_subpix(vol.to(torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        wta_cuda.cost_vol_minimum_subpix(vol.transpose(1, 2))
    with pytest.raises(ValueError):
        sgm_cuda.semi_global_matching(torch.zeros(300, 4, 4, device=dev),
                                      torch.zeros(4, 4, device=dev))
    with pytest.raises(ValueError):
        median_cuda.median_filter_reject_invalid(torch.zeros(8, 8, device=dev), 12, rad=5)
    g = torch.zeros(8, 12, device=dev)
    with pytest.raises(RuntimeError, match="requires grad"):
        solvers_cuda.rof_denoise(g.clone().requires_grad_(True), 8.0)
    with pytest.raises(ValueError, match="lam_weight"):
        solvers_cuda.rof_denoise(g, 8.0, lam_weight=torch.zeros(8, 13, device=dev))
    with pytest.raises(ValueError, match="model"):
        solvers_cuda.rof_denoise(g, 8.0, model="l1")
    with pytest.raises(TypeError):
        solvers_cuda.tgv_denoise(g.double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", SHAPES + FRAME_SHAPES)
def test_wta_sq_kernel_matches_plain(dev, shape, sd, dtype):
    D, H, W = shape
    rng = np.random.default_rng(8)
    # costs k/256: exact in bfloat16, with ties
    vol = torch.from_numpy((rng.integers(0, 257, shape) / 256.0).astype(np.float32)).to(dev, dtype)
    last = torch.from_numpy(rng.uniform(-2, D + 2, (H, W)).astype(np.float32)).to(dev)
    for theta in (100.0, 1.0, 1e-3):
        torch.testing.assert_close(
            wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, last, 20.0, theta, sd),
            costvolume.cost_vol_minimum_square_penalty_subpix(vol, last, 20.0, theta, sd),
            atol=1e-5, rtol=0)


def _dtam_inputs(shape, dev, seed=9):
    D, H, W = shape
    rng = np.random.default_rng(seed)
    vol = torch.from_numpy((rng.integers(0, 257, shape) / 256.0).astype(np.float32))
    img = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
    g = costvolume.exponential_edge_weight(img, 14.0, 2.5)
    vol = vol.to(dev, torch.bfloat16)
    return vol, g, costvolume.cost_vol_minimum_subpix(vol, -1)


DTAM_ARGS = (20.0, 0.7, 0.7, 0.002)  # lam, sigma_q, sigma_d, huber_alpha


@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", FRAME_SHAPES)
def test_dtam_kernel_matches_plain(dev, shape, sd):
    vol, g, d0 = _dtam_inputs(shape, dev)
    q0 = torch.zeros(d0.shape + (2,), device=dev)
    got = dtam_cuda.dtam_run(vol, g, d0, d0, q0, 100.0, 1.0, *DTAM_ARGS, 1e-5, 50, sd)
    want = stereo.dtam_iterate_plain(vol, g, d0, d0, q0, 100.0, 1.0, *DTAM_ARGS, 1e-5, 50, sd)
    for name, a, b in zip("d a q theta".split(), got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=name)


@pytest.mark.parametrize("shape", FRAME_SHAPES)
def test_dtam_steps_chain_and_match_plain(dev, shape):
    vol, g, d0 = _dtam_inputs(shape, dev, seed=10)
    state = (d0, d0, torch.zeros(d0.shape + (2,), device=dev), 100.0, 0.0)
    six = dtam_cuda.dtam_step(vol, g, *state, *DTAM_ARGS, 1e-3, iterations=6)
    s1 = dtam_cuda.dtam_step(vol, g, *state, *DTAM_ARGS, 1e-3, iterations=3)
    s2 = dtam_cuda.dtam_step(vol, g, *s1, *DTAM_ARGS, 1e-3, iterations=3)
    plain = stereo.dtam_increment(vol.cpu(), g.cpu(), d0.cpu(), d0.cpu(),
                                  torch.zeros(d0.shape + (2,)), 100.0, 0.0, *DTAM_ARGS, 1e-3,
                                  iterations=6)
    for name, a, b, p in zip("d a q theta n".split(), six, s2, plain):
        torch.testing.assert_close(b, a, atol=0, rtol=0, msg=name)
        # the CPU's plain version: the same formula, other sqrt/division units
        torch.testing.assert_close(a.cpu(), p, atol=1e-4, rtol=0, msg=name)


def test_dtam_wrappers_check_their_arguments(dev):
    vol, g, d0 = _dtam_inputs((8, 12, 40), dev)
    q = torch.zeros(12, 40, 2, device=dev)
    args = (100.0, 1.0, *DTAM_ARGS, 1e-5, 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        dtam_cuda.dtam_run(vol, g, d0.clone().requires_grad_(True), d0, q, *args)
    with pytest.raises(ValueError, match="does not match"):
        dtam_cuda.dtam_run(vol, g[:, :39].contiguous(), d0, d0, q, *args)
    with pytest.raises(ValueError, match="q"):
        dtam_cuda.dtam_run(vol, g, d0, d0, q[..., :1], *args)
    with pytest.raises(TypeError):
        dtam_cuda.dtam_run(vol.to(torch.float16), g, d0, d0, q, *args)
    with pytest.raises(ValueError, match="iterations"):
        dtam_cuda.dtam_run(vol, g, d0, d0, q, 100.0, 1.0, *DTAM_ARGS, 1e-5, -1)
    with pytest.raises(ValueError, match="does not match"):
        wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, d0[:6].contiguous(), 20.0, 1.0)
    # zero iterations: the state comes back, nothing is launched or counted
    before = (dtam_cuda.launches, wta_cuda.sq_launches)
    d, a, qq, theta = dtam_cuda.dtam_run(vol, g, d0, d0, q, 100.0, 1.0, *DTAM_ARGS, 1e-5, 0)
    assert torch.equal(d, d0) and torch.equal(qq, q) and float(theta) == 100.0
    assert (dtam_cuda.launches, wta_cuda.sq_launches) == before


def test_dtam_solve_records_its_dispatch_and_kernel_spans(dev, tmp_path):
    """Under a profiler, ``dtam_run`` is a dispatch span holding the kernel
    span of its C entry, each with device milliseconds from its events."""
    vol, g, d0 = _dtam_inputs((32, 48, 64), dev)
    with profiling.trace(str(tmp_path)):
        dtam_cuda.dtam_solve(vol, g, d0, 20.0, 100.0, 0.7, 0.7, 0.002, 1e-5, iterations=10)
    spans = profiling.spans()
    (wrapper,) = [s for s in spans if s.layer == "dispatch"]
    (kernel,) = [s for s in spans if s.layer == "kernel"]
    assert (wrapper.name, kernel.name) == ("stereo.dtam_cuda.dtam_run", "kt_dtam_run")
    assert kernel.parent == wrapper.id and kernel.request == wrapper.request
    assert 0 < kernel.device_ms <= wrapper.device_ms
    assert 0 < kernel.self_ms and kernel.host_ms <= wrapper.host_ms


def test_kernel_spans_match_the_launch_counters(dev, tmp_path):
    """One kernel span per counted launch, each inside a dispatch span."""
    left, right, _ = synthetic.stereo_pair(96, 32, 16, seed=0, device="cpu")
    profiling.reset_counts()
    with profiling.trace(str(tmp_path)):
        stereo_sgm.sgm_pipeline(left.to(dev), right.to(dev), stereo_sgm.SgmConfig(max_disp=16))
    spans = profiling.spans()
    counted = profiling.counts()
    kernels = [s for s in spans if s.layer == "kernel"]
    wrappers = {s.id: s for s in spans if s.layer == "dispatch"}
    assert len(kernels) == sum(counted.values()) == 12
    assert sum(s.name == "kt_sgm_path" for s in kernels) == counted["sgm"] == 4
    assert all(s.parent in wrappers and s.device_ms is not None for s in kernels)


def test_wta_sq_backward_is_the_plain_gradient(dev):
    rng = np.random.default_rng(11)
    vol = torch.from_numpy(rng.random((8, 12, 40), dtype=np.float32)).to(dev)
    last = torch.from_numpy(rng.uniform(0, 8, (12, 40)).astype(np.float32)).to(dev)
    grads = []
    for fn in (dispatch.cost_vol_minimum_square_penalty_subpix,
               costvolume.cost_vol_minimum_square_penalty_subpix):
        xs = [vol.clone().requires_grad_(True), last.clone().requires_grad_(True)]
        fn(*xs, 2.0, 0.5).sum().backward()
        grads.append([x.grad for x in xs])
    for g_op, g_plain in zip(*grads):
        torch.testing.assert_close(g_op, g_plain, atol=1e-4, rtol=0)


def test_dtam_pipeline_on_card_matches_cpu(dev):
    left, right, _ = synthetic.stereo_pair(96, 32, 16, seed=0, device="cpu")
    cfg = stereo.StereoConfig(max_disp=16, census_window="9x7", dtam_iterations=10)
    mods = (dtam_cuda, wta_cuda, median_cuda, lr_cuda)
    counts = [m.launches for m in mods] + [wta_cuda.sq_launches]
    got = stereo.stereo_pipeline(left.to(dev), right.to(dev), cfg).cpu()
    assert [m.launches for m in mods] + [wta_cuda.sq_launches] == \
        [c + n for c, n in zip(counts, (1, 2, 1, 1, 10))]
    want = stereo.stereo_pipeline(left, right, cfg)
    agree = (torch.isnan(got) & torch.isnan(want)) | ((got - want).abs() <= 1e-3)
    assert agree.float().mean().item() >= 0.99
    # the incremental schedule launches the alternation every frame
    vs = stereo.VariationalStereo(cfg, its_per_frame=2)
    for frame in range(3):
        before = dtam_cuda.launches
        assert vs.process_frame(left.to(dev), right.to(dev)).shape == (32, 96)
        assert dtam_cuda.launches == before + 1, frame
    assert float(vs.state[4]) == 6.0


# --- the plane-sweep TSDF fuse (csrc/separable_fuse.cu) ----------------------

def _look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """T_wc of a camera at ``eye`` looking at ``target`` (x right, y down)."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    z = target - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, -up)
    x /= np.linalg.norm(x)
    return np.concatenate([np.stack([x, np.cross(z, x), z], 1), eye[:, None]], 1).astype(np.float32)


# cameras whose views pick the z, y and x sweeps
SWEEP_POSES = {0: (0.3, -0.2, -3.0), 1: (0.2, 3.0, 0.4), 2: (-3.0, 0.3, -0.2)}


def _fuse_case(dev, vol_shape, wh, axis, seed_frames=0):
    """A sphere scene's depth and normals from the pose of ``axis``, and a
    volume (empty, or holding ``seed_frames`` fused frames of other poses)."""
    from kangaroo_tpu_torch.apps import kinectfusion as kf
    from kangaroo_tpu_torch.containers import BoundingBox, Intrinsics, TsdfVolume
    from kangaroo_tpu_torch.core import se3
    from kangaroo_tpu_torch.fusion import raycast, separable

    W, H = wh
    K = Intrinsics.centered(0.86 * W, W, H)
    scene = synthetic.sphere_scene(res=96, device=dev)
    D, Hv, Wv = vol_shape
    vol = TsdfVolume.create(Wv, Hv, D, BoundingBox.create((-1.2,) * 3, (1.2,) * 3, device=dev),
                            trunc_dist=float("nan"))
    cfg = kf.KinectFusionConfig(w=W, h=H)

    def observe(a):
        T_wc = torch.from_numpy(_look_at(SWEEP_POSES[a])).to(dev)
        depth, _, _ = raycast.raycast_sdf(scene, T_wc, K, W, H, 0.5, 8.0)
        _, v, n = kf.preprocess_depth(torch.nan_to_num(depth, 0.0), K, cfg)
        return v[0][..., 2], n[0], se3.inverse(T_wc)

    trunc = 2.0 * float(np.linalg.norm(vol.voxel_size_units().cpu().numpy()))
    for a in [b for b in (0, 1, 2) if b != axis][:seed_frames]:
        d, n, T_cw = observe(a)
        vol = separable.sdf_fuse_separable(vol, d, n, T_cw, K, trunc, inplace=True)
    d, n, T_cw = observe(axis)
    assert separable._view_axis_index(T_cw) == axis
    return vol, d, n, T_cw, K, trunc


def _check_fused(got, want):
    gv, gw, wv, ww = (*got, *want)
    gu, wu = gw > 0, ww > 0
    assert int((gu != wu).sum()) <= 1e-5 * gw.numel()
    both = gu & wu
    assert int(both.sum()) > 1000
    torch.testing.assert_close(gv[both], wv[both], atol=1e-5, rtol=0)
    torch.testing.assert_close(gw[both], ww[both], atol=1e-4, rtol=0)
    neither = ~gu & ~wu
    assert torch.equal(gv[neither].nan_to_num(7.0), wv[neither].nan_to_num(7.0))


@pytest.mark.parametrize("seed_frames", [0, 2])
@pytest.mark.parametrize("near_far", [None, (0.5, 6.0), (2.2, 3.2)])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("vol_shape,wh", [((96, 80, 112), (160, 120)),
                                          ((200, 136, 248), (1242, 375))])
def test_separable_fuse_kernel_matches_plain(dev, vol_shape, wh, axis, near_far, seed_frames):
    from kangaroo_tpu_torch.fusion import separable, separable_cuda

    vol, d, n, T_cw, K, trunc = _fuse_case(dev, vol_shape, wh, axis, seed_frames)
    nf = near_far or (None, None)
    gmd, gct, params, window = separable.fuse_inputs(vol, d, n, T_cw, K, trunc, 1000.0, 0.1, axis,
                                                     clip_planes=near_far is not None,
                                                     near=nf[0], far=nf[1])
    got = (vol.val.clone(), vol.weight.clone())
    want = (vol.val.clone(), vol.weight.clone())
    before = separable_cuda.launches
    separable_cuda.fuse_planes(*got, gmd, gct, params, window, axis, *wh)
    assert separable_cuda.launches == before + 1
    separable.fuse_planes_plain(*want, gmd, gct, params, window, axis, *wh)
    _check_fused(got, want)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_separable_fuse_enable_false_is_a_passthrough(dev, axis):
    from kangaroo_tpu_torch.fusion import separable

    vol, d, n, T_cw, K, trunc = _fuse_case(dev, (96, 80, 112), (160, 120), axis, seed_frames=2)
    out = separable.sdf_fuse_separable(vol, d, n, T_cw, K, trunc, enable=torch.tensor(False,
                                                                                     device=dev))
    assert torch.equal(out.weight, vol.weight)
    assert torch.equal(out.val.nan_to_num(7.0), vol.val.nan_to_num(7.0))


def test_separable_fuse_checks_its_arguments(dev):
    from kangaroo_tpu_torch.fusion import separable, separable_cuda

    vol, d, n, T_cw, K, trunc = _fuse_case(dev, (32, 24, 40), (64, 48), 0)
    gmd, gct, params, window = separable.fuse_inputs(vol, d, n, T_cw, K, trunc)
    args = (gmd, gct, params, window, 0, 64, 48)
    with pytest.raises(RuntimeError, match="requires grad"):
        separable_cuda.fuse_planes(vol.val.clone().requires_grad_(True), vol.weight, *args)
    # the fuse differentiates through its autograd op, but not in place
    with pytest.raises(ValueError, match="inplace"):
        separable.sdf_fuse_separable(vol, d.clone().requires_grad_(True), n, T_cw, K, trunc,
                                     inplace=True)
    with pytest.raises(ValueError, match="contiguous"):
        separable_cuda.fuse_planes(vol.val.transpose(1, 2), vol.weight, *args)
    with pytest.raises(TypeError):
        separable_cuda.fuse_planes(vol.val, vol.weight, gmd, gct, params, window.long(), 0, 64, 48)
    with pytest.raises(ValueError, match="params"):
        separable_cuda.fuse_planes(vol.val, vol.weight, gmd, gct, params[:19].contiguous(),
                                   window, 0, 64, 48)
    with pytest.raises(ValueError, match="axis"):
        separable_cuda.fuse_planes(vol.val, vol.weight, gmd, gct, params, window, 3, 64, 48)


def test_kinectfusion_on_card_matches_cpu(dev):
    from kangaroo_tpu_torch.apps import kinectfusion as kf
    from kangaroo_tpu_torch.containers import Intrinsics
    from kangaroo_tpu_torch.fusion import separable_cuda

    W, H = 160, 120
    K = Intrinsics.centered(137.5, W, H)
    cfg = kf.KinectFusionConfig(w=W, h=H, vol_res=96, vol_extent=1.2, max_levels=3,
                                its=(1, 2, 2), near=0.5, far=6.0)
    frames = list(synthetic.depth_sequence(4, K, W, H, step=0.015, device="cpu",
                                           scene=synthetic.sphere_scene(96, device="cpu")))
    poses = {}
    for where in ("cpu", dev):
        pipe = kf.KinectFusion(K, cfg, device=where)
        pipe.T_wl = frames[0][0].to(where)
        before = separable_cuda.launches
        poses[str(where)] = [pipe.process_frame(torch.nan_to_num(d, 0.0).to(where)).cpu()
                             for _, d in frames]
        assert separable_cuda.launches == before + (4 if where == dev else 0)
        assert pipe.tracking_good
    for a, b in zip(poses["cpu"], poses[str(dev)]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=0)


# --- the segment kernels of the multi-device and batched SGM paths --------
# straight and diagonal segments against their plain versions at 1e-4 on
# the lattice (as the whole-image kernel); a stacked batch against its
# frames through the same kernel exactly


def _segment_inputs(shape, dev, dtype=torch.float32, seed=20):
    rng = np.random.default_rng(seed)
    D, S, N = shape
    vol = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev, dtype)
    img = torch.from_numpy(rng.random((S, N), dtype=np.float32)).to(dev)
    return vol, img


def _seg_lattice(D, N, sd, width, offset, dev):
    d = torch.arange(D, device=dev)[:, None, None]
    x = torch.arange(N, device=dev)[None, None, :] + offset
    return (d <= x) if sd < 0 else (x + d < width)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("shape,split,offset,width", [((64, 120, 160), 50, 160, 640),
                                                      ((128, 125, 414), 60, 828, 1242)])
def test_sgm_segment_kernel_matches_plain(dev, shape, split, offset, width, mode, reverse, dtype):
    """Two chained straight segments of a column block at its lattice
    offset, written in place into a wider accumulator through views."""
    D, S, N = shape
    vol, img = _segment_inputs((D, S, N + 7), dev, dtype)
    vol, img = vol[:, :, 3:N + 3], img[:, 3:N + 3]  # strided views of a wider array
    first, second = (slice(split, None), slice(None, split)) if reverse else \
        (slice(None, split), slice(split, None))
    outs = []
    for fn in (sgm_cuda.sgm_aggregate_block, sgm_plain.sgm_aggregate_block):
        acc = torch.ones((D, S, N + 5), device=dev)
        view = acc[:, :, 2:N + 2]
        a = fn(vol[:, first], img[first], 0.01, 0.02, mode, width=width, lane_offset=offset,
               acc=view[:, first], reverse=reverse)
        b = fn(vol[:, second], img[second], 0.01, 0.02, mode, width=width, seed=False,
               carry_prev=a[1], carry_best=a[2], last_img=a[3], lane_offset=offset,
               acc=view[:, second], reverse=reverse)
        outs.append((acc, b[1], b[2], b[3]))
    sd = -1 if mode == "left" else 1
    m = _seg_lattice(D, N, sd, width, offset, dev).expand(D, S, N)
    (acc, cp, cb, li), (acc_p, cp_p, cb_p, li_p) = outs
    torch.testing.assert_close(acc[:, :, 2:N + 2][m], acc_p[:, :, 2:N + 2][m], atol=1e-4, rtol=0)
    assert torch.equal(acc[:, :, :2], acc_p[:, :, :2]) and torch.equal(acc[:, :, N + 2:],
                                                                       acc_p[:, :, N + 2:])
    m0 = m[:, 0]
    torch.testing.assert_close(cp[m0], cp_p[m0], atol=1e-4, rtol=0)
    torch.testing.assert_close(cb, cb_p, atol=1e-4, rtol=0)
    assert torch.equal(li, li_p)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dx", [1, -1])
@pytest.mark.parametrize("shape,split,width", [((64, 120, 640), 40, 640),
                                               ((128, 125, 1250), 70, 1242)])
def test_sgm_diag_segment_kernel_matches_plain(dev, shape, split, width, dx, reverse):
    """Two chained diagonal segments from the seed carry, on a lane block
    that may be wider than the image (``width``)."""
    D, S, N = shape
    vol, img = _segment_inputs(shape, dev, seed=21)
    first, second = (slice(split, None), slice(None, split)) if reverse else \
        (slice(None, split), slice(split, None))
    outs = []
    for fn in (sgm_cuda.sgm_aggregate_diag_block, sgm_plain.sgm_aggregate_diag_block):
        z = torch.zeros(N, device=dev)
        acc = torch.ones(shape, device=dev)
        a = fn(vol[:, first], img[first], torch.full((D, N), 1e30, device=dev), z, z, z,
               0.01, 0.02, "left", dx=dx, width=width, acc=acc[:, first], reverse=reverse)
        b = fn(vol[:, second], img[second], a[1], a[2], a[4], a[3], 0.01, 0.02, "left", dx=dx,
               width=width, acc=acc[:, second], reverse=reverse)
        outs.append((acc, b[1], b[2], b[4]))
    m = _seg_lattice(D, N, -1, width, 0, dev).expand(shape).clone()
    m[:, :, width:] = False  # lanes past the image are padding
    torch.testing.assert_close(outs[0][0][m], outs[1][0][m], atol=1e-4, rtol=0)
    m0 = m[:, 0]
    torch.testing.assert_close(outs[0][1][m0], outs[1][1][m0], atol=1e-4, rtol=0)
    torch.testing.assert_close(outs[0][2][:width], outs[1][2][:width], atol=1e-4, rtol=0)
    assert torch.equal(outs[0][3], outs[1][3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sgm_seam_pass_equals_single_passes(dev, dtype):
    """A batch of 4 VGA/64 volumes stacked along the rows, one seam pass,
    equals the 4 single passes exactly, and the plain seam pass at 1e-4."""
    vol, img = _segment_inputs((64, 4 * 480, 640), dev, dtype, seed=22)
    before = (sgm_cuda.launches, sgm_cuda.segment_launches)
    got = sgm_cuda.semi_global_matching(vol, img, seam_period=480)
    assert (sgm_cuda.launches, sgm_cuda.segment_launches) == (before[0] + 2, before[1] + 2)
    for k in range(4):
        rows = slice(480 * k, 480 * (k + 1))
        assert torch.equal(got[:, rows], sgm_cuda.semi_global_matching(
            vol[:, rows].contiguous(), img[rows].contiguous()))
    m = _lattice(64, 640, -1, dev).expand(got.shape)
    torch.testing.assert_close(got[m], sgm_plain.semi_global_matching(
        vol, img, seam_period=480)[m], atol=1e-4, rtol=0)


def test_sgm_segment_scan_at_lane_offset(dev):
    """Column shards' vertical pairs at their offsets equal the whole
    image's vertical pair through the same kernel."""
    vol, img = _segment_inputs((64, 480, 640), dev, seed=23)
    whole = sgm_cuda.semi_global_matching(vol, img, do_horiz=False)
    for k in range(4):
        cols = slice(160 * k, 160 * (k + 1))
        got = sgm_cuda.sgm_aggregate_scan(vol[:, :, cols], img[:, cols], width=640,
                                          lane_offset=160 * k)
        assert torch.equal(got, whole[:, :, cols])


@pytest.mark.parametrize("do_diagonal", [False, True])
def test_mesh_pipeline_on_card_matches_cpu(dev, do_diagonal):
    """A virtual 4-shard mesh on the card: the new kernels launched, the
    frame in agreement with the CPU mesh frame and the card's single frame."""
    from kangaroo_tpu_torch.parallel.mesh import make_mesh

    left, right, _ = synthetic.stereo_pair(96, 32, 16, seed=0, device="cpu")
    cfg = stereo_sgm.SgmConfig(max_disp=16, do_diagonal=do_diagonal)
    before = (sgm_cuda.segment_launches, sgm_cuda.diag_segment_launches)
    got = stereo_sgm.sgm_pipeline(left.to(dev), right.to(dev), cfg,
                                  mesh=make_mesh(devices=[dev] * 4))
    assert got.device == dev
    assert sgm_cuda.segment_launches > before[0]
    assert (sgm_cuda.diag_segment_launches > before[1]) == do_diagonal
    for want in (stereo_sgm.sgm_pipeline(left, right, cfg,
                                         mesh=make_mesh(devices=["cpu"] * 4)),
                 stereo_sgm.sgm_pipeline(left.to(dev), right.to(dev), cfg).cpu()):
        got_c = got.cpu()
        agree = (torch.isnan(got_c) & torch.isnan(want)) | ((got_c - want).abs() <= 1e-3)
        assert agree.float().mean().item() >= 0.995


def test_batched_pipeline_on_card_equals_frames(dev):
    pairs = [synthetic.stereo_pair(96, 32, 16, seed=k, device=dev) for k in range(3)]
    lefts, rights = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    cfg = stereo_sgm.SgmConfig(max_disp=16)
    counts = (median_cuda.launches, lr_cuda.launches)
    got = stereo_sgm.sgm_pipeline_batched(lefts, rights, cfg)
    # one median launch a stack (left and right), one LR launch a batch
    assert (median_cuda.launches, lr_cuda.launches) == (counts[0] + 2, counts[1] + 1)
    for k in range(3):
        frame = stereo_sgm.sgm_pipeline(lefts[k], rights[k], cfg)
        assert bool(((torch.isnan(got[k]) & torch.isnan(frame)) | (got[k] == frame)).all())


def test_segment_wrappers_check_their_arguments(dev):
    vol, img = _segment_inputs((8, 12, 40), dev, seed=24)
    with pytest.raises(RuntimeError, match="requires grad"):
        sgm_cuda.sgm_aggregate_block(vol.clone().requires_grad_(True), img)
    with pytest.raises(ValueError, match="unit stride"):
        sgm_cuda.sgm_aggregate_block(vol.transpose(1, 2).contiguous().transpose(1, 2), img)
    with pytest.raises(ValueError, match="carry_prev"):
        sgm_cuda.sgm_aggregate_block(vol, img, seed=False, carry_best=torch.zeros(40, device=dev),
                                     last_img=torch.zeros(40, device=dev))
    with pytest.raises(ValueError, match="acc"):
        sgm_cuda.sgm_aggregate_block(vol, img, acc=torch.zeros(8, 12, 41, device=dev))
    with pytest.raises(ValueError, match="seam_period"):
        sgm_cuda.semi_global_matching(vol, img, seam_period=5)
    with pytest.raises(ValueError, match="width"):
        sgm_cuda.sgm_aggregate_scan(vol, img, scan_is_x=True, lane_offset=8)


# --- the whole-image path kernel against the warp-per-line design ----------
# one direction alone: csrc/sgm_path.cu (kt_sgm_path) against csrc/sgm.cu
# (kt_sgm_segment_lines, no lattice offset, seam or carry) exactly, and against
# the plain version at 1e-4 on the lattice; every DPT, odd sizes, the
# largest shared-memory ring (D = 256 float32) and an image narrower than
# a block's lines

PATH_SHAPES = [(1, 9, 5), (16, 16, 128), (64, 480, 640), (200, 37, 61), (256, 40, 72),
               (40, 23, 11)]
PATH_STEPS = [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, 1), (1, -1), (-1, -1)]


def _segment_direction(vol, img, step, sd, acc):
    """One direction through the warp-per-line design over the whole image."""
    out = acc.clone() if acc is not None else torch.empty(vol.shape, device=vol.device)
    sgm_cuda._launch_lines(vol, img, out, out if acc is not None else None, step, sd, 0,
                           vol.shape[2], 0, 0.01, 0.02, "sgm_segment")
    return out


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("step", PATH_STEPS)
@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_sgm_path_kernel_matches_segment_kernel_and_plain(dev, shape, step, sd, dtype,
                                                          accumulate):
    D, H, W = shape
    vol, img = _segment_inputs(shape, dev, dtype, seed=40)
    acc = (torch.from_numpy(np.random.default_rng(41).random(shape, dtype=np.float32)).to(dev)
           if accumulate else None)
    before = (sgm_cuda.launches, sgm_cuda.diagonal_launches)
    got = sgm_cuda.aggregate_direction(vol, img, step, 0.01, 0.02, sd,
                                       acc=None if acc is None else acc.clone())
    diagonal = bool(step[0] and step[1])
    assert (sgm_cuda.launches, sgm_cuda.diagonal_launches) == (before[0] + (not diagonal),
                                                               before[1] + diagonal)
    assert torch.equal(got, _segment_direction(vol, img, step, sd, acc))
    want = sgm_plain.aggregate_direction(vol, img, step, 0.01, 0.02, sd,
                                         acc=None if acc is None else acc.clone())
    m = _lattice(D, W, sd, dev).expand(shape)
    torch.testing.assert_close(got[m], want[m], atol=1e-4, rtol=0)


@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step", PATH_STEPS)
def test_sgm_path_kernel_on_row_shard_views(dev, step, dtype, offset):
    """A row and column block of a wider volume (rows 37..96, 641 columns
    from ``offset``: every element offset of a 16-byte vector of bf16, and
    of two of float32) read through its strides and added in place into a
    view of a wider accumulator (641 columns from 7 - ``offset``), as the
    warp-per-line design does; nothing outside the view changes."""
    vol, img = _segment_inputs((64, 121, 650), dev, dtype, seed=42)
    cols = slice(offset, offset + 641)
    v, i = vol[:, 37:97, cols], img[37:97, cols]
    acc = torch.from_numpy(np.random.default_rng(43).random((64, 70, 650),
                                                            dtype=np.float32)).to(dev)
    inside = (slice(None), slice(4, 64), slice(7 - offset, 648 - offset))
    got = acc.clone()
    view = got[inside]
    assert sgm_cuda.aggregate_direction(v, i, step, acc=view) is view
    want = acc.clone()
    sgm_cuda._launch_lines(v, i, want[inside], want[inside], step, -1, 0, 641, 0, 0.01, 0.02,
                           "sgm_segment")
    assert torch.equal(got, want)
    outside = torch.ones(acc.shape, dtype=torch.bool, device=dev)
    outside[inside] = False
    assert torch.equal(got[outside], acc[outside])


# the horizontal kernel (sgm_cols_kernel) alone: every DPT and both sides of
# each of its edges, rows shorter than a vector, KITTI-wide rows, and from
# one row to a stack of 8 KITTI frames (a single frame's d-planes lie at
# different 16-byte phases); against the warp-per-line design and the plain
# version, exactly
HORIZONTAL_SHAPES = ([(D, 3, N) for D in (1, 31, 32, 33, 64, 127, 128, 129, 256)
                      for N in (1, 7, 8, 9, 17, 1242)]
                     + [(128, S, 1242) for S in (1, 375, 3000)])


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("step", [(1, 0), (-1, 0)])
@pytest.mark.parametrize("shape", HORIZONTAL_SHAPES)
def test_sgm_horizontal_kernel_matches_lines_design_and_plain(dev, shape, step, sd, dtype,
                                                              accumulate):
    vol, img = _segment_inputs(shape, dev, dtype, seed=46)
    acc = (torch.rand(shape, generator=torch.Generator(dev).manual_seed(47), device=dev)
           if accumulate else None)
    before = (sgm_cuda.horizontal_launches, sgm_cuda.launches)
    got = sgm_cuda.aggregate_direction(vol, img, step, 0.01, 0.02, sd,
                                       acc=None if acc is None else acc.clone())
    assert (sgm_cuda.horizontal_launches, sgm_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, _segment_direction(vol, img, step, sd, acc))
    want = sgm_plain.aggregate_direction(vol, img, step, 0.01, 0.02, sd,
                                         acc=None if acc is None else acc.clone())
    assert torch.equal(got, want)


def test_batched_kitti_pipeline_launches_two_horizontal_kernels(dev):
    """A stack of 8 KITTI pairs at 128 disparities (the benchmark cell's
    batch): its aggregation is 4 launches, 2 of them the horizontal kernel."""
    pairs = [synthetic.stereo_pair(1242, 375, 128, seed=k, device=dev) for k in range(8)]
    lefts, rights = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    before = (sgm_cuda.horizontal_launches, sgm_cuda.launches + sgm_cuda.segment_launches)
    stereo_sgm.sgm_pipeline_batched(lefts, rights, stereo_sgm.SgmConfig(max_disp=128))
    assert (sgm_cuda.horizontal_launches,
            sgm_cuda.launches + sgm_cuda.segment_launches) == (before[0] + 2, before[1] + 4)


@pytest.mark.parametrize("step", PATH_STEPS)
def test_sgm_path_kernel_bf16_storage_edges(dev, step):
    """A bf16 volume of an odd number of elements as the tail of its storage
    (it starts half a word in and ends at the storage's last element), and
    as the head of a storage with NaN just after it: the half-words that a
    run's covering words hold beyond the run never reach the output."""
    shape = (3, 5, 7)
    vol, img = _segment_inputs(shape, dev, torch.bfloat16, seed=45)
    n = vol.numel()
    tail = torch.full((n + 1,), float("nan"), dtype=torch.bfloat16, device=dev)
    tail[1:] = vol.reshape(-1)
    head = torch.full((n + 1,), float("nan"), dtype=torch.bfloat16, device=dev)
    head[:n] = vol.reshape(-1)
    want = _segment_direction(vol, img, step, -1, None)
    for v in (tail[1:].view(shape), head[:n].view(shape)):
        assert torch.equal(sgm_cuda.aggregate_direction(v, img, step), want)


def test_sgm_scan_routes_whole_lines_to_the_path_kernel(dev):
    """Whole rows or columns (no lane offset, seam or width) run the path
    kernel; a lane offset runs the segment kernel; both give the same."""
    vol, img = _segment_inputs((16, 24, 40), dev, torch.bfloat16, seed=44)
    before = (sgm_cuda.launches, sgm_cuda.segment_launches)
    rows = sgm_cuda.sgm_aggregate_scan(vol, img, scan_is_x=True)
    cols = sgm_cuda.sgm_aggregate_scan(vol, img)
    assert (sgm_cuda.launches, sgm_cuda.segment_launches) == (before[0] + 4, before[1])
    offset = sgm_cuda.sgm_aggregate_scan(vol, img, lane_offset=0)
    assert (sgm_cuda.launches, sgm_cuda.segment_launches) == (before[0] + 4, before[1] + 2)
    assert torch.equal(rows, sgm_cuda.semi_global_matching(vol, img, do_vert=False))
    assert torch.equal(cols, offset)
    assert torch.equal(cols, sgm_cuda.semi_global_matching(vol, img, do_horiz=False))


# --- the segment kernel against the warp-per-line design -------------------
# kt_sgm_segment (csrc/sgm_path.cu, kernels 6 and 7) against
# kt_sgm_segment_lines (csrc/sgm.cu) through the same wrappers on the same
# inputs, exactly: the same operations per element in the same order. The
# volumes are bf16 or float32 views of wider arrays whose columns start at
# an odd element and whose rows are an odd number of elements apart, so a
# bf16 run starts half a word in on every other row.


def _both_designs(fn):
    """fn()'s tensors through kt_sgm_segment, and again with the segment
    wrappers launching kt_sgm_segment_lines."""
    got = fn()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sgm_cuda, "_launch", sgm_cuda._launch_lines)
        want = fn()
    return got, want


def _odd_view(shape, dev, dtype, seed):
    """vol (D, S, N) and img (S, N) as views at column 1 of arrays 3 wider."""
    D, S, N = shape
    vol, img = _segment_inputs((D, S, N + 3), dev, dtype, seed)
    return vol[:, :, 1:N + 1], img[:, 1:N + 1]


def _assert_designs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (D, H, W), row segments, column blocks: VGA/64 4 ways; KITTI/128 3 ways
# in blocks of 416 columns (the last 410 wide) and 125 rows; D = 256
# float32 (the deepest ring), the last block 32 of 72 columns
SPLITS = [((64, 480, 640), 4, 160), ((128, 375, 1242), 3, 416), ((256, 40, 72), 2, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape,n,block", SPLITS)
def test_sgm_segment_chain_matches_lines_design(dev, shape, n, block, sd, reverse, dtype):
    """The last column block at its lattice offset, its rows in n segments
    chained down or up through their carries into a view of a wider
    accumulator: the accumulator (outside the view untouched) and every
    carry equal the warp-per-line design's."""
    D, H, W = shape
    vol, img = _odd_view(shape, dev, dtype, seed=50)
    c0, Hs = (n - 1) * block, H // n
    cols = slice(c0, W)
    acc0 = torch.from_numpy(np.random.default_rng(51).random((D, H, W + 5),
                                                             dtype=np.float32)).to(dev)
    mode = "left" if sd < 0 else "right"

    def chain():
        acc = acc0.clone()
        view = acc[:, :, 2:W + 2][:, :, cols]
        carry, outs = (None, None, None), []
        for k in (range(n - 1, -1, -1) if reverse else range(n)):
            rows = slice(k * Hs, H if k == n - 1 else (k + 1) * Hs)
            _, *carry = sgm_cuda.sgm_aggregate_block(
                vol[:, rows, cols], img[rows, cols], 0.01, 0.02, mode, width=W,
                seed=carry[0] is None, carry_prev=carry[0], carry_best=carry[1],
                last_img=carry[2], lane_offset=c0, acc=view[:, rows], reverse=reverse)
            outs += carry[:2]
        return [acc, *outs]

    before = sgm_cuda.segment_launches
    got, want = _both_designs(chain)
    assert sgm_cuda.segment_launches == before + 2 * n
    _assert_designs_equal(got, want)
    assert torch.equal(got[0][:, :, :2 + c0], acc0[:, :, :2 + c0])
    assert torch.equal(got[0][:, :, W + 2:], acc0[:, :, W + 2:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape,n,block", SPLITS)
def test_sgm_segment_column_pairs_match_lines_design(dev, shape, n, block, sd, dtype):
    """Every column block's vertical pair at its lattice offset (the
    reshard's scans), added onto an accumulator."""
    D, H, W = shape
    vol, img = _odd_view(shape, dev, dtype, seed=52)
    acc0 = torch.from_numpy(np.random.default_rng(53).random(shape, dtype=np.float32)).to(dev)

    def pairs():
        acc = acc0.clone()
        for k in range(n):
            cols = slice(k * block, min(W, (k + 1) * block))
            sgm_cuda.sgm_aggregate_scan(vol[:, :, cols], img[:, cols], 0.01, 0.02, True,
                                        "left" if sd < 0 else "right", width=W,
                                        acc=acc[:, :, cols], lane_offset=k * block)
        return [acc]

    _assert_designs_equal(*_both_designs(pairs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("has", ["zero", "one", "mixed"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dx", [1, -1])
@pytest.mark.parametrize("shape,width,mode", [((64, 120, 640), 640, "left"),
                                              ((128, 125, 1250), 1242, "right")])
def test_sgm_diag_segment_matches_lines_design(dev, shape, width, mode, dx, reverse, has, dtype):
    """A diagonal segment from a carry whose has-path mask is all zero (a
    seed), all one, or mixed, on a lane block that may be wider than the
    image, added onto an accumulator: Lr and the carry out."""
    D, S, N = shape
    vol, img = _odd_view(shape, dev, dtype, seed=54)
    rng = np.random.default_rng(55)
    carry = [torch.from_numpy(a).to(dev) for a in
             (rng.random((D, N), dtype=np.float32), rng.random(N, dtype=np.float32),
              rng.random(N, dtype=np.float32))]
    mask = {"zero": np.zeros(N), "one": np.ones(N), "mixed": rng.random(N) < 0.5}[has]
    carry_has = torch.from_numpy(mask.astype(np.float32)).to(dev)
    acc0 = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)

    def segment():
        acc = acc0.clone()
        out = sgm_cuda.sgm_aggregate_diag_block(vol, img, carry[0], carry[1], carry_has,
                                                carry[2], 0.01, 0.02, mode, dx=dx,
                                                width=width, acc=acc, reverse=reverse)
        return [acc, out[1], out[2]]

    before = sgm_cuda.diag_segment_launches
    got, want = _both_designs(segment)
    assert sgm_cuda.diag_segment_launches == before + 2
    _assert_designs_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 480, 640), (128, 375, 1242)])
def test_sgm_seam_pass_matches_lines_design(dev, shape, dtype):
    """The seam pass of 4 stacked frames: VGA/64, and KITTI/128, whose 375
    rows are no multiple of the rows a stage holds."""
    D, H, W = shape
    vol, img = _segment_inputs((D, 4 * H, W), dev, dtype, seed=56)
    got, want = _both_designs(lambda: [sgm_cuda.semi_global_matching(vol, img,
                                                                     seam_period=H)])
    _assert_designs_equal(got, want)


@pytest.mark.parametrize("step", [(1, 0), (-1, 0), (0, 0), (0, 2)])
def test_sgm_segment_refuses_other_steps(dev, step):
    """The segment kernel takes vertical and diagonal steps: a horizontal
    one is whole rows (kt_sgm_path)."""
    vol, img = _segment_inputs((8, 12, 40), dev, seed=57)
    out = torch.empty(vol.shape, device=dev)
    with pytest.raises(RuntimeError, match="cudaError"):
        sgm_cuda._launch(vol, img, out, None, step, -1, 0, 40, 0, 0.01, 0.02, "sgm_segment")


# --- the DTAM search and alternation against the designs they replaced -----
# kt_wta_sq (16-byte spans of pixels a thread) against kt_wta_sq_pixel (one
# thread per pixel), and kt_dtam_run (the primal step fused into the search)
# against kt_dtam_run_split (three launches an iteration): the same
# operations per pixel in the same order, so exactly equal.


def _sq_volume(shape, dev, dtype, seed, offset=0):
    """Costs k/256 (exact in bfloat16, with ties) as a contiguous (D, H, W)
    view ``offset`` elements into its storage."""
    D, H, W = shape
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy((rng.integers(0, 257, offset + D * H * W) / 256.0)
                            .astype(np.float32)).to(dev, dtype)
    return flat[offset:].view(D, H, W)


def _sq_last(shape, dev, seed, offset=0):
    D, H, W = shape
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.uniform(-2, D + 2, offset + H * W).astype(np.float32)).to(dev)
    return flat[offset:].view(H, W)


def _assert_sq_designs_equal(vol, last, sd, thetas=(100.0, 1.0, 1e-3)):
    for theta in thetas:
        got = wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, last, 20.0, theta, sd)
        want = wta_cuda._square_penalty_pixel(vol, last, 20.0, theta, sd)
        assert torch.equal(got, want), theta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", SHAPES + FRAME_SHAPES)
def test_wta_sq_matches_pixel_design(dev, shape, sd, dtype):
    _assert_sq_designs_equal(_sq_volume(shape, dev, dtype, 60), _sq_last(shape, dev, 61), sd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", [(16, 16, 128), (64, 480, 640), (128, 375, 1242)])
def test_wta_sq_odd_offset_views_match_pixel_design(dev, shape, sd, dtype):
    """Volume and last_disp as views at odd element offsets: every plane
    off its 16-byte alignment, the element-load path."""
    vol = _sq_volume(shape, dev, dtype, 62, offset=1)
    last = _sq_last(shape, dev, 63, offset=3)
    _assert_sq_designs_equal(vol, last, sd)
    # the same values aligned take the 16-byte path where H*W allows it
    _assert_sq_designs_equal(vol.clone(), last.clone(), sd)
    torch.testing.assert_close(
        wta_cuda.cost_vol_minimum_square_penalty_subpix(vol, last, 20.0, 1.0, sd),
        wta_cuda.cost_vol_minimum_square_penalty_subpix(vol.clone(), last.clone(), 20.0, 1.0,
                                                        sd), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
def test_wta_sq_nan_costs_match_pixel_design(dev, sd, dtype):
    shape = (64, 48, 80)
    rng = np.random.default_rng(64)
    vol = _sq_volume(shape, dev, torch.float32, 64)
    vol[torch.from_numpy(rng.random(shape) < 0.03).to(dev)] = float("nan")
    vol[torch.from_numpy(rng.random(shape) < 0.01).to(dev)] = float("inf")
    _assert_sq_designs_equal(vol.to(dtype), _sq_last(shape, dev, 65), sd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", [(64, 48, 80), (128, 37, 1242)])
def test_wta_sq_short_prefix_tail_matches_pixel_design(dev, shape, sd, dtype):
    """Pixels whose valid prefix is short (x < D at sd = -1, x >= W - D at
    sd = +1) with a last so large that every valid cost exceeds 1e10 (or
    is infinite): the 1e10 tail wins there."""
    D, H, W = shape
    last = _sq_last(shape, dev, 66)
    x = torch.arange(W, device=dev)
    edge = (x < D) if sd < 0 else (x >= W - D)
    rows = torch.arange(H, device=dev)[:, None] % 3
    big = torch.where(rows == 0, 1e20, torch.where(rows == 1, 1e6, -3e5))
    last = torch.where(edge[None, :], big, last)
    _assert_sq_designs_equal(_sq_volume(shape, dev, dtype, 67), last.contiguous(), sd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", [(1, 37, 61), (1, 48, 64), (256, 40, 72), (256, 9, 13)])
def test_wta_sq_extreme_depths_match_pixel_design(dev, shape, sd, dtype):
    _assert_sq_designs_equal(_sq_volume(shape, dev, dtype, 68), _sq_last(shape, dev, 69), sd)


def _dtam_both(vol, g, d0, sd, iterations=50, q0=None, theta=100.0, n0=1.0, beta=1e-5):
    q0 = torch.zeros(d0.shape + (2,), device=d0.device) if q0 is None else q0
    args = (vol, g, d0, d0, q0, theta, n0, *DTAM_ARGS, beta, iterations, sd)
    return dtam_cuda.dtam_run(*args), dtam_cuda._dtam_run_split(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", SHAPES + FRAME_SHAPES)
def test_dtam_solve_matches_split_design(dev, shape, sd, dtype):
    vol, g, d0 = _dtam_inputs(shape, dev)
    got, want = _dtam_both(vol.to(dtype), g, d0, sd)
    for name, a, b in zip("d a q theta".split(), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", [(64, 480, 640), (128, 375, 1242)])
def test_dtam_odd_offset_views_match_split_design(dev, shape, sd):
    """The volume and g as views at odd element offsets: the element-load
    path of the fused step."""
    D, H, W = shape
    vol, g, d0 = _dtam_inputs(shape, dev, seed=12)
    vbuf = torch.empty(D * H * W + 1, dtype=vol.dtype, device=dev)
    vbuf[1:] = vol.flatten()
    gbuf = torch.empty(H * W + 1, device=dev)
    gbuf[1:] = g.flatten()
    got, want = _dtam_both(vbuf[1:].view(D, H, W), gbuf[1:].view(H, W), d0, sd, iterations=10)
    for name, a, b in zip("d a q theta".split(), got, want):
        assert torch.equal(a, b), name
    aligned = _dtam_both(vol, g, d0, sd, iterations=10)[0]
    for name, a, b in zip("d a q theta".split(), got, aligned):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("theta", [100.0, 1.0, 1e-3])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", FRAME_SHAPES)
def test_dtam_steps_match_split_design(dev, shape, sd, theta):
    """3 + 3 steps through the fused design against 6 through the split
    one, from a running state (q non-zero), at three thetas."""
    vol, g, d0 = _dtam_inputs(shape, dev, seed=13)
    q = torch.from_numpy(np.random.default_rng(14).uniform(-0.5, 0.5, d0.shape + (2,))
                         .astype(np.float32)).to(dev)
    state = (d0, d0, q, theta, 7.0)
    s1 = dtam_cuda.dtam_step(vol, g, *state, *DTAM_ARGS, 1e-3, iterations=3, sd=sd)
    s2 = dtam_cuda.dtam_step(vol, g, *s1, *DTAM_ARGS, 1e-3, iterations=3, sd=sd)
    six = dtam_cuda._dtam_run_split(vol, g, d0, d0, q, theta, 7.0, *DTAM_ARGS, 1e-3, 6, sd)
    for name, a, b in zip("d a q theta".split(), s2, six):
        assert torch.equal(a, b), name


# --- the ROF solve and the fuse against the designs they replaced ----------
# kt_rof_denoise (solvers_cuda.ROF_STEPS iterations a launch on tiles in
# shared memory) against kt_rof_denoise_steps (a dual and a primal launch an
# iteration), and kt_separable_fuse (plane tiles with shared-memory tables)
# against kt_separable_fuse_voxel (one thread a voxel): the same operations
# per element in the same order, so exactly equal, NaN positions included.

# (H, W): one pixel, a row, a column, smaller than a tile, one 32x16 tile
# plus a pixel each way, VGA, KITTI-sized and KITTI-sized standing up
ROF_SHAPES = [(1, 1), (1, 37), (37, 1), (9, 20), (17, 33)] + IMAGE_SHAPES
ROF_ITERS = [0, 1, solvers_cuda.ROF_STEPS - 1, solvers_cuda.ROF_STEPS,
             solvers_cuda.ROF_STEPS + 1, 100]


def _equal(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(7.0),
                                                            b.nan_to_num(7.0))


def _rof_both(g, mode, iterations, keep):
    weight = keep if mode == "lambda_weight" else None
    model = "tv" if mode == "tv" else "huber"
    args = dict(iterations=iterations, model=model, lam_weight=weight)
    return (solvers_cuda.rof_denoise(g, 8.0, **args),
            solvers_cuda._rof_denoise_steps(g, 8.0, **args),
            rof.denoise_plain(g, 8.0, **args))


@pytest.mark.parametrize("iterations", ROF_ITERS)
@pytest.mark.parametrize("mode", ["tv", "huber", "lambda_weight"])
@pytest.mark.parametrize("shape", ROF_SHAPES)
def test_rof_matches_steps_design(dev, shape, mode, iterations):
    g, keep = _noisy_image(shape, dev)
    before = solvers_cuda.rof_launches
    new, old, plain = _rof_both(g, mode, iterations, keep)
    assert solvers_cuda.rof_launches == before + int(iterations > 0)
    assert torch.equal(new, old)
    torch.testing.assert_close(new, plain, atol=1e-4, rtol=0)
    if iterations == 0:
        assert torch.equal(new, g)


@pytest.mark.parametrize("mode", ["tv", "huber", "lambda_weight"])
@pytest.mark.parametrize("shape", [(17, 33), (480, 640), (375, 1242)])
def test_rof_non_finite_inputs_match_steps_design(dev, shape, mode):
    """NaN and infinity in g (and a NaN weight) spread the same way through
    both designs; the plain version agrees where finite, NaN where NaN."""
    g, keep = _noisy_image(shape, dev)
    rng = np.random.default_rng(30)
    flat = g.view(-1)
    flat[torch.from_numpy(rng.integers(0, g.numel(), 5)).to(dev)] = float("nan")
    flat[torch.from_numpy(rng.integers(0, g.numel(), 3)).to(dev)] = float("inf")
    flat[torch.from_numpy(rng.integers(0, g.numel(), 2)).to(dev)] = float("-inf")
    keep.view(-1)[7] = float("nan")
    for iterations in (3, solvers_cuda.ROF_STEPS + 5):
        new, old, plain = _rof_both(g, mode, iterations, keep)
        assert _equal(new, old), iterations
        torch.testing.assert_close(new, plain, atol=1e-4, rtol=0, equal_nan=True)


@pytest.mark.parametrize("shape", [(17, 33)] + IMAGE_SHAPES)
def test_inpaint_runs_the_tile_design(dev, shape):
    """``deconvolution.inpaint`` goes through ``rof_denoise(lam_weight=)``:
    one counted solve, equal to the replaced design with the mask as the
    weight."""
    g, keep = _noisy_image(shape, dev)
    before = solvers_cuda.rof_launches
    got = deconvolution.inpaint(g, keep, iterations=37)
    assert solvers_cuda.rof_launches == before + 1
    want = solvers_cuda._rof_denoise_steps(g, 10.0, iterations=37, model="huber",
                                           lam_weight=keep)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, rof.denoise_plain(g, 10.0, iterations=37, lam_weight=keep),
                               atol=1e-4, rtol=0)


def test_rof_steps_design_counts_nothing(dev):
    g, _ = _noisy_image((17, 33), dev)
    before = solvers_cuda.rof_launches
    solvers_cuda._rof_denoise_steps(g, 8.0, iterations=5)
    assert solvers_cuda.rof_launches == before


# kt_tgv_denoise (solvers_cuda.TGV_STEPS iterations a launch on tiles in
# shared memory) against kt_tgv_denoise_steps (an ascent and a descent launch
# an iteration): the same operations per element in the same order.
TGV_ITERS = [0, 1, solvers_cuda.TGV_STEPS - 1, solvers_cuda.TGV_STEPS,
             solvers_cuda.TGV_STEPS + 1, 9, 37, 100]


@pytest.mark.parametrize("iterations", TGV_ITERS)
@pytest.mark.parametrize("shape", ROF_SHAPES)
def test_tgv_matches_steps_design(dev, shape, iterations):
    f, _ = _noisy_image(shape, dev)
    before = solvers_cuda.tgv_launches
    new = solvers_cuda.tgv_denoise(f, iterations=iterations)
    assert solvers_cuda.tgv_launches == before + int(iterations > 0)
    assert torch.equal(new, solvers_cuda._tgv_denoise_steps(f, iterations=iterations))
    if iterations == 0:
        assert torch.equal(new, f)
    if iterations == 100:
        torch.testing.assert_close(new, tgv.denoise_plain(f, iterations=100), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("shape", [(3, 5), (17, 33), (480, 640), (375, 1242)])
def test_tgv_non_finite_inputs_match_steps_design(dev, shape):
    """NaN and infinity in f spread the same way through both designs; the
    plain version agrees where finite, NaN where NaN."""
    f, _ = _noisy_image(shape, dev)
    rng = np.random.default_rng(31)
    flat = f.view(-1)
    flat[torch.from_numpy(rng.integers(0, f.numel(), 5)).to(dev)] = float("nan")
    flat[torch.from_numpy(rng.integers(0, f.numel(), 3)).to(dev)] = float("inf")
    flat[torch.from_numpy(rng.integers(0, f.numel(), 2)).to(dev)] = float("-inf")
    for iterations in (3, 9, 37):
        new = solvers_cuda.tgv_denoise(f, iterations=iterations)
        assert _equal(new, solvers_cuda._tgv_denoise_steps(f, iterations=iterations)), iterations
        torch.testing.assert_close(new, tgv.denoise_plain(f, iterations=iterations), atol=1e-4,
                                   rtol=0, equal_nan=True)


def test_tgv_steps_design_counts_nothing(dev):
    f, _ = _noisy_image((17, 33), dev)
    before = solvers_cuda.tgv_launches
    solvers_cuda._tgv_denoise_steps(f, iterations=5)
    assert solvers_cuda.tgv_launches == before


def _over_max_weight(vol):
    """Every 97th fused voxel's weight above max_w (1000): the limit applies."""
    fused = (vol.weight.view(-1) > 0).nonzero()[::97, 0]
    vol.weight.view(-1)[fused] = 2000.0


def _fuse_both(vol, gmd, gct, params, window, axis, wh):
    """The fuse through both designs and the plain version, each on its own
    copy of the volume."""
    from kangaroo_tpu_torch.fusion import separable, separable_cuda

    new, old, plain = ((vol.val.clone(), vol.weight.clone()) for _ in range(3))
    before = separable_cuda.launches
    separable_cuda.fuse_planes(*new, gmd, gct, params, window, axis, *wh)
    separable_cuda._fuse_planes_voxel(*old, gmd, gct, params, window, axis, *wh)
    assert separable_cuda.launches == before + 1
    separable.fuse_planes_plain(*plain, gmd, gct, params, window, axis, *wh)
    return new, old, plain


@pytest.mark.parametrize("seed_frames", [0, 2])
@pytest.mark.parametrize("near_far", [None, (0.5, 6.0), (2.2, 3.2)])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("vol_shape,wh", [((256, 256, 256), (640, 480)),
                                          ((200, 136, 248), (1242, 375)),
                                          ((40, 36, 20), (160, 120))])
def test_separable_fuse_matches_voxel_design(dev, vol_shape, wh, axis, near_far, seed_frames):
    """Every sweep axis on an empty and a fused volume, the full, near/far
    and a tight window; (40, 36, 20) has fewer x planes than a block's 32."""
    from kangaroo_tpu_torch.fusion import separable

    vol, d, n, T_cw, K, trunc = _fuse_case(dev, vol_shape, wh, axis, seed_frames)
    if seed_frames:
        _over_max_weight(vol)
    nf = near_far or (None, None)
    gmd, gct, params, window = separable.fuse_inputs(vol, d, n, T_cw, K, trunc, 1000.0, 0.1, axis,
                                                     clip_planes=near_far is not None,
                                                     near=nf[0], far=nf[1])
    new, old, plain = _fuse_both(vol, gmd, gct, params, window, axis, wh)
    assert _equal(new[0], old[0]) and torch.equal(new[1], old[1])
    if vol_shape[0] > 40:
        _check_fused(new, plain)


@pytest.mark.parametrize("enable", [True, False])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_separable_fuse_empty_window_and_enable_match_voxel_design(dev, axis, enable):
    """An empty window touches nothing; enable=False limits the weight and
    passes val through; both as the voxel design does."""
    from kangaroo_tpu_torch.fusion import separable

    vol, d, n, T_cw, K, trunc = _fuse_case(dev, (96, 80, 112), (160, 120), axis, seed_frames=2)
    _over_max_weight(vol)
    gmd, gct, params, window = separable.fuse_inputs(vol, d, n, T_cw, K, trunc, 1000.0, 0.1, axis,
                                                     enable=enable, near=0.5, far=6.0)
    empty = torch.tensor([5, 5], dtype=torch.int32, device=dev)
    for win in (window, empty):
        new, old, _ = _fuse_both(vol, gmd, gct, params, win, axis, (160, 120))
        assert _equal(new[0], old[0]) and torch.equal(new[1], old[1])
        if not enable or win is empty:
            assert _equal(new[0], vol.val)
        if win is empty:
            assert torch.equal(new[1], vol.weight)


# --- the median on tiles and the LR check on rows (csrc/median.cu,
# csrc/lr_check.cu) against the designs they replaced and the plain versions

# images narrower than a 64x4 tile or smaller than a 7x7 window, and larger ones
MEDIAN_SHAPES = [(1, 1), (1, 19), (19, 1), (3, 5), (5, 3), (17, 33), (37, 61), (480, 640),
                 (375, 1242), (1242, 375)]


def _median_input(shape, seed, dev):
    """NaN, +inf and -inf at 10 %, a bad row and a bad column, +0 and -0."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 16, shape).astype(np.float32)
    for v in (np.nan, np.inf, -np.inf):
        img[rng.random(shape) < 0.1 / 3] = v
    img[rng.random(shape) < 0.1] = 0.0
    img[rng.random(shape) < 0.1] = -0.0
    img[..., shape[-2] // 2, :] = np.nan
    img[..., :, shape[-1] // 3] = np.inf
    return torch.from_numpy(img).to(dev)


def _same(got, want):
    """Exact, +0 equal to -0, NaN positions equal."""
    return bool(((torch.isnan(got) & torch.isnan(want)) | (got == want)).all())


@pytest.mark.parametrize("shape", MEDIAN_SHAPES)
@pytest.mark.parametrize("rad", [1, 2, 3])
def test_median_matches_pixel_design(dev, rad, shape):
    img = _median_input(shape, rad, dev)
    K = (2 * rad + 1) ** 2
    for max_bad in (0, 1, 12, K, K + 5):
        got = median_cuda.median_filter_reject_invalid(img, max_bad, rad)
        assert _same(got, median_cuda._median_pixel(img, max_bad, rad)), max_bad
        assert _same(got, median_plain.median_filter_reject_invalid(img, max_bad, rad)), max_bad


@pytest.mark.parametrize("shape", [(4, 480, 640), (3, 5, 3), (2, 17, 33)])
@pytest.mark.parametrize("rad", [1, 2, 3])
def test_median_stack_equals_single_launches(dev, rad, shape):
    stack = _median_input(shape, 10 + rad, dev)
    before = median_cuda.launches
    got = median_cuda.median_filter_reject_invalid(stack, 12, rad)
    assert median_cuda.launches == before + 1
    assert _same(got, median_plain.median_filter_reject_invalid(stack, 12, rad))
    for n in range(shape[0]):
        assert _same(got[n], median_cuda._median_pixel(stack[n].contiguous(), 12, rad))


def test_median_pixel_design_counts_nothing(dev):
    before = median_cuda.launches
    median_cuda._median_pixel(torch.zeros(8, 8, device=dev), 12, 2)
    assert median_cuda.launches == before


LR_SHAPES = [(37, 61), (480, 640), (375, 1242), (5, 1), (1, 1), (3, 4097)]


def _lr_inputs(shape, D, seed, dev, offset=0):
    """Disparities spilling past [0, D) both ways with NaN, a right image in
    agreement with the left within ~1 px; ``offset`` elements into their
    storage (loads narrower than 16 bytes)."""
    rng = np.random.default_rng(seed)
    dl = rng.uniform(-3, D + 3, shape).astype(np.float32)
    dr = (dl + rng.normal(0, 0.8, shape)).astype(np.float32)
    dl[rng.random(shape) < 0.1] = np.nan
    dr[rng.random(shape) < 0.1] = np.nan
    out = []
    for a in (dl, dr):
        buf = torch.empty(a.size + offset, device=dev)
        buf[offset:] = torch.from_numpy(a.ravel()).to(dev)
        out.append(buf[offset:].view(shape))
    return out


@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("shape", LR_SHAPES)
def test_lr_pair_matches_two_pixel_launches(dev, shape, offset):
    D = 64
    dl, dr = _lr_inputs(shape, D, 30, dev, offset)
    before = lr_cuda.launches
    got_l, got_r = lr_cuda.left_right_check_pair(dl, dr, 1.0, max_disp=D)
    assert lr_cuda.launches == before + 1
    want_r = lr_cuda._check_pixel(dr, dl, 1, 1.0, D)
    assert _same(got_r, want_r)
    assert _same(got_l, lr_cuda._check_pixel(dl, want_r, -1, 1.0, D))
    plain_l, plain_r = costvolume.left_right_check_pair(dl, dr, 1.0, D)
    assert _same(got_l, plain_l) and _same(got_r, plain_r)


@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("shape", LR_SHAPES)
def test_lr_one_way_matches_pixel_design(dev, shape, sd):
    dl, dr = _lr_inputs(shape, 64, 31, dev, offset=1 if shape[1] % 2 else 0)
    got = lr_cuda.left_right_check(dl, dr, sd, 1.0, max_disp=64)
    assert _same(got, lr_cuda._check_pixel(dl, dr, sd, 1.0, 64))
    assert _same(got, costvolume.left_right_check(dl, dr, sd, 1.0, 64))


@pytest.mark.parametrize("W", [6200, lr_cuda.MAX_WIDTH])
def test_lr_rows_past_the_default_shared_memory(dev, W):
    """Rows wider than 48 KB of shared memory a pair take the opted-in 227 KB."""
    dl, dr = _lr_inputs((3, W), 256, 32, dev)
    got_l, got_r = lr_cuda.left_right_check_pair(dl, dr, 1.0, max_disp=256)
    plain_l, plain_r = costvolume.left_right_check_pair(dl, dr, 1.0, 256)
    assert _same(got_l, plain_l) and _same(got_r, plain_r)
    with pytest.raises(ValueError, match="shared memory"):
        lr_cuda.left_right_check_pair(*(torch.zeros(2, lr_cuda.MAX_WIDTH + 1, device=dev),) * 2)


def test_lr_pixel_design_counts_nothing(dev):
    before = lr_cuda.launches
    lr_cuda._check_pixel(torch.zeros(4, 8, device=dev), torch.zeros(4, 8, device=dev), -1)
    assert lr_cuda.launches == before


def test_lr_pair_backward_is_the_plain_gradient(dev):
    dl, dr = _lr_inputs((12, 40), 16, 33, dev)
    dr = dr.nan_to_num(3.0)
    grads = []
    for fn in (dispatch.left_right_check_pair, costvolume.left_right_check_pair):
        xs = [dl.clone().requires_grad_(True), dr.clone().requires_grad_(True)]
        out_l, out_r = fn(*xs, 1.0, max_disp=16)
        (out_l.nan_to_num(0.0).sum() + 2.0 * out_r.nan_to_num(0.0).sum()).backward()
        grads.append([x.grad for x in xs])
    for g_op, g_plain in zip(*grads):
        torch.testing.assert_close(g_op, g_plain, atol=0, rtol=0)


# --- the running-mean view update (csrc/cost_volume_add.cu) against its
# plain version

def _bits(t):
    """A float32 tensor's bits, so that -0 differs from +0 and NaN equals
    itself."""
    return t.contiguous().view(torch.int32)


def _same_bits(got, want):
    return torch.equal(got, want) and (got.dtype != torch.float32
                                       or torch.equal(_bits(got), _bits(want)))


def _turn(axis, degrees):
    """The rotation by ``degrees`` about the unit ``axis`` (Rodrigues)."""
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    th = np.radians(degrees)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _pose(R=np.eye(3), t=(0.0, 0.0, 0.0)):
    return np.hstack([R, np.asarray(t, np.float64)[:, None]]).astype(np.float32)


def _handheld_poses(views, seed):
    """T_wc of ``views`` frames of a camera that turns 0.297 degrees and
    moves 8.1 mm a frame (the mean speeds of the handheld TUM RGB-D fr1/xyz
    at 30 Hz) about and along directions drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    axis, along = rng.normal(size=(2, 3))
    along /= np.linalg.norm(along)
    return [_pose(_turn(axis, 0.297 * k), 0.0081 * k * along) for k in range(1, views + 1)]


def _projection(K, T_wc, dev):
    """MultiViewStereo.add's KT_cv of a view at T_wc onto a keyframe at the
    identity."""
    from kangaroo_tpu_torch.core import se3

    return K.matrix(device=dev) @ se3.inverse(torch.from_numpy(T_wc).to(dev))


def test_cost_volume_add_kernel_matches_plain_on_a_handheld_track(dev):
    """VGA/128 seeded from its rectified pair, then 20 handheld uint8 views
    through ``MultiViewStereo.add`` (the kernel, counted once a view) and
    through the plain version from its own running state: the same bits
    after every view, the inputs untouched."""
    from kangaroo_tpu_torch.containers import Intrinsics

    W, H, D = 640, 480, 128
    left, right, _ = synthetic.stereo_pair(W, H, D, seed=3, device=dev)
    K = Intrinsics.centered(0.9 * W, W, H)
    mvs = stereo.MultiViewStereo(K, 0.1, stereo.StereoConfig(max_disp=D))
    mvs.reset(left, torch.eye(3, 4, device=dev), right=right)
    n_p, s_p = mvs.n, mvs.s
    for k, T_wc in enumerate(_handheld_poses(20, seed=5)):
        img = torch.roll(right, shifts=(k % 3, -k), dims=(0, 1))
        T = torch.from_numpy(T_wc).to(dev)
        n, s = mvs.n, mvs.s
        ins = [t.clone() for t in (n, s, left, img, T)]
        before = profiling.counts()["cost_volume_add"]
        mvs.add(img, T)
        assert profiling.counts()["cost_volume_add"] == before + 1
        assert all(_same_bits(a, b) for a, b in zip(ins, (n, s, left, img, T)))
        n_p, s_p = costvolume._cost_volume_add_plain(n_p, s_p, left, img,
                                                     _projection(K, T_wc, dev), K, 0.1, 1)
        assert _same_bits(mvs.n, n_p) and _same_bits(mvs.s, s_p), k
    assert float(mvs.n.max()) == 21.0 and float((mvs.n > 10).float().mean()) > 0.25


# a lateral view, a turn that takes most cells off the image, a step 1 m
# forward that puts the near cells behind the camera, and a half turn that
# puts every cell behind it
SMALL_POSES = {"lateral": _pose(t=(0.1, 0.0, 0.0)),
               "turn": _pose(_turn((0.2, 1.0, 0.1), 25.0), (0.02, 0.0, 0.01)),
               "forward": _pose(t=(0.0, 0.0, 1.0)),
               "half_turn": _pose(_turn((0.0, 1.0, 0.0), 180.0))}


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("rad", [0, 1, 2, 3])
def test_cost_volume_add_kernel_matches_plain_off_the_image_and_behind(dev, rad, dtype):
    """(24, 37, 61) from a running state, each pose of ``SMALL_POSES``:
    the same bits as the plain version, the inputs untouched, one launch a
    call; the half turn adds nothing, the step forward only the far
    cells."""
    from kangaroo_tpu_torch.containers import Intrinsics

    D, H, W = 24, 37, 61
    rng = np.random.default_rng(40 + rad)

    def image():
        a = rng.uniform(0, 255, (H, W))
        return torch.from_numpy(a.astype(np.uint8) if dtype == torch.uint8
                                else a.astype(np.float32)).to(dev)

    K = Intrinsics.centered(0.9 * W, W, H)
    n = torch.from_numpy(rng.integers(0, 4, (D, H, W)).astype(np.float32)).to(dev)
    s = n * torch.from_numpy(rng.uniform(0, 60, (D, H, W)).astype(np.float32)).to(dev)
    img_v = image()
    added = {}
    for name, T_wc in SMALL_POSES.items():
        img_c, KT = image(), _projection(K, T_wc, dev)
        ins = [t.clone() for t in (n, s, img_v, img_c, KT)]
        before = costvolume_cuda.launches
        got = costvolume.cost_volume_add(n, s, img_v, img_c, KT, K, 0.1, rad)
        assert costvolume_cuda.launches == before + 1
        assert all(_same_bits(a, b) for a, b in zip(ins, (n, s, img_v, img_c, KT)))
        want = costvolume._cost_volume_add_plain(n, s, img_v, img_c, KT, K, 0.1, rad)
        assert all(_same_bits(g, w) for g, w in zip(got, want)), name
        added[name] = got[0] - n
    assert float(added["lateral"].mean()) > 0.2 and float(added["half_turn"].abs().max()) == 0
    near, far = added["forward"][D // 2:], added["forward"][1:3]
    assert float(near.abs().max()) == 0 and float(far.mean()) > 0.1


def test_cost_volume_add_kernel_matches_plain_where_taps_round_across_an_integer(dev):
    """A projection onto coordinates within a few units in the last place
    below 8 and 16, where pu + 1 (pv + 1) can round up to the next integer:
    those taps gather on their own, the others take the shared window; the
    same bits as the plain version."""
    from kangaroo_tpu_torch.containers import Intrinsics

    D, H, W = 32, 48, 64
    K = Intrinsics.centered(0.9 * W, W, H)
    ulp8, ulp16 = 2.0 ** -21, 2.0 ** -20  # the spacing of floats just below 8 and 16
    KT = torch.tensor([[ulp8, 0, 0, 8 - 3 * ulp8], [0, ulp16, 0, 16 - 3 * ulp16], [0, 0, 0, 1]],
                      dtype=torch.float32, device=dev)
    rng = np.random.default_rng(60)
    img_v, img_c = (torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.uint8)).to(dev)
                    for _ in range(2))
    n, s = torch.zeros(D, H, W, device=dev), torch.zeros(D, H, W, device=dev)
    got = costvolume.cost_volume_add(n, s, img_v, img_c, KT, K, 0.1)
    want = costvolume._cost_volume_add_plain(n, s, img_v, img_c, KT, K, 0.1)
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert float(got[0][1:].min()) == 1.0  # every cell past d = 0 in view
    # the plain version's pu: P0 * ulp8 + (8 - 3 ulp8), over kz = 1
    fu, base, tiny = (torch.tensor(v, dtype=torch.float32, device=dev)
                      for v in (K.fu, 0.1, 1e-9))
    z = fu * base / torch.maximum(torch.arange(D, dtype=torch.float32, device=dev), tiny)
    u = torch.arange(W, dtype=torch.float32, device=dev)
    pu = (z[1:, None] * (u - K.u0) / fu) * KT[0, 0] + KT[0, 3]
    assert int((torch.floor(pu + 1) != torch.floor(pu) + 1).sum()) > 0


def test_cost_volume_add_kernel_matches_plain_past_2_24_pixels(dev):
    """4100x4100 at rad 1: past 2^24 pixels the plain version's float
    offsets r + c round to even, and the kernel takes the taps as the plain
    version gathers them (no shared window): the same bits."""
    from kangaroo_tpu_torch.containers import Intrinsics

    D, H, W = 2, 4100, 4100
    K = Intrinsics.centered(0.9 * W, W, H)
    rng = np.random.default_rng(61)
    img_v, img_c = (torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.uint8)).to(dev)
                    for _ in range(2))
    n, s = torch.ones(D, H, W, device=dev), torch.zeros(D, H, W, device=dev)
    KT = _projection(K, SMALL_POSES["lateral"], dev)
    got = costvolume.cost_volume_add(n, s, img_v, img_c, KT, K, 0.1)
    want = costvolume._cost_volume_add_plain(n, s, img_v, img_c, KT, K, 0.1)
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert float((got[0][1] - n[1]).mean()) > 0.9


def test_cost_volume_add_checks_its_arguments(dev):
    from kangaroo_tpu_torch.containers import Intrinsics

    D, H, W = 4, 12, 16
    n, s = torch.zeros(D, H, W, device=dev), torch.zeros(D, H, W, device=dev)
    img, KT = torch.zeros(H, W, dtype=torch.uint8, device=dev), torch.eye(3, 4, device=dev)
    K = Intrinsics.centered(14.4, W, H)
    before = profiling.counts()["cost_volume_add"]
    bad = [(TypeError, (n.double(), s, img, img, KT), {}),
           (TypeError, (n, s, img.to(torch.int32), img, KT), {}),
           (ValueError, (n, s[:, :, 1:].contiguous(), img, img, KT), {}),
           (ValueError, (n, s, img, img[1:].contiguous(), KT), {}),
           (ValueError, (torch.zeros(D, W, H, device=dev).transpose(1, 2), s, img, img, KT), {}),
           (ValueError, (n, s, img, img, KT[:, :3]), {}),
           (ValueError, (n, s, img, img, KT.cpu()), {}),
           (ValueError, (n, s, img, img, KT), {"rad": -1})]
    for err, args, kw in bad:
        with pytest.raises(err):
            costvolume.cost_volume_add(*args, K, 0.1, **kw)
    assert profiling.counts()["cost_volume_add"] == before


def test_cost_volume_add_backward_is_the_plain_gradient(dev):
    """s and KT_cv requiring grad: the kernel's forward, the plain
    version's gradient, the same bits as the plain version's own."""
    from kangaroo_tpu_torch.containers import Intrinsics

    D, H, W = 8, 20, 32
    rng = np.random.default_rng(50)
    K = Intrinsics.centered(0.9 * W, W, H)
    n = torch.ones(D, H, W, device=dev)
    s = torch.from_numpy(rng.uniform(0, 40, (D, H, W)).astype(np.float32)).to(dev)
    img_v, img_c = (torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.uint8)).to(dev)
                    for _ in range(2))
    KT = _projection(K, SMALL_POSES["lateral"], dev)
    w = torch.from_numpy(rng.normal(size=(D, H, W)).astype(np.float32)).to(dev)
    grads = []
    for fn in (costvolume.cost_volume_add, costvolume._cost_volume_add_plain):
        xs = [s.clone().requires_grad_(True), KT.clone().requires_grad_(True)]
        _, s2 = fn(n, xs[0], img_v, img_c, xs[1], K, 0.1, 1)
        (s2 * w).sum().backward()
        grads.append([x.grad for x in xs])
    for g_op, g_plain in zip(*grads):
        assert g_op is not None and _same_bits(g_op, g_plain)
    assert float(grads[0][1].abs().max()) > 0


def test_cost_volume_add_records_its_stage_dispatch_and_kernel_spans(dev, tmp_path):
    from kangaroo_tpu_torch.containers import Intrinsics

    D, H, W = 8, 20, 32
    K = Intrinsics.centered(0.9 * W, W, H)
    n, s = torch.zeros(D, H, W, device=dev), torch.zeros(D, H, W, device=dev)
    img = torch.zeros(H, W, dtype=torch.uint8, device=dev)
    with profiling.trace(str(tmp_path)):
        costvolume.cost_volume_add(n, s, img, img, _projection(K, SMALL_POSES["lateral"], dev),
                                   K, 0.1)
    spans = profiling.spans()
    (stage,), (wrapper,), (kernel,) = ([x for x in spans if x.layer == layer]
                                       for layer in ("stage", "dispatch", "kernel"))
    assert (stage.name, wrapper.name, kernel.name) == ("stereo.costvolume.cost_volume_add",
                                                       "stereo.costvolume_cuda.cost_volume_add",
                                                       "kt_cost_volume_add")
    assert kernel.parent == wrapper.id and wrapper.parent == stage.id
    assert 0 < kernel.device_ms <= wrapper.device_ms <= stage.device_ms


# --- the census transform and its Hamming volume (csrc/census.cu) against
# their plain versions, bit for bit

CENSUS_WINDOWS = ["9x7", "11x11", "16x16"]
# (H, W): single pixels, rows and columns shorter than every window, and a
# KITTI frame
CENSUS_SHAPES = [(1, 1), (1, 7), (7, 1), (2, 3), (3, 40), (375, 1242)]


def _census_images(shape, dtype, dev, seed=0):
    """Few grey levels (equal neighbours set no bit), each frame of a stack
    bright in its first row and dark in its last (a window that read across
    a seam would see it); float32 images hold NaNs too."""
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 6, shape) * 40 + 20).astype(np.float32)
    img[..., 0, :] = 255
    img[..., -1, :] = 0
    if dtype == torch.float32:
        img[rng.random(shape) < 0.02] = np.nan
    return torch.from_numpy(img).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("B", [None, 1, 3], ids=["image", "B1", "B3"])
@pytest.mark.parametrize("shape", CENSUS_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("window", CENSUS_WINDOWS)
def test_census_kernel_matches_plain(dev, window, shape, B, dtype):
    img = _census_images(shape if B is None else (B,) + shape, dtype, dev)
    before = profiling.counts()["census"]
    got = census.census(img, window)
    assert profiling.counts()["census"] == before + 1  # one launch, the stack too
    want = census._census_plain(img, window)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)
    if B == 3:  # each frame at its own borders
        assert all(torch.equal(got[k], census._census_plain(img[k], window)) for k in range(B))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sd", [-1, 1])
@pytest.mark.parametrize("D", [1, 4, "W+3"])
@pytest.mark.parametrize("shape", CENSUS_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("window", CENSUS_WINDOWS)
def test_census_volume_kernel_matches_plain(dev, window, shape, D, sd, dtype):
    D = shape[1] + 3 if D == "W+3" else D
    left = census.census(_census_images(shape, torch.uint8, dev, 1), window)
    right = census.census(_census_images(shape, torch.uint8, dev, 2), window)
    bits = census.norm_bits(window)
    before = profiling.counts()["census_volume"]
    got = census.census_cost_volume(left, right, D, sd, bits, dtype)
    assert profiling.counts()["census_volume"] == before + 1
    want = census._census_cost_volume_plain(left, right, D, sd, bits, dtype)
    assert got.dtype == dtype and got.shape == want.shape == (D,) + shape
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("bits", [None, 100])
def test_census_volume_kernel_matches_plain_on_any_words(dev, K, bits):
    """Words of every value below 2**32, 1 to 4 a pixel, the default and a
    scale that is no power of two (its float32 products round)."""
    rng = np.random.default_rng(K)
    left, right = (torch.from_numpy(rng.integers(0, 2**32, (9, 70, K), dtype=np.int64)).to(dev)
                   for _ in range(2))
    for sd in (-1, 1):
        got = census.census_cost_volume(left, right, 33, sd, bits)
        want = census._census_cost_volume_plain(left, right, 33, sd, bits)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_census_kernels_record_their_stage_dispatch_and_kernel_spans(dev, tmp_path):
    img = _census_images((2, 20, 32), torch.uint8, dev)
    with profiling.trace(str(tmp_path)):
        words = census.census(img, "16x16")
        census.census_cost_volume(words[0], words[1], 8, -1, 256, torch.bfloat16)
    spans = profiling.spans()
    stages, wrappers, kernels = ([x for x in spans if x.layer == layer]
                                 for layer in ("stage", "dispatch", "kernel"))
    assert [s.name for s in stages] == ["stereo.census.census", "stereo.census.census_cost_volume"]
    assert [s.name for s in wrappers] == ["stereo.census_cuda.census",
                                          "stereo.census_cuda.census_cost_volume"]
    assert [s.name for s in kernels] == ["kt_census", "kt_census_volume"]
    for stage, wrapper, kernel in zip(stages, wrappers, kernels):
        assert kernel.parent == wrapper.id and wrapper.parent == stage.id
        assert 0 < kernel.device_ms <= wrapper.device_ms <= stage.device_ms


def test_batched_sgm_matches_its_frames_with_one_census_launch_a_side(dev):
    """3 KITTI-sized pairs at 128 disparities: the batched frame equals
    ``sgm_pipeline`` frame by frame, bit for bit, with one census launch for
    the lefts, one for the rights and one volume launch."""
    W, H, D = 1242, 375, 128
    pairs = [synthetic.stereo_pair(W, H, D, seed=k, device=dev)[:2] for k in range(3)]
    lefts, rights = (torch.stack([p[i] for p in pairs]) for i in (0, 1))
    cfg = stereo_sgm.SgmConfig(max_disp=D)
    before = profiling.counts()
    got = stereo_sgm.sgm_pipeline_batched(lefts, rights, cfg)
    now = profiling.counts()
    assert (now["census"] - before["census"], now["census_volume"] - before["census_volume"]) \
        == (2, 1)
    for k in range(3):
        want = stereo_sgm.sgm_pipeline(lefts[k], rights[k], cfg)
        assert torch.equal(_bits(got[k]), _bits(want)), k
    assert float(got.isfinite().float().mean()) > 0.8
