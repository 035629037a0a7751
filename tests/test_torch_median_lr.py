"""The median kernel's sorting networks and tile schedule, and the LR
check's pair, on the CPU.

- Every network ``median_network.cuh`` holds (``ops/median_cuda.py``) is
  checked over every 0-1 input of its structure: the column sorts, each
  merge of sorted lists, and each thread's whole network where its inputs
  are few enough to list (else over 2^20 of them drawn at random).
- A PyTorch emulation of ``csrc/median.cu``'s schedule (a tile and its
  clamped halo staged with non-finite taps as +inf, each column sorted once,
  a thread's pixels merged from the columns they share, the select tree over
  the top positions) equals the plain median exactly, NaN positions
  included, for every radius and pixels a thread.
- The wrappers' routing and argument marshalling, through a stand-in for the
  kernels' library that records each call.
- The LR pair: its plain version and its gradient through ``_KernelOp``, and
  the SGM frame, batch and mesh frame with the pair equal to the same frames
  with two one-way checks.

The kernels themselves are held against the designs they replaced and the
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import contextlib
import re

import numpy as np
import pytest
import torch

from kangaroo_tpu_torch import _build, backend
from kangaroo_tpu_torch.apps import stereo_sgm, synthetic
from kangaroo_tpu_torch.ops import median as median_plain
from kangaroo_tpu_torch.ops import median_cuda
from kangaroo_tpu_torch.parallel.mesh import make_mesh
from kangaroo_tpu_torch.stereo import costvolume, dispatch, lr_cuda

CASES = [(rad, pix) for rad in median_cuda.RADII for pix in median_cuda.PIXELS]


# --- the networks ------------------------------------------------------------

@pytest.mark.parametrize("rad", median_cuda.RADII)
def test_column_sort_sorts_every_input(rad):
    net = median_cuda.column_network(2 * rad + 1)
    assert median_cuda.check_network(net)


@pytest.mark.parametrize("rad,pix", CASES)
def test_every_merge_of_a_thread_network_is_exact(rad, pix):
    net = median_cuda.thread_network(rad, pix)
    assert net.merges
    for na, nb, t in set(net.merges):
        assert median_cuda.check_network(median_cuda.merge_network(na, nb, t)), (na, nb, t)


@pytest.mark.parametrize("rad,pix", CASES)
def test_no_merge_comparator_is_fixed_by_sorted_inputs(rad, pix):
    """Nothing to prune on the inputs' structure: every comparator of every
    merge swaps on some 0-1 input of two sorted lists."""
    for na, nb, t in set(median_cuda.thread_network(rad, pix).merges):
        net = median_cuda.merge_network(na, nb, t)
        vals = median_cuda._run(net.ops, median_cuda._zero_one_inputs(net.parts)[0])
        for _, _, a, b in net.ops:
            assert vals[a] & ~vals[b] and vals[b] & ~vals[a], (na, nb, t, a, b)


@pytest.mark.parametrize("rad,pix", CASES)
def test_thread_network_selects_the_top_positions(rad, pix):
    """The whole network over every 0-1 input of sorted columns where those
    are at most a few million (up to 6^8); else over 2^20 of them drawn at
    random, its merges (above) vouching for the rest."""
    S = 2 * rad + 1
    net = median_cuda.thread_network(rad, pix)
    assert len(net.outputs) == pix and all(len(o) == (S * S + 1) // 2 for o in net.outputs)
    assert median_cuda.check_network(net, limit=2_200_000)


@pytest.mark.parametrize("net", [median_cuda.merge_network(5, 5, 10),
                                 median_cuda.thread_network(2, 2)])
def test_check_network_catches_a_wrong_comparator(net):
    (out, kind, a, b), *rest = net.ops
    broken = median_cuda.Network(net.parts, ((out, "max" if kind == "min" else "min", a, b),
                                             *rest), net.outputs, net.covers)
    assert not median_cuda.check_network(broken)


def test_networks_are_pruned_below_the_replaced_design():
    """Fewer min/max a pixel than the full network, and sharing the columns
    between two pixels pays (csrc/median.cu's figures)."""
    counts = {pix: median_cuda.network_counts(2, pix) for pix in median_cuda.PIXELS}
    assert counts[2] == {"column": 18, "merge": 101.5, "replaced": 280}
    assert counts[2]["merge"] < counts[1]["merge"]
    for rad, pix in CASES:
        c = median_cuda.network_counts(rad, pix)
        assert c["column"] + c["merge"] < c["replaced"]


@pytest.mark.parametrize("rad,pix", CASES)
def test_header_holds_each_network(rad, pix):
    header = _build.generated_headers()["median_network.cuh"]
    body = header.split(f"median_top<{rad}, {pix}>(const float* c, float* top) {{", 1)[1]
    body = body.split("\n}", 1)[0]
    net = median_cuda.thread_network(rad, pix)
    ops = re.findall(r"const float w(\d+) = f(min|max)f\((\w+)\[?(\d*)\]?, (\w+)\[?(\d*)\]?\);",
                     body)
    assert len(ops) == len(net.ops)
    stores = re.findall(r"top\[(\d+)\] = ", body)
    assert [int(i) for i in stores] == list(range(sum(map(len, net.outputs))))


# --- the tile schedule, emulated ---------------------------------------------

def _run(net, inputs):
    vals = dict(enumerate(inputs))
    for out, kind, a, b in net.ops:
        vals[out] = (torch.minimum if kind == "min" else torch.maximum)(vals[a], vals[b])
    return [[vals[w] for w in o] for o in net.outputs]


def tiled_median(img, max_bads, rad, pix, rows, threads_x):
    """``median_tile_kernel``'s schedule in PyTorch, for each max_bad of
    ``max_bads``: tiles of ``rows`` x (``threads_x`` pix) pixels of each
    image; the tile and a halo of rad staged with clamped coordinates and
    non-finite taps as +inf; each staged column of 2 rad + 1 taps sorted by
    ``batcher_sort`` and its +inf counted; thread t's pix pixels from columns
    t pix .. t pix + pix + 2 rad - 1 through ``median_top``; the select tree
    over the top positions; pixels beyond the image computed, not stored."""
    stack = img if img.dim() == 3 else img[None]
    N, H, W = stack.shape
    S = 2 * rad + 1
    K, T = S * S, S * S - S * S // 2
    TW = threads_x * pix
    inf = torch.tensor(float("inf"))
    sort, net = median_cuda.column_network(S), median_cuda.thread_network(rad, pix)
    out = torch.full((len(max_bads), N, H, W), 123.0)  # every pixel must be written
    for n in range(N):
        for y0 in range(0, H, rows):
            for x0 in range(0, W, TW):
                ys = (torch.arange(rows + 2 * rad) + y0 - rad).clamp(0, H - 1)
                xs = (torch.arange(TW + 2 * rad) + x0 - rad).clamp(0, W - 1)
                tap = stack[n][ys][:, xs]
                tap = torch.where(torch.isfinite(tap), tap, inf)
                taps = [tap[k:k + rows] for k in range(S)]
                bad = sum((t == inf).int() for t in taps)
                col = _run(sort, taps)[0]
                lanes = torch.arange(threads_x) * pix
                tops = _run(net, [col[k][:, lanes + j] for j in range(pix + 2 * rad)
                                  for k in range(S)])
                gy = y0 + torch.arange(rows)[:, None]
                for p in range(pix):
                    nb = sum(bad[:, lanes + p + j] for j in range(S))
                    sel = ((K + nb) // 2).clamp(max=K - 1) - K // 2
                    v, s = list(tops[p]), 1
                    while s < T:
                        for i in range(0, T - s, 2 * s):
                            v[i] = torch.where((sel & s) != 0, v[i + s], v[i])
                        s *= 2
                    gx = x0 + lanes[None, :] + p
                    keep = (gx < W) & (gy < H)
                    for m, max_bad in enumerate(max_bads):
                        res = torch.where((nb < max_bad) & (nb < K), v[0], float("nan"))
                        out[m, n, gy.expand_as(keep)[keep], gx.expand_as(keep)[keep]] = res[keep]
    return out.reshape(len(max_bads), *img.shape)


def _image(shape, seed):
    """Disparity-like values with NaN, +inf and -inf at 10 %, a bad row and a
    bad column, and +0 and -0 taps."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 16, shape).astype(np.float32)
    for v in (np.nan, np.inf, -np.inf):
        img[rng.random(shape) < 0.1 / 3] = v
    img[rng.random(shape) < 0.1] = 0.0
    img[rng.random(shape) < 0.1] = -0.0
    img[..., shape[-2] // 2, :] = np.nan
    img[..., :, shape[-1] // 3] = np.inf
    return torch.from_numpy(img)


def _equal(got, want):
    """Exact, +0 equal to -0, NaN positions equal."""
    return bool(((torch.isnan(got) & torch.isnan(want)) | (got == want)).all())


@pytest.mark.parametrize("rad,pix", CASES)
@pytest.mark.parametrize("shape", [(29, 67), (5, 3)])
def test_tile_schedule_equals_the_plain_median(rad, pix, shape):
    img = _image(shape, seed=rad * 10 + pix)
    K = (2 * rad + 1) ** 2
    max_bads = (0, 1, 12, K, K + 5)
    got = tiled_median(img, max_bads, rad, pix, rows=4, threads_x=4)
    for m, max_bad in enumerate(max_bads):
        assert _equal(got[m], median_plain.median_filter_reject_invalid(img, max_bad, rad))


@pytest.mark.parametrize("shape", [(1, 1), (1, 19), (19, 1), (3, 5)])
def test_tile_schedule_on_images_smaller_than_the_window(shape):
    img = _image(shape, seed=7)
    for rad in median_cuda.RADII:
        got = tiled_median(img, (12,), rad, 2, rows=4, threads_x=4)[0]
        assert _equal(got, median_plain.median_filter_reject_invalid(img, 12, rad))


def test_tile_schedule_filters_each_image_of_a_stack_alone():
    stack = _image((3, 11, 13), seed=8)
    got = tiled_median(stack, (12,), 2, 2, rows=4, threads_x=4)[0]
    for n in range(3):
        assert _equal(got[n], median_plain.median_filter_reject_invalid(stack[n], 12, 2))


# --- the wrappers, through a stand-in library ----------------------------------

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
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(backend, "require_kernels", lambda t, op: None)
    monkeypatch.setattr(backend, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(median_cuda, "launches", 0)
    monkeypatch.setattr(lr_cuda, "launches", 0)
    return lib


def _named(entry, args, names):
    assert len(args) == len(names) == len(_build.SIGNATURES[entry])
    return dict(zip(names, args))


MEDIAN_NAMES = ("img", "out", "N", "H", "W", "rad", "max_bad", "stream")
LR_NAMES = ("disp_l", "disp_r", "out_l", "out_r", "H", "W", "sd", "max_diff", "max_disp",
            "stream")


@pytest.mark.parametrize("shape", [(7, 9), (3, 7, 9)])
def test_median_launches_once_for_an_image_or_a_stack(library, shape):
    img = torch.zeros(shape)
    out = median_cuda.median_filter_reject_invalid(img, 12, 2)
    assert out.shape == img.shape and median_cuda.launches == 1
    [(entry, args)] = library.calls
    a = _named(entry, args, MEDIAN_NAMES)
    assert entry == "kt_median_reject_invalid"
    assert (a["N"], a["H"], a["W"], a["rad"], a["max_bad"]) == ((3,) if len(shape) == 3
                                                                 else (1,)) + (7, 9, 2, 12)
    assert (a["img"], a["out"]) == (img.data_ptr(), out.data_ptr())


def test_median_pixel_design_counts_nothing(library):
    median_cuda._median_pixel(torch.zeros(7, 9), 4, 1)
    [(entry, args)] = library.calls
    assert entry == "kt_median_reject_invalid_pixel" and median_cuda.launches == 0
    assert args[2:6] == (7, 9, 1, 4)
    with pytest.raises(ValueError, match="one"):
        median_cuda._median_pixel(torch.zeros(2, 7, 9), 4, 1)


@pytest.mark.parametrize("img,rad,err", [(torch.zeros(2, 2, 7, 9), 2, ValueError),
                                         (torch.zeros(0, 7, 9), 2, ValueError),
                                         (torch.zeros(7, 9), 4, ValueError),
                                         (torch.zeros(7, 9, dtype=torch.float64), 2, TypeError),
                                         (torch.zeros(9, 7).t(), 2, ValueError)])
def test_median_checks_before_it_launches(library, img, rad, err):
    with pytest.raises(err):
        median_cuda.median_filter_reject_invalid(img, 12, rad)
    assert library.calls == [] and median_cuda.launches == 0


@pytest.mark.parametrize("sd", [-1, 1])
def test_lr_one_way_launches_the_row_kernel(library, sd):
    dl, dr = torch.zeros(5, 11), torch.ones(5, 11)
    out = lr_cuda.left_right_check(dl, dr, sd, 0.5, max_disp=8)
    [(entry, args)] = library.calls
    a = _named(entry, args, LR_NAMES)
    assert entry == "kt_lr_check" and lr_cuda.launches == 1
    assert (a["disp_l"], a["disp_r"], a["out_l"], a["out_r"]) == (dl.data_ptr(), dr.data_ptr(),
                                                                  out.data_ptr(), None)
    assert (a["H"], a["W"], a["sd"], a["max_diff"], a["max_disp"]) == (5, 11, sd, 0.5, 8)


def test_lr_pair_is_one_launch(library):
    dl, dr = torch.zeros(5, 11), torch.ones(5, 11)
    out_l, out_r = lr_cuda.left_right_check_pair(dl, dr, 1.0, max_disp=8)
    [(entry, args)] = library.calls
    a = _named(entry, args, LR_NAMES)
    assert entry == "kt_lr_check" and lr_cuda.launches == 1
    assert (a["out_l"], a["out_r"], a["sd"]) == (out_l.data_ptr(), out_r.data_ptr(), 0)


def test_lr_pixel_design_counts_nothing(library):
    lr_cuda._check_pixel(torch.zeros(5, 11), torch.zeros(5, 11), 1, 1.0, 8)
    [(entry, args)] = library.calls
    assert entry == "kt_lr_check_pixel" and lr_cuda.launches == 0
    assert args[3:] == (5, 11, 1, 1.0, -8, 1, 0)


@pytest.mark.parametrize("dl,dr,sd", [(torch.zeros(2, lr_cuda.MAX_WIDTH + 1),) * 2 + (-1,),
                                      (torch.zeros(4, 6), torch.zeros(4, 7), -1),
                                      (torch.zeros(4, 6), torch.zeros(4, 6), 0),
                                      (torch.zeros(4, 6), torch.zeros(4, 6), 2)])
def test_lr_checks_before_it_launches(library, dl, dr, sd):
    with pytest.raises(ValueError):
        lr_cuda.left_right_check(dl, dr, sd)
    if sd == -1:
        with pytest.raises(ValueError):
            lr_cuda.left_right_check_pair(dl, dr)
    assert library.calls == [] and lr_cuda.launches == 0


def test_failed_launch_raises_and_counts_nothing(library):
    library.rc = 1
    with pytest.raises(RuntimeError, match="cudaError 1"):
        lr_cuda.left_right_check_pair(torch.zeros(4, 6), torch.zeros(4, 6))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        median_cuda.median_filter_reject_invalid(torch.zeros(4, 6), 12)
    assert lr_cuda.launches == median_cuda.launches == 0


# --- the LR pair ---------------------------------------------------------------

def _disparities(seed, H=12, W=40, D=16):
    rng = np.random.default_rng(seed)
    dl = rng.uniform(-3, D + 3, (H, W)).astype(np.float32)
    dr = (dl + rng.normal(0, 0.8, (H, W))).astype(np.float32)
    dl[rng.random((H, W)) < 0.1] = np.nan
    dr[rng.random((H, W)) < 0.1] = np.nan
    return torch.from_numpy(dl), torch.from_numpy(dr)


def test_pair_is_the_two_checks_in_reference_order():
    dl, dr = _disparities(0)
    got_l, got_r = dispatch.left_right_check_pair(dl, dr, 1.0, max_disp=16)
    want_r = costvolume.left_right_check(dr, dl, 1, 1.0, 16)
    want_l = costvolume.left_right_check(dl, want_r, -1, 1.0, 16)
    assert _equal(got_r, want_r) and _equal(got_l, want_l)
    # the order matters: the left check reads the checked right image
    assert not _equal(got_l, costvolume.left_right_check(dl, dr, -1, 1.0, 16))


def test_pair_backward_is_the_plain_gradient():
    """_KernelOp with two outputs: a stand-in kernel returning the plain
    outputs detached; the backward of each output's gradient is the plain
    pair's."""
    dl, dr = _disparities(1)
    dr = dr.nan_to_num(3.0)
    kw = dict(max_diff=1.0, max_disp=16)

    def stand_in(a, b, **k):
        return tuple(t.detach() for t in costvolume.left_right_check_pair(a, b, **k))

    grads = []
    for run in (lambda a, b: dispatch._KernelOp.apply(stand_in, costvolume.left_right_check_pair,
                                                      kw, a, b),
                lambda a, b: costvolume.left_right_check_pair(a, b, **kw)):
        a, b = dl.clone().requires_grad_(True), dr.clone().requires_grad_(True)
        out_l, out_r = run(a, b)
        (out_l.nan_to_num(0.0).sum() + 2.0 * out_r.nan_to_num(0.0).sum()).backward()
        grads.append((a.grad, b.grad))
    for g_op, g_plain in zip(*grads):
        torch.testing.assert_close(g_op, g_plain)
    assert grads[0][0].abs().sum() > 0 and grads[0][1].abs().sum() > 0


def _two_checks(disp_l, disp_r, max_diff=1.0, max_disp=192):
    disp_r = dispatch.left_right_check(disp_r, disp_l, 1, max_diff, max_disp)
    return dispatch.left_right_check(disp_l, disp_r, -1, max_diff, max_disp), disp_r


@pytest.mark.parametrize("path", ["frame", "frame-8path", "mesh", "mesh-8path", "batch"])
def test_sgm_paths_with_the_pair_equal_two_checks(monkeypatch, path):
    """Every SGM path with the pair equals, pixel for pixel, the same path
    with the LR stage as the two one-way checks it replaced."""
    left, right, _ = synthetic.stereo_pair(48, 16, 8, seed=2, device="cpu")
    cfg = stereo_sgm.SgmConfig(max_disp=8, census_window="9x7",
                               do_diagonal=path.endswith("8path"))
    mesh = make_mesh(devices=["cpu"] * 4) if path.startswith("mesh") else None

    def run():
        if path == "batch":
            return stereo_sgm.sgm_pipeline_batched(torch.stack([left, right]),
                                                   torch.stack([right, left]), cfg)
        return stereo_sgm.sgm_pipeline(left, right, cfg, mesh=mesh)

    got = run()
    monkeypatch.setattr(dispatch, "left_right_check_pair", _two_checks)
    want = run()
    assert got.shape == want.shape and _equal(got, want)
    assert torch.isfinite(got).float().mean() > 0.5
