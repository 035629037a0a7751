"""The census transform and its Hamming volume around their kernels
(``stereo/census.py``, ``stereo/census_cuda.py``) on the CPU: the plain
census of a (B, H, W) stack equals the frame-by-frame census; a CPU tensor
runs the plain versions and launches nothing; a tensor off the CPU goes to
the kernels and never to the plain versions, and raises there where they do
not take its type or size; the wrappers' C calls, checked through a
stand-in for the kernels' library that records them, take the tensors'
storage, the sizes, the window and the scale; the batched SGM frame makes
one census call a side and is unchanged. The kernels themselves are held
against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); ``test_torch_census.py`` holds the plain versions
against the JAX package.
"""
import contextlib

import numpy as np
import pytest
import torch

from kangaroo_tpu_torch import _build, backend
from kangaroo_tpu_torch.apps import stereo_sgm
from kangaroo_tpu_torch.stereo import census, census_cuda
from kangaroo_tpu_torch.utils import profiling

WINDOWS = ["9x7", "11x11", "16x16"]


def _stack(B, H, W, dtype=torch.uint8, seed=0):
    """Frames that differ at their seams: each frame's first and last rows
    far from its neighbours' (a window reading across a seam would see
    it), few grey levels so that equal neighbours occur as well."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 8, (B, H, W)).astype(np.float32) * 30
    img[:, 0] = 255 - img[:, 0]
    img[::2, -1] = 0
    return torch.from_numpy(img).to(dtype)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("window", WINDOWS)
def test_plain_census_of_a_stack_equals_the_frame_by_frame_census(window, dtype):
    imgs = _stack(3, 13, 11, dtype)
    got = census.census(imgs, window)
    want = torch.stack([census.census(img, window) for img in imgs])
    assert got.dtype == torch.int64 and torch.equal(got, want)
    # stacked along the rows, the frames would read each other's rows
    rows = census.census(imgs.reshape(39, 11), window).reshape(got.shape)
    assert not torch.equal(rows, got)


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    before = profiling.counts()
    imgs = _stack(2, 9, 10)
    words = census.census(imgs, "16x16")
    assert torch.equal(words, census._census_plain(imgs, "16x16"))
    cl, cr = words[0], words[1]
    vol = census.census_cost_volume(cl, cr, 4, 1, 256, torch.bfloat16)
    assert torch.equal(vol, census._census_cost_volume_plain(cl, cr, 4, 1, 256, torch.bfloat16))
    assert profiling.counts() == before


def test_other_devices_take_the_kernels_or_raise(monkeypatch):
    """Off the CPU, every image goes to the census kernel and every pair of
    word images to the volume kernel, whatever their types, and never to
    the plain versions."""
    seen = []
    kernel = census_cuda.census

    def record(name):
        return lambda *args: seen.append((name, args)) or args[0]

    for name in ("census", "census_cost_volume"):
        monkeypatch.setattr(census_cuda, name, record(name))
        monkeypatch.setattr(census, f"_{name}_plain", record(f"{name} plain"))
    for dtype in (torch.uint8, torch.float32, torch.float64, torch.int16):
        census.census(torch.zeros(2, 5, 6, dtype=dtype, device="meta"), "9x7")
    w2, w5 = (torch.zeros(5, 6, k, dtype=torch.int64, device="meta") for k in (2, 5))
    for words, sd, dtype in ((w2, -1, torch.bfloat16), (w2, 1, torch.float32),
                             (w2, 1, torch.float16), (w2, 2, torch.float32),
                             (w5, -1, torch.float32)):
        census.census_cost_volume(words, words, 3, sd, 64, dtype)
    assert [name for name, _ in seen] == ["census"] * 4 + ["census_cost_volume"] * 5
    assert seen[4][1][2:] == (3, -1, 64, torch.bfloat16)
    with pytest.raises(RuntimeError, match="sm_90"):
        kernel(torch.zeros(5, 6, dtype=torch.uint8, device="meta"))


def test_kernels_raise_on_the_types_and_sizes_they_do_not_take(library):
    """What the routers send the kernels and they do not take raises, with
    what they take named, and launches nothing."""
    for dtype in (torch.float64, torch.float16, torch.int16):
        with pytest.raises(TypeError, match="uint8"):
            census.census(torch.zeros(2, 5, 6, dtype=dtype, device="meta"), "9x7")
    w2, w5 = (torch.zeros(5, 6, k, dtype=torch.int64, device="meta") for k in (2, 5))
    for err, match, words, sd, dtype in ((TypeError, "bfloat16", w2, 1, torch.float16),
                                         (ValueError, "sd of -1 or \\+1", w2, 2, torch.float32),
                                         (ValueError, "1 to 4", w5, -1, torch.float32)):
        with pytest.raises(err, match=match):
            census.census_cost_volume(words, words, 3, sd, 64, dtype)
    assert library.calls == [] and census_cuda.launches == census_cuda.volume_launches == 0


class _Library:
    """Records the kernels' C entry calls by name; each returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("kt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def library(monkeypatch):
    """The wrappers on CPU tensors, launching into a recording stand-in."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(backend, "require_kernels", lambda t, op: None)
    monkeypatch.setattr(backend, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(census_cuda, "launches", 0)
    monkeypatch.setattr(census_cuda, "volume_launches", 0)
    return lib


@pytest.mark.parametrize("shape", [(7, 9), (3, 7, 9)])
@pytest.mark.parametrize("window,wid,K", [("9x7", 0, 2), ("11x11", 1, 4), ("16x16", 2, 4)])
def test_census_wrapper_passes_storage_sizes_and_window(library, shape, window, wid, K):
    for dtype, is_u8 in ((torch.uint8, 1), (torch.float32, 0)):
        img = torch.zeros(shape, dtype=dtype)
        out = census_cuda.census(img, window)
        assert out.shape == shape + (K,) and out.dtype == torch.int64
        (name, args) = library.calls[-1]
        assert len(args) == len(_build.SIGNATURES[name])
        B = shape[0] if len(shape) == 3 else 1
        assert name == "kt_census"
        assert args == (img.data_ptr(), is_u8, out.data_ptr(), B, 7, 9, wid, 0)
    assert census_cuda.launches == 2


@pytest.mark.parametrize("bits,inv", [(256, 1 / 256), (None, 1 / 64), (100, 0.01)])
def test_volume_wrapper_passes_storage_sizes_and_scale(library, bits, inv):
    left, right = torch.zeros(2, 5, 7, 2, dtype=torch.int64)
    vol = census_cuda.census_cost_volume(left, right, 6, 1, bits, torch.bfloat16)
    assert vol.shape == (6, 5, 7) and vol.dtype == torch.bfloat16
    ((name, args),) = library.calls
    assert name == "kt_census_volume" and len(args) == len(_build.SIGNATURES[name])
    assert args == (left.data_ptr(), right.data_ptr(), vol.data_ptr(), 1, 6, 5, 7, 2, 1, inv, 0)
    assert census_cuda.volume_launches == 1


def test_wrappers_refuse_bad_arguments_and_launch_nothing(library):
    img = torch.zeros(5, 7, dtype=torch.uint8)
    for err, arg, kw in [(TypeError, img.to(torch.int16), {}),
                         (ValueError, img[None, None], {}),
                         (ValueError, img.t(), {}),
                         (KeyError, img, {"window": "5x5"})]:
        with pytest.raises(err):
            census_cuda.census(arg, **kw)
    w = torch.zeros(5, 7, 4, dtype=torch.int64)
    for err, args in [(TypeError, (w.to(torch.int32), w, 3, -1, 256, torch.float32)),
                      (ValueError, (w, w[:, 1:].contiguous(), 3, -1, 256, torch.float32)),
                      (ValueError, (torch.zeros(5, 7, 5, dtype=torch.int64),) * 2
                       + (3, -1, 256, torch.float32)),
                      (TypeError, (w, w, 3, -1, 256, torch.float16)),
                      (ValueError, (w, w, 3, 0, 256, torch.float32)),
                      (ValueError, (w, w, 0, -1, 256, torch.float32))]:
        with pytest.raises(err):
            census_cuda.census_cost_volume(*args)
    assert library.calls == [] and census_cuda.launches == census_cuda.volume_launches == 0


def test_batched_frame_makes_one_census_call_a_side_and_is_unchanged(monkeypatch):
    """Two pairs that differ at their seams: one census call for the lefts
    and one for the rights, each frame equal to its own ``sgm_pipeline``."""
    lefts, rights = _stack(2, 20, 36, seed=1), _stack(2, 20, 36, seed=2)
    rights = torch.roll(lefts, -3, dims=2) // 2 + rights // 2
    cfg = stereo_sgm.SgmConfig(max_disp=8)
    calls = []
    orig = census.census
    monkeypatch.setattr(census, "census", lambda img, w: calls.append(img.shape) or orig(img, w))
    got = stereo_sgm.sgm_pipeline_batched(lefts, rights, cfg)
    assert calls == [lefts.shape, rights.shape]
    monkeypatch.undo()
    for k in range(2):
        want = stereo_sgm.sgm_pipeline(lefts[k], rights[k], cfg)
        assert torch.equal(got[k].isnan(), want.isnan())
        assert torch.equal(got[k].nan_to_num(), want.nan_to_num())
    assert float(got.isfinite().float().mean()) > 0.5
