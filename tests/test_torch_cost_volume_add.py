"""The routing and argument marshalling of the running-mean view update
(``stereo.costvolume.cost_volume_add``, ``stereo/costvolume_cuda.py``) on
the CPU: a CPU tensor runs the plain version and launches nothing; any other
tensor goes to the kernel through ``dispatch._KernelOp`` and never to the
plain version, raising off the card; the wrapper's C call, checked through
a stand-in for the kernels' library that records it, takes the tensors'
storage, the sizes, and the scalars rounded to float32 as the plain version
rounds them; its gradient is the plain version's. The kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); ``test_torch_stereo_apps.py`` holds the plain version
against the JAX package.
"""
import contextlib

import numpy as np
import pytest
import torch

from kangaroo_tpu_torch import _build, backend
from kangaroo_tpu_torch.containers import Intrinsics
from kangaroo_tpu_torch.stereo import costvolume, costvolume_cuda, dispatch
from kangaroo_tpu_torch.utils import profiling

D, H, W = 6, 18, 24
# a view 0.1 m along the baseline, as ``MultiViewStereo.add`` forms KT_cv
K = Intrinsics.centered(0.9 * W, W, H)
KT = K.matrix(device="cpu") @ torch.tensor([[1.0, 0, 0, -0.1], [0, 1, 0, 0], [0, 0, 1, 0]])


def _inputs(seed=0, dtype=torch.uint8):
    rng = np.random.default_rng(seed)
    n = torch.from_numpy(rng.integers(0, 3, (D, H, W)).astype(np.float32))
    s = n * torch.from_numpy(rng.uniform(0, 50, (D, H, W)).astype(np.float32))
    img_v, img_c = (torch.from_numpy(rng.uniform(0, 255, (H, W)).astype(np.float32)).to(dtype)
                    for _ in range(2))
    return n, s, img_v, img_c


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
    """The wrapper on CPU tensors, launching into a recording stand-in."""
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(backend, "require_kernels", lambda t, op: None)
    monkeypatch.setattr(backend, "stream_handle", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(costvolume_cuda, "launches", 0)
    return lib


def _call(args):
    """A kt_cost_volume_add call's arguments by name (_build.SIGNATURES
    order)."""
    names = ("n", "s", "img_v", "img_c", "M", "n_out", "s_out", "D", "H", "W", "rad", "fu", "fv",
             "u0", "v0", "baseline", "tiny", "stream")
    assert len(args) == len(names) == len(_build.SIGNATURES["kt_cost_volume_add"])
    return dict(zip(names, args))


@pytest.mark.parametrize("rad", [1, 2])
def test_cpu_tensors_run_the_plain_version_and_launch_nothing(rad):
    n, s, img_v, img_c = _inputs(rad)
    before = profiling.counts()["cost_volume_add"]
    got = costvolume.cost_volume_add(n, s, img_v, img_c, KT, K, 0.1, rad=rad)
    want = costvolume._cost_volume_add_plain(n, s, img_v, img_c, KT, K, 0.1, rad=rad)
    assert all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))
    assert float((got[0] - n).mean()) > 0.2
    assert profiling.counts()["cost_volume_add"] == before


def test_other_devices_take_the_kernel_and_never_the_plain_version(monkeypatch):
    """A tensor off the CPU goes through ``_KernelOp`` to the wrapper with
    the keyword arguments; off the card the wrapper raises."""
    seen = []

    def kernel(*args, **kwargs):
        seen.append((args, kwargs))
        return args[0] + 1, args[1]

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a tensor off the CPU")

    meta = [t.to("meta") for t in _inputs()] + [KT.to("meta")]
    with monkeypatch.context() as mp:
        mp.setattr(costvolume_cuda, "cost_volume_add", kernel)
        mp.setattr(costvolume, "_cost_volume_add_plain", plain)
        n2, s2 = costvolume.cost_volume_add(*meta, K, 0.1, rad=2)
    ((args, kwargs),) = seen
    assert args == tuple(meta) and kwargs == {"K": K, "baseline": 0.1, "rad": 2}
    assert n2.shape == s2.shape == (D, H, W) and n2.device.type == "meta"
    with pytest.raises(RuntimeError, match="sm_90"):
        costvolume.cost_volume_add(*meta, K, 0.1)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.float64])
def test_wrapper_passes_storage_sizes_and_float32_scalars(library, dtype):
    n, s, img_v, img_c = _inputs(3, dtype)
    K_odd = Intrinsics(fu=531.1234567, fv=530.9876543, u0=319.7654321, v0=239.1234567)
    n2, s2 = costvolume_cuda.cost_volume_add(n, s, img_v, img_c, KT, K_odd, 0.123456789, 2)
    (name, args), = library.calls
    c = _call(args)
    assert name == "kt_cost_volume_add" and costvolume_cuda.launches == 1
    assert (c["n"], c["s"], c["M"]) == (n.data_ptr(), s.data_ptr(), KT.data_ptr())
    assert (c["n_out"], c["s_out"]) == (n2.data_ptr(), s2.data_ptr())
    assert n2.shape == s2.shape == (D, H, W) and n2.dtype == s2.dtype == torch.float32
    # float32 images are passed as they are; others as their float32 cast
    assert (c["img_v"] == img_v.data_ptr()) == (dtype == torch.float32)
    assert (c["D"], c["H"], c["W"], c["rad"], c["stream"]) == (D, H, W, 2, 0)
    want = backend.f32_scalars("cpu", K_odd.fu, K_odd.fv, K_odd.u0, K_odd.v0, 0.123456789, 1e-9)
    got = [c[k] for k in ("fu", "fv", "u0", "v0", "baseline", "tiny")]
    assert got == [float(w) for w in want]


def test_wrapper_casts_a_double_projection_on_the_device(library):
    n, s, img_v, img_c = _inputs(4)
    costvolume_cuda.cost_volume_add(n, s, img_v, img_c, KT.double(), K, 0.1)
    (_, args), = library.calls
    assert _call(args)["M"] != KT.data_ptr()


def test_wrapper_refuses_bad_arguments_and_launches_nothing(library):
    n, s, img_v, img_c = _inputs(5)
    bad = [(TypeError, (n.double(), s, img_v, img_c, KT), {}),
           (TypeError, (n, s, img_v.to(torch.int32), img_c, KT), {}),
           (ValueError, (n, s[:, 1:].contiguous(), img_v, img_c, KT), {}),
           (ValueError, (n, s, img_v, img_c[:, 1:].contiguous(), KT), {}),
           (ValueError, (torch.zeros(D, W, H).transpose(1, 2), s, img_v, img_c, KT), {}),
           (ValueError, (n, s, img_v.t().contiguous().t(), img_c, KT), {}),
           (ValueError, (n, s, img_v, img_c, KT[:, :3]), {}),
           (ValueError, (n, s, img_v, img_c, KT.to(torch.int64)), {}),
           (ValueError, (n, s, img_v, img_c, KT), {"rad": -1})]
    for err, args, kw in bad:
        with pytest.raises(err):
            costvolume_cuda.cost_volume_add(*args, K, 0.1, **kw)
    assert library.calls == [] and costvolume_cuda.launches == 0


def test_kernel_op_backward_is_the_plain_gradient():
    """``_KernelOp`` over a stand-in kernel that returns the plain output:
    the gradients of s and KT_cv through it equal the plain version's own."""
    n, s, img_v, img_c = _inputs(6)
    w = torch.from_numpy(np.random.default_rng(7).normal(size=(D, H, W)).astype(np.float32))
    kw = dict(K=K, baseline=0.1, rad=1)

    def stand_in(*args, **kwargs):
        return costvolume._cost_volume_add_plain(*args, **kwargs)

    grads = []
    for run in (lambda *a: dispatch._KernelOp.apply(stand_in, costvolume._cost_volume_add_plain,
                                                   kw, *a),
                lambda *a: costvolume._cost_volume_add_plain(*a, **kw)):
        xs = [s.clone().requires_grad_(True), KT.clone().requires_grad_(True)]
        _, s2 = run(n, xs[0], img_v, img_c, xs[1])
        (s2 * w).sum().backward()
        grads.append([x.grad for x in xs])
    for g_op, g_plain in zip(*grads):
        assert g_op is not None and torch.equal(g_op, g_plain)
    assert float(grads[0][1].abs().max()) > 0
