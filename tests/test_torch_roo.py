"""The ``roo::`` namespace shim of kangaroo_tpu_torch against kangaroo_tpu's:
the same names, each bound to the function with the JAX target's module
path and name, and tests/test_roo_shim.py's representative calls run
through both shims on the same NumPy inputs from a seed.

Tolerances, those of each module's parity test: the filters, resampling
and conversions within 1e-5 relative and 1e-6 absolute
(test_torch_filters.py, test_torch_ops.py); the census volume and integer
WTA exactly, ``DenseStereoTest`` on >= 99.9 % of pixels and the subpixel
refinement within 1e-5 (test_torch_dense_stereo.py); the SDF and the
variational operators within 1e-6 (test_torch_fusion_exact.py,
test_torch_variational.py); the LSS fields within 1e-5 of the largest
entry (test_torch_refinement.py); the cross section exactly (one division).
"""
import ast
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
import kangaroo_tpu_torch as ktt
from kangaroo_tpu import roo as jroo
from kangaroo_tpu_torch import roo as troo

RTOL, ATOL = 1e-5, 1e-6
ROOT = Path(__file__).resolve().parent.parent


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else np.asarray(got),
                               np.asarray(want), rtol=rtol, atol=atol)


def both(*arrays):
    """Each NumPy array as a (JAX array, CPU tensor) pair."""
    return [(jnp.asarray(a), torch.from_numpy(np.array(a))) for a in arrays]


def _aliases(path):
    """{alias: (module, name)} of a shim's relative imports."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for a in node.names:
                out[a.asname or a.name] = (node.module, a.name)
    return out


def test_names_match_jax():
    assert set(troo.__all__) == set(jroo.__all__)
    assert len(troo.__all__) >= 70
    for name in troo.__all__:
        assert callable(getattr(troo, name)), name


def test_aliases_bind_the_same_module_path_and_name():
    want = _aliases(ROOT / "kangaroo_tpu" / "roo.py")
    got = _aliases(ROOT / "kangaroo_tpu_torch" / "roo.py")
    assert got == want
    for alias, (module, name) in got.items():
        fn = getattr(troo, alias)
        assert fn.__module__ == f"kangaroo_tpu_torch.{module}", alias
        assert fn.__name__ == name == getattr(jroo, alias).__name__, alias
    adapters = sorted(n for n in troo.__all__ if n not in got)
    assert adapters == sorted(n for n in jroo.__all__ if n not in want)
    for name in adapters:
        assert inspect.signature(getattr(troo, name)) == inspect.signature(getattr(jroo, name))


def test_filtering(rng):
    (jimg, timg), = both(rng.random((16, 24), np.float32))
    close(troo.GaussianBlur(timg, 2.0, rad=3), jroo.GaussianBlur(jimg, 2.0, rad=3))
    close(troo.GaussianBlur(timg, 2.0, rad=3), ktt.ops.blur.gaussian_blur(timg, 2.0, rad=3),
          rtol=0, atol=0)
    close(troo.MedianFilter3x3(timg), jroo.MedianFilter3x3(jimg))
    close(troo.ImageL1(timg), jroo.ImageL1(jimg))


def test_stereo_chain(rng):
    right = rng.random((16, 48)).astype(np.float32)
    (jl, tl), (jr, tr) = both(np.roll(right, 3, axis=1), right)
    jvol = jroo.CensusStereoVolume(jroo.Census(jl, window="9x7"), jroo.Census(jr, window="9x7"),
                                   max_disp=8)
    tvol = troo.CensusStereoVolume(troo.Census(tl, window="9x7"), troo.Census(tr, window="9x7"),
                                   max_disp=8)
    close(tvol.float(), jnp.asarray(jvol, jnp.float32), rtol=0, atol=0)
    disp = troo.CostVolMinimum(tvol)
    close(disp, jroo.CostVolMinimum(jvol), rtol=0, atol=0)
    assert np.median(disp.numpy()[:, 8:40]) == 3


def test_fusion_roundtrip():
    jvol = kt.TsdfVolume.create(16, 16, 16, kt.BoundingBox.create((-1.0,) * 3, (1.0,) * 3),
                                trunc_dist=0.5)
    tvol = ktt.TsdfVolume.create(16, 16, 16,
                                 ktt.BoundingBox.create((-1.0,) * 3, (1.0,) * 3, device="cpu"),
                                 trunc_dist=0.5)
    jvol = jroo.SdfSphere(jvol, jnp.zeros(3), 0.5)
    tvol = troo.SdfSphere(tvol, torch.zeros(3), 0.5)
    close(tvol.val, jvol.val, rtol=0)
    close(tvol.weight, jvol.weight, rtol=0)
    assert tvol.val[8, 8, 8] < 0 < tvol.val[0, 0, 0]


def test_variational_adjoint(rng):
    u = rng.random((12, 12)).astype(np.float32)
    p = rng.random((12, 12, 2)).astype(np.float32)
    p[:, -1, 0] = 0.0
    p[-1, :, 1] = 0.0
    (ju, tu), (jp, tp) = both(u, p)
    close(troo.GradU(tu), jroo.GradU(ju), rtol=0)
    close(troo.Divergence(tp), jroo.Divergence(jp), rtol=0)
    lhs = (troo.GradU(tu) * tp).sum()
    rhs = -(tu * troo.Divergence(tp)).sum()
    assert np.allclose(lhs, rhs, atol=1e-4)


def test_resample_and_convert(rng):
    (jimg, timg), = both(rng.random((16, 24), np.float32))
    close(troo.BoxHalf(timg), jroo.BoxHalf(jimg))
    close(troo.Resample(timg, 12, 8), jroo.Resample(jimg, 12, 8))
    for got, want in zip(troo.BoxReduce(timg, 3), jroo.BoxReduce(jimg, 3), strict=True):
        close(got, want)
    rgb = troo.ConvertImage(timg, "rgb")
    close(rgb, jroo.ConvertImage(jimg, "rgb"))
    close(troo.ConvertImage(rgb, "gray"), jroo.ConvertImage(jroo.ConvertImage(jimg, "rgb"), "gray"))
    u8 = troo.ConvertImage(timg, "uint8")
    assert u8.dtype == torch.uint8
    close(u8, jroo.ConvertImage(jimg, "uint8"), rtol=0, atol=0)
    assert troo.ConvertImage(u8, "float").dtype == torch.float32
    assert torch.equal(troo.ConvertImage(u8, "uint8"), u8)
    close(troo.ConvertImage(timg, "rgba"), jroo.ConvertImage(jimg, "rgba"))
    with pytest.raises(ValueError):
        troo.ConvertImage(timg, "hsv")


def test_cost_volume_cross_section(rng):
    n = np.array([[[2, 0]]], np.int32)
    s = np.array([[[510.0, 7.0]]], np.float32)
    (jn, tn), (js, ts) = both(n, s)
    out = troo.CostVolumeCrossSection((tn, ts), 0)
    close(out, jroo.CostVolumeCrossSection((jn, js), 0), rtol=0, atol=0)
    assert out[0, 0] == pytest.approx((510.0 / 2) / 255.0) and torch.isnan(out[0, 1])
    (jv, tv), = both(rng.random((4, 3, 5)).astype(np.float32))
    close(troo.CostVolumeCrossSection(tv, 1), jroo.CostVolumeCrossSection(jv, 1), rtol=0, atol=0)


def test_dense_stereo_wrappers(rng):
    right = rng.random((20, 40)).astype(np.float32)
    (jl, tl), (jr, tr) = both(np.roll(right, 3, axis=1), right)
    d = troo.DenseStereoTest(tl, tr, 6, rad=1).numpy()
    assert np.mean(d == np.asarray(jroo.DenseStereoTest(jl, jr, 6, rad=1))) >= 0.999
    inner = d[6:14, 12:32]
    assert np.median(inner[inner >= 0]) == 3
    ds = troo.DenseStereoSubpix(tl, tr, 6)
    want = np.asarray(jroo.DenseStereoSubpix(jl, jr, 6))
    close(ds, want, rtol=0, atol=1e-5)
    assert abs(np.nanmedian(ds.numpy()[6:14, 12:32]) - 3.0) < 0.05


def test_sum_speed_entry(rng):
    (jJ, tJ), (jy, ty) = both(rng.random((8, 8, 6), np.float32), rng.random((8, 8), np.float32))
    got, want = troo.SumSpeedTest(tJ, ty), jroo.SumSpeedTest(jJ, jy)
    for field in ("JTJ", "JTy", "sqErr", "obs"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        close(g, w, rtol=0, atol=1e-5 * max(float(np.abs(w).max()), 1.0))
    assert float(got.obs) == 64.0 and got.JTJ.shape == (6, 6)


def test_depth_tools():
    (jd, td), = both(np.full((4, 4), 2.0, np.float32))
    depth = troo.Disp2Depth(td, fu=100.0, baseline=0.1)
    close(depth, jroo.Disp2Depth(jd, fu=100.0, baseline=0.1), rtol=0, atol=0)
    assert np.allclose(depth.numpy(), 100.0 * 0.1 / 2.0)
