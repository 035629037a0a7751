"""The SGM frame: kangaroo_tpu_torch.apps.stereo_sgm.sgm_pipeline against
kangaroo_tpu's on 4- and 8-path configurations and with the guided and the
bilateral volume filters (the bilateral frame also on a mesh and as a
batch, equal to the port's single frames), plus the port's contracts: it
never imports JAX, the CPU path launches no kernel, a filtered volume
reaches the aggregation as float32, a mesh that is not the port's raises,
and the autograd op's backward is the plain version's gradient.

The frames are held to >= 99.5 % of pixels agreeing (both NaN, or within
1e-4 px): the SGM aggregates differ in the last bits (sum order), and the
port's LR check keeps the TPU kernel's sweep bound, which the JAX XLA twin
lacks, so a rare pixel may flip.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kangaroo_tpu.apps import stereo_sgm as jss
from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu_torch import _build
from kangaroo_tpu_torch.apps import stereo_sgm as tss
from kangaroo_tpu_torch.apps import synthetic as tsyn
from kangaroo_tpu_torch.ops import median_cuda
from kangaroo_tpu_torch.parallel.mesh import make_mesh
from kangaroo_tpu_torch.stereo import costvolume as tcv
from kangaroo_tpu_torch.stereo import dispatch, lr_cuda, sgm_cuda, wta_cuda

W, H, D = 96, 32, 16
REPO = Path(__file__).resolve().parents[1]


def _agreement(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    return float(((np.isnan(a) & np.isnan(b)) | (np.abs(a - b) <= tol)).mean())


def test_synthetic_pair_matches():
    for got, want in zip(tsyn.stereo_pair(W, H, D, seed=3, device="cpu"), jsyn.stereo_pair(W, H, D, seed=3)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("overrides", [dict(lr_from_left=True), dict(lr_from_left=False),
                                       dict(subpix=False, median_its=2),
                                       dict(do_diagonal=True),
                                       dict(do_diagonal=True, lr_from_left=False),
                                       dict(guided_filter=True, filter_rad=4, lr_from_left=False)])
def test_pipeline_matches_jax(overrides):
    jcfg = jss.SgmConfig(max_disp=D, **overrides)
    cfg = tss.SgmConfig.from_dict(dataclasses.asdict(jcfg))
    left, right, gt = jsyn.stereo_pair(W, H, D, seed=0)
    want = np.asarray(jax.jit(lambda a, b: jss.sgm_pipeline(a, b, jcfg))(left, right))
    got = tss.sgm_pipeline(torch.from_numpy(np.array(left)), torch.from_numpy(np.array(right)),
                           cfg)
    assert got.dtype == torch.float32 and got.shape == (H, W)
    assert _agreement(got.numpy(), want, 1e-4) >= 0.995
    # and the frame is a disparity map, not noise
    g = np.asarray(gt)
    ok = np.isfinite(got.numpy())
    assert ok.mean() > 0.8 and np.median(np.abs(got.numpy()[ok] - g[ok])) < 0.5


def test_config_from_dict_carries_every_field():
    jcfg = jss.SgmConfig(max_disp=32, census_window="9x7", p1=0.02, median_its=2,
                         lr_from_left=False)
    cfg = tss.SgmConfig.from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tss.SgmConfig()) == dataclasses.asdict(jss.SgmConfig())


@pytest.mark.parametrize("cfg,mesh,piece", [
    (tss.SgmConfig(), object(), "mesh"),
])
def test_unported_options_raise(cfg, mesh, piece):
    """Every SgmConfig option is ported; a mesh runs since the multi-device
    slice, but only a ``kangaroo_tpu_torch.parallel`` one."""
    left = torch.zeros(8, 16, dtype=torch.uint8)
    with pytest.raises(TypeError, match=piece):
        tss.sgm_pipeline(left, left, cfg, mesh=mesh)


# the bilateral frame at a small window (the JAX package's 1,369-tap
# default compiles for minutes on the CPU)
BW, BH, BD = 48, 16, 8
BILATERAL = dict(max_disp=BD, bilateral_filter=True, bilateral_size=3)


def _same_frame(a, b):
    return bool(((torch.isnan(a) & torch.isnan(b)) | (a == b)).all())


@pytest.mark.parametrize("lr_from_left", [True, False])
def test_bilateral_frame_matches_jax(lr_from_left):
    jcfg = jss.SgmConfig(lr_from_left=lr_from_left, **BILATERAL)
    cfg = tss.SgmConfig.from_dict(dataclasses.asdict(jcfg))
    left, right, gt = jsyn.stereo_pair(BW, BH, BD, seed=0)
    want = np.asarray(jax.jit(lambda a, b: jss.sgm_pipeline(a, b, jcfg))(left, right))
    got = tss.sgm_pipeline(torch.from_numpy(np.array(left)), torch.from_numpy(np.array(right)),
                           cfg)
    assert got.dtype == torch.float32 and got.shape == (BH, BW)
    assert _agreement(got.numpy(), want, 1e-4) >= 0.995
    g = np.asarray(gt)
    ok = np.isfinite(got.numpy())
    assert ok.mean() > 0.8 and np.median(np.abs(got.numpy()[ok] - g[ok])) < 0.5


def test_filtered_volume_reaches_the_aggregation_as_float32(monkeypatch):
    """Either filter keeps the cost volume float32 (their arithmetic is not
    exact in bfloat16); the unfiltered 16x16 census volume is bfloat16."""
    seen = []
    aggregate = dispatch.semi_global_matching

    def recording(vol, *args, **kwargs):
        seen.append(vol.dtype)
        return aggregate(vol, *args, **kwargs)

    monkeypatch.setattr(dispatch, "semi_global_matching", recording)
    left, right, _ = tsyn.stereo_pair(BW, BH, BD, seed=1, device="cpu")
    for overrides in (dict(bilateral_filter=True, bilateral_size=1),
                      dict(guided_filter=True, filter_rad=2), {}):
        tss.sgm_pipeline(left, right, tss.SgmConfig(max_disp=BD, **overrides))
    assert seen == [torch.float32, torch.float32, torch.bfloat16]


def test_bilateral_frame_on_a_mesh_and_as_a_batch():
    """The filtered frame on a 4-shard CPU mesh (the volume is filtered
    before the sharded aggregation) and a batch of 2 (frame by frame) equal
    the port's single frames."""
    cfg = tss.SgmConfig(**BILATERAL)
    pairs = [tsyn.stereo_pair(BW, BH, BD, seed=k, device="cpu") for k in range(2)]
    frames = [tss.sgm_pipeline(l, r, cfg) for l, r, _ in pairs]
    meshed = tss.sgm_pipeline(pairs[0][0], pairs[0][1], cfg,
                              mesh=make_mesh(devices=["cpu"] * 4))
    assert meshed.shape == (BH, BW) and _same_frame(meshed, frames[0])
    batch = tss.sgm_pipeline_batched(torch.stack([p[0] for p in pairs]),
                                     torch.stack([p[1] for p in pairs]), cfg)
    assert batch.shape == (2, BH, BW)
    assert all(_same_frame(batch[k], frames[k]) for k in range(2))


def test_cpu_path_launches_no_kernel():
    mods = (sgm_cuda, wta_cuda, median_cuda, lr_cuda)

    def counts():
        return [m.launches for m in mods] + [sgm_cuda.diagonal_launches,
                                             sgm_cuda.segment_launches,
                                             sgm_cuda.diag_segment_launches]

    before = counts()
    left, right, _ = tsyn.stereo_pair(48, 16, 8, seed=1, device="cpu")
    mesh = make_mesh(devices=["cpu"] * 4)
    for diagonal in (False, True):
        cfg = tss.SgmConfig(max_disp=8, do_diagonal=diagonal)
        tss.sgm_pipeline(left, right, cfg)
        tss.sgm_pipeline(left, right, cfg, mesh=mesh)
    tss.sgm_pipeline_batched(torch.stack([left, right]), torch.stack([right, left]),
                             tss.SgmConfig(max_disp=8))
    assert counts() == before


def test_port_imports_no_jax():
    """Every module of the port imports, and a tiny 4- and 8-path frame
    (single-device and on a virtual mesh), a bilateral-filtered frame,
    BASELINE config 1's filters and a few other ops, a stacked batch, the
    three variational solves, a cold and an incremental DTAM frame, a
    coarse_init frame, the multi-view accumulation and solves, two
    Stereo2App frames, census and dense stereo and two KinectFusion frames
    run, with JAX and the JAX package made unimportable."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["kangaroo_tpu"] = None
        import kangaroo_tpu_torch
        names = {m.name for m in pkgutil.walk_packages(kangaroo_tpu_torch.__path__,
                                                       "kangaroo_tpu_torch.")}
        for name in sorted(names):
            importlib.import_module(name)
        # the filters-and-ops slice's modules among them
        assert {f"kangaroo_tpu_torch.{m}" for m in (
            "core.invalid", "core.sampling", "containers.pyramid", "ops.bilateral", "ops.blur",
            "ops.convert", "ops.elementwise", "ops.features", "ops.integral_image",
            "ops.median", "ops.resample", "ops.viz", "ops.warp")} <= names
        # and the stereo apps' remaining modules
        assert {f"kangaroo_tpu_torch.{m}" for m in (
            "core.patch_score", "stereo.dense_stereo", "geometry.heightmap", "io.pxm",
            "solvers.plane_fit")} <= names
        from kangaroo_tpu_torch.apps import stereo, stereo_sgm, synthetic
        from kangaroo_tpu_torch.variational import deconvolution, rof, tgv
        left, right, gt = synthetic.stereo_pair(48, 16, 8, seed=0, device="cpu")
        from kangaroo_tpu_torch.parallel.mesh import make_mesh
        import torch
        for diagonal in (False, True):
            cfg = stereo_sgm.SgmConfig(max_disp=8, do_diagonal=diagonal)
            disp = stereo_sgm.sgm_pipeline(left, right, cfg)
            assert disp.shape == (16, 48)
            mesh = make_mesh(devices=["cpu"] * 4)
            assert stereo_sgm.sgm_pipeline(left, right, cfg, mesh=mesh).shape == (16, 48)
        bcfg = stereo_sgm.SgmConfig(max_disp=8, bilateral_filter=True, bilateral_size=2)
        assert stereo_sgm.sgm_pipeline(left, right, bcfg).shape == (16, 48)
        from kangaroo_tpu_torch.containers import pyramid
        from kangaroo_tpu_torch.ops import bilateral, blur, features, viz, warp
        assert blur.gaussian_blur(left, 2.0, rad=10).dtype == torch.uint8
        assert bilateral.bilateral(left.float() / 255.0, 2.0, 0.1, 5).shape == (16, 48)
        assert [p.shape for p in pyramid.blur_reduce(left, 3)][-1] == (4, 12)
        lut = warp.create_matlab_lookup_table(48, 16, 40.0, 40.0, 24.0, 8.0, -0.2, 0.05,
                                              device="cpu")
        assert warp.warp(left, lut).dtype == torch.uint8
        assert features.segment_test(left, 20).shape == (16, 48)
        assert viz.make_anaglyph(left, right).shape == (16, 48, 4)
        batch = stereo_sgm.sgm_pipeline_batched(torch.stack([left, left]),
                                                torch.stack([right, right]),
                                                stereo_sgm.SgmConfig(max_disp=8))
        assert batch.shape == (2, 16, 48)
        img = left.float() / 255.0
        for out in (rof.denoise(img, 8.0, iterations=3), tgv.denoise(img, iterations=3),
                    deconvolution.inpaint(img, (img > 0.5).float(), iterations=3)):
            assert out.shape == (16, 48)
        dcfg = stereo.StereoConfig(max_disp=8, census_window="9x7", dtam_iterations=3)
        assert stereo.stereo_pipeline(left, right, dcfg).shape == (16, 48)
        assert stereo.VariationalStereo(dcfg, 2).process_frame(left, right).shape == (16, 48)
        import dataclasses
        ccfg = dataclasses.replace(dcfg, max_disp=16, coarse_init=True, coarse_iterations=2)
        assert stereo.stereo_pipeline(left, right, ccfg).shape == (16, 48)
        from kangaroo_tpu_torch.containers import Intrinsics
        from kangaroo_tpu_torch.core import se3
        key, _, track = synthetic.multiview_track(48, 16, 8, device="cpu")
        mvs = stereo.MultiViewStereo(Intrinsics.centered(40.0, 48, 16), 0.1, dcfg)
        mvs.reset(key.float(), se3.identity(device="cpu"), right=track[-1][0].float())
        for img, T_wc in track:
            mvs.add(img.float(), T_wc)
        assert mvs.solve().shape == mvs.solve(use_dtam=False).shape == (16, 48)
        app = stereo_sgm.Stereo2App(Intrinsics.centered(40.0, 48, 16), 0.2,
                                    stereo_sgm.SgmConfig(max_disp=8, census_window="9x7"),
                                    hm_size=(2.0, 2.0))
        for _ in range(2):
            assert app(left, right, image=left)[1].shape == (16, 48, 4)
        from kangaroo_tpu_torch.stereo import census, dense_stereo
        cl, cr = census.census9x7(left), census.census9x7(right)
        assert census.census_stereo(cl, cr, 8).shape == (16, 48)
        assert dense_stereo.dense_stereo(left, right, 8).shape == (16, 48)
        import torch
        from kangaroo_tpu_torch.apps import kinectfusion as kf
        from kangaroo_tpu_torch.containers import Intrinsics
        K = Intrinsics.centered(30.0, 32, 24)
        kcfg = kf.KinectFusionConfig(w=32, h=24, vol_res=16, vol_extent=1.2, max_levels=2,
                                     its=(1, 1), near=0.5, far=6.0, max_rmse=0.3)
        pipe = kf.KinectFusion(K, kcfg, device="cpu")
        frames = list(synthetic.depth_sequence(2, K, 32, 24, step=0.02, device="cpu",
                                               scene=synthetic.sphere_scene(24, device="cpu")))
        pipe.T_wl = frames[0][0]
        for _, depth in frames:
            pose = pipe.process_frame(torch.nan_to_num(depth, 0.0))
        assert pose.shape == (3, 4) and bool(pipe.vol.weight.max() > 0)
        assert not any(k == "jax" or k.startswith(("jax.", "jaxlib"))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_kernel_op_backward_is_the_plain_gradient():
    """_KernelOp's forward takes the kernel's output as it is; its backward
    replays the plain version under autograd. A stand-in kernel that returns
    the plain output detached shows the plumbing on the CPU."""
    rng = np.random.default_rng(0)
    dl = torch.from_numpy(rng.uniform(0, 8, (6, 24)).astype(np.float32))
    dr = dl + torch.from_numpy(rng.normal(0, 0.7, (6, 24)).astype(np.float32))
    kw = dict(sd=-1, max_diff=1.0, max_disp=8)

    def stand_in(a, b, **k):
        return tcv.left_right_check(a, b, **k).detach()

    grads = []
    for run in (lambda a, b: dispatch._KernelOp.apply(stand_in, tcv.left_right_check, kw, a, b),
                lambda a, b: tcv.left_right_check(a, b, **kw)):
        a, b = dl.clone().requires_grad_(True), dr.clone().requires_grad_(True)
        out = run(a, b)
        out.nan_to_num(0.0).sum().backward()
        grads.append((a.grad, b.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0])
    assert grads[0][0].abs().sum() > 0
    assert grads[0][1] is None or not grads[0][1].any()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler, no kernels: the build raises instead of falling back."""
    import torch.utils.cpp_extension

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._compile()

