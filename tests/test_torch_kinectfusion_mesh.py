"""The model-parallel KinectFusion frame (``KinectFusion(mesh=)``) and
``stereo_pipeline(mesh=)`` against kangaroo_tpu's, on a virtual 8-shard
CPU mesh (``make_mesh(devices=["cpu"] * 8)``) against the JAX package's
8-device CPU mesh, on tests/test_parallel.py's cases: the orbit of a 48^3
volume with 64x48 depth (``raycast_downsample=True``), mono and colour, as
a frame loop of 4 frames and as ``run_sequence`` of the first 3, and the
48x24/16 DTAM frame. Each JAX mesh run is made once, in a module-scoped fixture.

Tolerances. Poses within 0.06 of the true poses and within 0.02 of the JAX
package's mesh app, the frame loop's last pose within 0.02 of the port's
single-device app's (tests/test_parallel.py's own bounds; the JAX
package's mesh and single-device apps are 0.021 apart at frame 2 and 0.017
at frame 3). Not tighter against the JAX package: the first plane of a
slab (k = 0, where the plane scales are exactly 1 and 0) updates voxels
that the JAX package's compiled scan drops. Its jit rounds one step of the
lerp positions otherwise than its own eager ops, which the port follows,
and a tap on the invalid-depth sentinel then gets a weight above the 1e-6
snap: 15 of 570 voxels of a 24-plane slab on the orbit's frame 0 (the
single-device frames, whose first plane lies outside the view, agree to
4e-7). The loop's share of updated voxels within 2 % of the JAX package's; the
port's sequence replay equal to its frame loop; the colour volume's median
within 0.2 of the fused grey (tests/test_parallel.py).
The DTAM frame: >= 99 % of pixels both NaN or within 1e-4 px of the JAX
package's mesh frame (test_torch_dtam.py's pipeline bound), and every pixel
within 1e-4 px of the port's single-device frame (tests/test_parallel.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.apps import kinectfusion as jkf
from kangaroo_tpu.apps import stereo as jst
from kangaroo_tpu.apps import synthetic as jsyn
from kangaroo_tpu.parallel import mesh as jmesh
from kangaroo_tpu_torch.apps import kinectfusion as tkf
from kangaroo_tpu_torch.apps import stereo as tst
from kangaroo_tpu_torch.containers import Intrinsics
from kangaroo_tpu_torch.fusion import rolling
from kangaroo_tpu_torch.fusion import separable_cuda
from kangaroo_tpu_torch.parallel import mesh as tmesh
from kangaroo_tpu_torch.parallel import sharding as tsh

W, H = 64, 48
GREY = 180.0


def _config(**overrides):
    jcfg = jkf.KinectFusionConfig(w=W, h=H, vol_res=48, vol_extent=1.2, max_levels=2, its=(2, 2),
                                  near=0.5, far=6.0, max_rmse=0.3, bilateral_minval=0.2,
                                  raycast_downsample=True, **overrides)
    return jcfg, tkf.KinectFusionConfig.from_dict(dataclasses.asdict(jcfg))


COLOUR = dict(use_colour=True, rgb_focal=55.0, rgb_baseline_m=0.0)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def orbit():
    """(K, frames as (T_wc, depth) NumPy pairs with sensor-style zeros)."""
    K = kt.Intrinsics.centered(55.0, W, H)
    frames = jsyn.depth_sequence(4, K, W, H, scene=jsyn.sphere_scene(res=64), step=0.015)
    return K, [(np.asarray(T), np.asarray(jnp.where(jnp.isfinite(d), d, 0.0))) for T, d in frames]


@pytest.fixture(scope="module")
def jax_runs(orbit):
    """The JAX package's mesh app's frame loop on the orbit: {colour: (poses,
    app)}. The port's sequence replay is held to its first 3 poses: the
    port's replay equals its loop (test_mesh_sequence_equals_the_loop), and
    the JAX package's replay its loop (tests/test_parallel.py), whose scan
    takes another 13 s a config to build."""
    K, frames = orbit
    jax_mesh = jmesh.make_mesh(8)
    out = {}
    for colour in (False, True):
        jcfg, _ = _config(**(COLOUR if colour else {}))
        rgb = jnp.full((H, W, 3), GREY) if colour else None
        app = jkf.KinectFusion(K, jcfg, mesh=jax_mesh)
        app.T_wl = jnp.asarray(frames[0][0])
        out[colour] = (np.stack([np.asarray(app.process_frame(jnp.asarray(d), rgb=rgb))
                                 for _, d in frames]), app)
    return out


def _port(K, cfg, T0, mesh=None):
    pipe = tkf.KinectFusion(Intrinsics.create(float(K.fu), float(K.fv), float(K.u0),
                                              float(K.v0)), cfg, mesh=mesh, device="cpu")
    pipe.T_wl = torch.from_numpy(T0.copy())
    return pipe


def _run(pipe, frames, run, colour):
    """The frame loop over ``frames``, or the sequence replay of the first 3."""
    rgb = torch.full((H, W, 3), GREY) if colour else None
    depths = [torch.from_numpy(d.copy()) for _, d in frames]
    if run == "loop":
        return torch.stack([pipe.process_frame(d, rgb=rgb) for d in depths])
    return pipe.run_sequence(torch.stack(depths[:3]),
                             rgbs=torch.stack([rgb] * 3) if colour else None)[0]


@pytest.mark.parametrize("colour", [False, True], ids=["mono", "colour"])
@pytest.mark.parametrize("run", ["loop", "sequence"])
def test_mesh_app_matches_jax(orbit, mesh, jax_runs, run, colour):
    K, frames = orbit
    _, cfg = _config(**(COLOUR if colour else {}))
    pipe = _port(K, cfg, frames[0][0], mesh)
    poses = _run(pipe, frames, run, colour)
    want, japp = jax_runs[colour]
    np.testing.assert_allclose(poses.numpy(), want[:len(poses)], atol=0.02, rtol=0)
    assert pipe.tracking_good and pipe.frame == len(poses)
    assert np.abs(poses[-1].numpy() - frames[len(poses) - 1][0]).max() < 0.06
    assert isinstance(pipe._vol, tsh.ZSlabs) and len(pipe._vol.val) == 8
    touched = pipe.vol.weight.numpy() > 0
    if run == "loop":
        want_touched = int((np.asarray(japp.vol.weight) > 0).sum())
        assert abs(int(touched.sum()) - want_touched) <= 0.02 * want_touched
    if colour:
        assert abs(np.median(pipe.color_vol.data.numpy()[touched]) - GREY / 255.0) < 0.2
    if run == "loop":  # tests/test_parallel.py's bound against the single-device app
        single = _run(_port(K, cfg, frames[0][0]), frames, run, colour)
        np.testing.assert_allclose(poses[-1].numpy(), single[-1].numpy(), atol=0.02, rtol=0)


def test_mesh_sequence_equals_the_loop(orbit, mesh):
    K, frames = orbit
    _, cfg = _config()
    loop = _port(K, cfg, frames[0][0], mesh)
    seq = _port(K, cfg, frames[0][0], mesh)
    assert torch.equal(_run(seq, frames, "sequence", False),
                       _run(loop, frames[:3], "loop", False))
    assert seq._seq_axis == 0
    assert torch.equal(seq.vol.val.nan_to_num(7.0), loop.vol.val.nan_to_num(7.0))


def test_mesh_app_volume_methods(orbit, mesh, tmp_path):
    """render, save and load, reset, the moving workspace's roll and the
    JAX package's state through ``vol``'s gather and re-shard."""
    K, frames = orbit
    _, cfg = _config()
    pipe = _port(K, cfg, frames[0][0], mesh)
    _run(pipe, frames[:2], "loop", False)
    whole = pipe.vol
    single = _port(K, cfg, frames[0][0])
    single.vol, single.T_wl = whole, pipe.T_wl.clone()
    for a, b in zip(pipe.render(), single.render()):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    path = str(tmp_path / "mesh.vol")
    pipe.save_volume(path)
    other = _port(K, cfg, frames[0][0], mesh)
    other.load_volume(path)
    assert isinstance(other._vol, tsh.ZSlabs)
    assert torch.equal(other.vol.val.nan_to_num(7.0), whole.val.nan_to_num(7.0))
    tris = pipe.save_mesh(str(tmp_path / "mesh.ply"))
    assert len(tris) == len(single.save_mesh(str(tmp_path / "single.ply"))) > 100
    # the moving workspace: a roll of the gathered volume, cut again
    rolled = _port(K, dataclasses.replace(cfg, moving_threshold_voxels=1, moving_lead_m=1.0),
                   frames[0][0], mesh)
    rolled.vol, rolled.T_wl, rolled.frame = whole, pipe.T_wl.clone(), 2
    shift = rolling.recenter_shift(whole, rolled.T_wl, lead=1.0, threshold_voxels=1)
    assert shift != (0, 0, 0)
    rolled._maybe_roll()
    want = rolling.roll_volume(whole, shift)
    assert isinstance(rolled._vol, tsh.ZSlabs)
    assert torch.equal(rolled.vol.weight, want.weight)
    assert torch.equal(rolled.vol.bbox.lo, want.bbox.lo)
    pipe.reset()
    assert isinstance(pipe._vol, tsh.ZSlabs) and float(pipe.vol.weight.max()) == 0.0
    # the JAX package's state, carried over and sharded
    vol, T = tkf.state_from_numpy(whole.val.numpy(), whole.weight.numpy(),
                                  whole.bbox.lo.numpy(), whole.bbox.hi.numpy(),
                                  pipe.T_wl.numpy(), device="cpu")
    pipe.vol = tsh.shard_volume_z(vol, mesh)
    assert torch.equal(pipe.vol.weight, whole.weight)


@pytest.mark.parametrize("overrides,error", [
    (dict(raycast_downsample=False), ValueError),
    (dict(engine="guided"), ValueError),
    (dict(vol_res=44), ValueError),
])
def test_mesh_config_errors(mesh, overrides, error):
    _, cfg = _config()
    cfg = dataclasses.replace(cfg, **overrides)
    with pytest.raises(error):
        tkf.KinectFusion(Intrinsics.centered(55.0, W, H), cfg, mesh=mesh, device="cpu")
    with pytest.raises(error):
        tkf.make_frame_step(Intrinsics.centered(55.0, W, H), cfg, None, 0.1, mesh=mesh)


def test_mesh_device_and_type_errors(mesh):
    _, cfg = _config()
    K = Intrinsics.centered(55.0, W, H)
    assert tkf.KinectFusion(K, cfg, mesh=mesh).device == torch.device("cpu")
    with pytest.raises(ValueError):
        tkf.KinectFusion(K, cfg, mesh=mesh, device="meta")
    with pytest.raises(TypeError):
        tkf.KinectFusion(K, cfg, mesh=object(), device="cpu")


def test_mesh_frame_launches_no_kernel_on_the_cpu(orbit, mesh):
    K, frames = orbit
    _, cfg = _config()
    before = separable_cuda.launches
    _run(_port(K, cfg, frames[0][0], mesh), frames[:2], "loop", False)
    assert separable_cuda.launches == before


def test_stereo_pipeline_mesh_matches_jax(mesh):
    """tests/test_parallel.py's app case: 48x24/16, 8 DTAM iterations."""
    left, right, _ = jsyn.stereo_pair(48, 24, 16, seed=2)
    jcfg = jst.StereoConfig(max_disp=16, census_window="9x7", dtam_iterations=8,
                            lr_check=False, median_its=1)
    cfg = tst.StereoConfig.from_dict(dataclasses.asdict(jcfg))
    jax_mesh = jmesh.make_mesh(8)
    want = np.asarray(jax.jit(lambda l, r: jst.stereo_pipeline(l, r, jcfg, mesh=jax_mesh))(
        left, right))
    tl, tr = (torch.from_numpy(np.array(a)) for a in (left, right))
    got = tst.stereo_pipeline(tl, tr, cfg, mesh=mesh).numpy()
    close = (np.isnan(want) & np.isnan(got)) | (np.abs(want - got) <= 1e-4)
    assert close.mean() >= 0.99
    single = tst.stereo_pipeline(tl, tr, cfg).numpy()
    assert ((np.isnan(single) & np.isnan(got)) | (np.abs(single - got) <= 1e-4)).all()
