"""The host side of kangaroo_tpu_torch against kangaroo_tpu's on the CPU:
the threaded frame loader (``io/frame_loader.py`` with its C++ core), the
camera rig files (``io/rig.py``) and the tracker-pose streams
(``io/tracker.py``), on seeded inputs.

Tolerances. Frames and indices equal (both loaders decode the same bytes;
16-bit files to native-endian uint16); rig matrices, poses and files
exactly equal (the same float64 NumPy, the JSON byte for byte); the port's
``intrinsics()`` equal to the JAX package's fields rounded to float32,
and ``depth_and_cloud`` with a rig's K equal in both packages. The
tracker: ``cart2t`` exact, poses within 1e-6 (the JAX package composes the
offset with XLA's float32 matmul, the port with NumPy's).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kangaroo_tpu.apps import stereo as jstereo
from kangaroo_tpu.io import frame_loader as jfl
from kangaroo_tpu.io import rig as jrig
from kangaroo_tpu.io import tracker as jtrk
from kangaroo_tpu_torch import _build
from kangaroo_tpu_torch.apps import stereo as tstereo
from kangaroo_tpu_torch.io import frame_loader as tfl
from kangaroo_tpu_torch.io import pxm
from kangaroo_tpu_torch.io import rig as trig
from kangaroo_tpu_torch.io import tracker as ttrk

POSE_TOL = 1e-6


@pytest.fixture
def sequence(tmp_path):
    """Eleven PXM files (8-bit and 16-bit, grey and rgb, of varied sizes)
    from a seed, with a missing file at index 4 and a truncated one at 8:
    (paths, the frames by index, the unreadable indices)."""
    rng = np.random.default_rng(0)
    entries = []
    for i in range(11):
        shape = [(12, 16), (9, 7), (12, 16, 3), (5, 4, 3)][i % 4]
        dtype = np.uint16 if i % 3 == 1 else np.uint8
        img = rng.integers(0, np.iinfo(dtype).max, size=shape, endpoint=True).astype(dtype)
        p = str(tmp_path / f"frame_{i:03d}.{'pgm' if img.ndim == 2 else 'ppm'}")
        pxm.save_pxm(p, img)
        entries.append((p, img))
    truncated = str(tmp_path / "truncated.pgm")
    pxm.save_pxm(truncated, np.zeros((8, 8), np.uint16))
    with open(truncated, "r+b") as f:
        f.truncate(40)
    entries.insert(4, (str(tmp_path / "missing.pgm"), None))
    entries.insert(8, (truncated, None))
    frames = {j: img for j, (_, img) in enumerate(entries) if img is not None}
    return [p for p, _ in entries], frames, (4, 8)


def _equal_frames(got, want):
    assert sorted(got) == sorted(want)
    for i, img in want.items():
        assert got[i].dtype == img.dtype and got[i].shape == img.shape, i
        np.testing.assert_array_equal(got[i], img)


def test_loader_ordered_matches_jax(sequence):
    paths, frames, _ = sequence
    got = list(tfl.FrameLoader(paths, n_threads=1))
    want = list(jfl.FrameLoader(paths, n_threads=1, use_native=True))
    assert [i for i, _ in got] == [i for i, _ in want] == sorted(frames)
    _equal_frames(dict(got), dict(want))
    _equal_frames(dict(got), frames)
    assert dict(got)[1].dtype == np.uint16 and dict(got)[1].dtype.byteorder == "="


def test_loader_threads_match_jax(sequence):
    paths, frames, _ = sequence
    got = list(tfl.FrameLoader(paths, n_threads=3, capacity=2))
    want = dict(jfl.FrameLoader(paths, n_threads=3, capacity=2, use_native=True))
    assert len(got) == len(frames)
    _equal_frames(dict(got), want)


def test_loader_numpy_reader(sequence):
    """use_native=False reads with NumPy on the calling thread, in order,
    and skips the unreadable files as the core does."""
    paths, frames, bad = sequence
    got = list(tfl.FrameLoader(paths, use_native=False))
    assert [i for i, _ in got] == sorted(frames)
    _equal_frames(dict(got), frames)
    valid = [p for j, p in enumerate(paths) if j not in bad]
    want = list(jfl.FrameLoader(valid, use_native=False))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_loader_stops_early_and_rejects_bad_sizes(sequence):
    paths, frames, _ = sequence
    for i, img in tfl.FrameLoader(paths, n_threads=2, capacity=1):
        break  # the workers are stopped and joined, not left blocked
    np.testing.assert_array_equal(img, frames[i])
    for kw in ({"n_threads": 0}, {"capacity": 0}):
        with pytest.raises(ValueError):
            tfl.FrameLoader(paths, **kw)


def test_failed_native_build_raises(sequence, tmp_path, monkeypatch):
    """No quiet NumPy fallback: a core that does not compile raises with
    g++'s output, for use_native None and True alike."""
    paths, frames, _ = sequence
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "frame_loader.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path / "native")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_host_libs", {})
    for use_native in (None, True):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tfl.FrameLoader(paths, use_native=use_native)
    assert len(list(tfl.FrameLoader(paths, use_native=False))) == len(frames)


RIG = {"cameras": [
    {"name": "left", "width": 640, "height": 480, "fu": 570.342, "fv": 568.913, "u0": 319.5,
     "v0": 239.5},
    {"name": "right", "width": 640, "height": 480, "fu": 570.342, "fv": 568.913, "u0": 321.25,
     "v0": 241.0, "T_wc": [0.08, 0.004, -0.002, 0.01, -0.02, 0.015]},
    {"name": "rdf", "width": 752, "height": 480, "fu": 455.0, "fv": 455.5, "u0": 370.1,
     "v0": 236.9,
     "T_wc": [0.998, -0.05, 0.0, 0.1, 0.05, 0.998, 0.0, -0.02, 0.0, 0.0, 1.0, 0.3],
     "RDF": [0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0]},
]}


@pytest.fixture
def rigs(tmp_path):
    p = tmp_path / "rig.json"
    p.write_text(json.dumps(RIG))
    return jrig.load_rig(str(p)), trig.load_rig(str(p))


def test_rig_methods_match_jax(rigs):
    jr, tr = rigs
    assert tr.names() == jr.names()
    for name in jr.names():
        jc, tc = jr[name], tr[name]
        np.testing.assert_array_equal(tc.T_wc, jc.T_wc)
        np.testing.assert_array_equal(tc.RDF, jc.RDF)
        for level in range(3):
            np.testing.assert_array_equal(tc.K(level), jc.K(level))
            np.testing.assert_array_equal(tc.Kinv(level), jc.Kinv(level))
            assert tc.size(level) == jc.size(level)
            ji, ti = jc.intrinsics(level), tc.intrinsics(level)
            assert (ti.fu, ti.fv, ti.u0, ti.v0) == tuple(
                float(np.float32(v)) for v in (ji.fu, ji.fv, ji.u0, ji.v0))
        for a, b in zip(tc.pyramid(), jc.pyramid(), strict=True):
            np.testing.assert_array_equal(a, b)
        for tm, jm in ((tc.scaled_to(320, 240), jc.scaled_to(320, 240)),
                       (tc.cropped_to(10, 20, 600, 440), jc.cropped_to(10, 20, 600, 440))):
            assert (tm.width, tm.height, tm.fu, tm.fv, tm.u0, tm.v0) == (
                jm.width, jm.height, jm.fu, jm.fv, jm.u0, jm.v0)
    rdf = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    for left, right, target in (("left", "right", None), ("left", "rdf", None),
                                ("rdf", "right", rdf)):
        np.testing.assert_array_equal(tr.t_rl(left, right, target), jr.t_rl(left, right, target))
    assert tr.baseline() == jr.baseline()
    assert tr.baseline("left", "rdf") == jr.baseline("left", "rdf")
    for args in ((640, 480, 640 * 480), (1280, 960, 640 * 480), (752, 480, 1000)):
        assert trig.level_from_max_pixels(*args) == jrig.level_from_max_pixels(*args)
    for args in ((640, 480, 16, 16), (752, 480, 32, 7)):
        assert trig.centered_aligned_region(*args) == jrig.centered_aligned_region(*args)
    np.testing.assert_array_equal(trig.make_k(570.3, 568.9, 319.5, 239.5),
                                  jrig.make_k(570.3, 568.9, 319.5, 239.5))
    np.testing.assert_array_equal(trig.make_k_inv(570.3, 568.9, 319.5, 239.5),
                                  jrig.make_k_inv(570.3, 568.9, 319.5, 239.5))
    np.testing.assert_array_equal(trig.scale_k(trig.make_k(570.3, 568.9, 319.5, 239.5), 0.3),
                                  jrig.scale_k(jrig.make_k(570.3, 568.9, 319.5, 239.5), 0.3))


def test_rig_round_trip_matches_jax(rigs, tmp_path):
    jr, tr = rigs
    trig.save_rig(str(tmp_path / "port.json"), tr)
    jrig.save_rig(str(tmp_path / "jax.json"), jr)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    back = trig.load_rig(str(tmp_path / "port.json"))
    for name in tr.names():
        for field in ("width", "height", "fu", "fv", "u0", "v0"):
            assert getattr(back[name], field) == getattr(tr[name], field)
        np.testing.assert_array_equal(back[name].T_wc, tr[name].T_wc)
        np.testing.assert_array_equal(back[name].RDF, tr[name].RDF)


def test_depth_and_cloud_with_rig_matches_jax(rigs):
    """The stereo demo's --rig path: a rig camera's K, scaled to the frame,
    and the rig's baseline give the same depth and cloud in both packages."""
    jr, tr = rigs
    rng = np.random.default_rng(1)
    disp = rng.uniform(0.5, 40.0, (48, 64)).astype(np.float32)
    disp[rng.random(disp.shape) < 0.1] = np.nan
    jd, jc = jstereo.depth_and_cloud(jnp.asarray(disp), jr["right"].scaled_to(64, 48).intrinsics(),
                                     jr.baseline(), min_disp=1.0)
    td, tc = tstereo.depth_and_cloud(torch.from_numpy(disp),
                                     tr["right"].scaled_to(64, 48).intrinsics(), tr.baseline(),
                                     min_disp=1.0)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_cart2t_exact():
    rng = np.random.default_rng(2)
    for vec in rng.uniform(-2.0, 2.0, (20, 6)):
        np.testing.assert_array_equal(ttrk.cart2t(vec), jtrk.cart2t(vec))


def _vicon(tmp_path, n=12):
    rng = np.random.default_rng(3)
    lines = []
    for i in range(n):
        x, y, z = rng.uniform(-1.0, 1.0, 3)
        r, p, q = rng.uniform(-0.5, 0.5, 3)
        lines.append(f"{i * 0.01:.3f}, {i * 0.01 + 5:.3f}, {x}, {y}, {z}, {r}, {p}, {q}")
    (tmp_path / "vicon.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("offset", [False, True])
def test_file_playback_matches_jax(tmp_path, offset):
    """vicon.txt replayed through both packages: callbacks, history,
    workspace and the latest pose, with and without a rigid offset."""
    _vicon(tmp_path)
    T_off = jtrk.cart2t([0.1, -0.2, 0.3, 0.05, 0.1, -0.15])
    runs = []
    for mod in (jtrk, ttrk):
        t = mod.FileTracking(base_dir=str(tmp_path), autostart=False)
        got = []
        t.register_tracking_callback(lambda T, ts, td, got=got: got.append((T, ts, td)))
        t.record_history = True
        if offset:
            t.set_offset(T_off)
        t.start(t._pending)
        t.join()
        assert not t.is_connected() and t.is_new_data()
        runs.append((t, got, t.T_wf()))
        assert not t.is_new_data()
    (jt, jgot, jT), (tt, tgot, tT) = runs
    assert len(tgot) == len(jgot) == len(tt.samples) == 12
    for (a, ats, atd), (b, bts, btd) in zip(tgot, jgot):
        assert a.dtype == np.float32 and (ats, atd) == (bts, btd)
        np.testing.assert_allclose(a, b, atol=POSE_TOL)
    for a, b in zip(tt.history, jt.history, strict=True):
        np.testing.assert_allclose(a, b, atol=POSE_TOL)
    np.testing.assert_allclose(tT, jT, atol=POSE_TOL)
    np.testing.assert_allclose(tt.workspace_min, jt.workspace_min, atol=POSE_TOL)
    np.testing.assert_allclose(tt.workspace_size(), jt.workspace_size(), atol=POSE_TOL)


def test_live_stream_matches_jax():
    """A live source of bare poses and (T, sys_time, dev_time) tuples."""
    rng = np.random.default_rng(4)
    poses = [jtrk.cart2t(v) for v in rng.uniform(-1.0, 1.0, (6, 6))]
    items = [(T, 10.0 + i, 0.5 * i) if i % 2 else T for i, T in enumerate(poses)]
    T_off = jtrk.cart2t([0.0, 0.0, 1.0, 0.0, 0.2, 0.0])
    latest = []
    for mod in (jtrk, ttrk):
        t = mod.StreamTracking()
        t.set_offset(T_off)
        t.toggle_record_history()
        t.start(iter(items))
        t.join()
        latest.append((t.T_wf(), t.history))
    (jT, jh), (tT, th) = latest
    np.testing.assert_allclose(tT, jT, atol=POSE_TOL)
    for a, b in zip(th, jh, strict=True):
        np.testing.assert_allclose(a, b, atol=POSE_TOL)
    t = ttrk.StreamTracking(iter(items))
    t.stop()
    t.clear_history()
    assert t.history == [] and tT.dtype == np.float32
