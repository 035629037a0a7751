"""The frozen generators give the program's ``apps/synthetic`` arrays, and
the handheld track renders the scene through its poses."""
import numpy as np
import pytest

from kangaroo_tpu_torch.apps import synthetic as program
from portbench.data import synthetic


def _K(w, h):
    return {"fu": 0.9 * w, "fv": 0.9 * w, "u0": w / 2 - 0.5, "v0": h / 2 - 0.5}


@pytest.mark.parametrize("w,h,d,seed", [(64, 48, 16, 0), (97, 31, 24, 2**31 + 5)])
def test_stereo_pair_equals_the_program(w, h, d, seed):
    ours = synthetic.stereo_pair(w, h, d, seed)
    theirs = program.stereo_pair(w, h, d, seed=seed, device="cpu")
    for a, b in zip(ours, theirs):
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())


@pytest.mark.parametrize("w,h,d,seed", [(64, 48, 16, 9), (97, 31, 24, 2**31 + 5)])
def test_handheld_track_keyframe_is_the_pair(w, h, d, seed):
    """The keyframe and the right image rendered at the identity and at
    (b, 0, 0) are the program's rectified pair."""
    left, right, views, poses = synthetic.handheld_track(w, h, d, _K(w, h), 0.1, 3, seed, "cpu")
    pl, pr, _ = program.stereo_pair(w, h, d, seed=seed, device="cpu")
    assert np.array_equal(left.numpy(), pl.numpy()) and np.array_equal(right.numpy(), pr.numpy())
    assert views.shape == (3, h, w) and poses.shape == (3, 3, 4) and poses.dtype == np.float32


@pytest.mark.parametrize("views", [3, 20])
def test_track_poses_move_and_turn_at_the_sequence_speeds(views):
    """Every seed's track moves SPEED_M_S and turns TURN_DEG_S along
    directions of all three axes; the same seed gives the same track."""
    seen = []
    for seed in (1, 2, 2**31 + 3):
        poses = synthetic.track_poses(views, seed).astype(np.float64)
        assert np.array_equal(poses, synthetic.track_poses(views, seed))
        t = np.arange(1, views + 1) / synthetic.FRAME_HZ
        R, p = poses[:, :, :3], poses[:, :, 3]
        assert np.allclose(np.einsum("kji,kjl->kil", R, R), np.eye(3), atol=1e-6)
        assert np.allclose(np.linalg.norm(p, axis=1), synthetic.SPEED_M_S * t, rtol=1e-5)
        angle = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
        assert np.allclose(angle, synthetic.TURN_DEG_S * t, rtol=1e-3, atol=1e-3)
        seen.append(p[-1] / np.linalg.norm(p[-1]))
    assert min(np.abs(np.stack(seen)).max(axis=0)) > 0.1  # no axis left out


def test_a_vertical_move_shifts_the_background_rows():
    """A camera raised by b sees the background plane (disparity D/4) d rows
    lower: the views are not rectified to the keyframe's rows."""
    w, h, d = 64, 48, 16
    tex, _ = synthetic.slab_scene(w, h, d, 4)
    K = _K(w, h)
    key = synthetic.render_views(tex, w, h, d, K, 0.1, np.eye(3, 4, dtype=np.float32)[None], "cpu")
    up = np.eye(3, 4, dtype=np.float32)
    up[1, 3] = 0.1
    view = synthetic.render_views(tex, w, h, d, K, 0.1, up[None], "cpu")
    shift = d // 4
    # background columns left of the box, rows clear of the box and the image edges
    assert np.array_equal(view[0, : h // 3 - shift, : w // 3 - shift].numpy(),
                          key[0, shift : h // 3, : w // 3 - shift].numpy())
    assert not np.array_equal(view[0].numpy(), key[0].numpy())
