"""The benchmark's input generators, made from the seed.

``slab_scene`` and ``stereo_pair`` are frozen NumPy copies of the program's
``apps/synthetic.py`` as it stands (``tests/test_portbench_data.py`` holds
them equal to it at a small size), so that a later change to the program
cannot change what the benchmark feeds it: a textured fronto-parallel scene
(a box at disparity 3D/4 over a background plane at D/4) and its rectified
pair. ``handheld_track`` is the benchmark's own: the views a handheld camera
takes of that scene after the keyframe, each rendered through its pose.
"""
from __future__ import annotations

import numpy as np
import torch


def slab_scene(w: int, h: int, max_disp: int, seed: int):
    """The pair's texture, (h, w + max_disp) uint8, and its integer
    disparity on the left grid: a box at 3D/4 over a background at D/4."""
    rng = np.random.default_rng(seed)
    tex = rng.random((h, w + max_disp)).astype(np.float32)
    k = np.ones(7, np.float32) / 7.0
    for axis in (0, 1):
        tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), axis, tex)
    tex = tex + 0.35 * rng.random((h, w + max_disp)).astype(np.float32)
    tex = (255 * (tex - tex.min()) / (tex.max() - tex.min())).astype(np.uint8)

    disp = np.full((h, w), max_disp // 4, np.int32)
    bw, bh = w // 3, h // 3
    disp[bh : 2 * bh, bw : 2 * bw] = (3 * max_disp) // 4
    return tex, disp


def stereo_pair(w: int, h: int, max_disp: int, seed: int):
    """(left uint8, right uint8, gt float32), each (h, w): left[x] =
    right[x - d(x)]."""
    tex, disp = slab_scene(w, h, max_disp, seed)
    right = np.ascontiguousarray(tex[:, max_disp : max_disp + w])
    xs = np.arange(w)[None, :] + max_disp - disp
    left = tex[np.arange(h)[:, None], xs]
    return left.astype(np.uint8), right, disp.astype(np.float32)


# mean speeds of the handheld TUM RGB-D sequence fr1/xyz (Sturm et al., A
# Benchmark for the Evaluation of RGB-D SLAM Systems, IROS 2012), at its
# camera's 30 Hz
SPEED_M_S = 0.244
TURN_DEG_S = 8.920
FRAME_HZ = 30.0


def track_poses(views: int, seed: int) -> np.ndarray:
    """(views, 3, 4) float32 camera-to-world poses T_wc of the frames that
    follow a keyframe at the identity: frame k at k / FRAME_HZ seconds on a
    screw of constant speed, SPEED_M_S along a direction and TURN_DEG_S about
    an axis both drawn from the seed, so every seed moves the same distance
    and turns the same angle."""
    rng = np.random.default_rng([seed, 1])
    move, axis = (v / np.linalg.norm(v) for v in rng.normal(size=(2, 3)))
    cross = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                      [-axis[1], axis[0], 0.0]])
    poses = np.zeros((views, 3, 4), np.float64)
    for k in range(views):
        t = (k + 1) / FRAME_HZ
        a = np.radians(TURN_DEG_S) * t
        poses[k, :, :3] = np.eye(3) + np.sin(a) * cross + (1.0 - np.cos(a)) * cross @ cross
        poses[k, :, 3] = SPEED_M_S * t * move
    return poses.astype(np.float32)


def render_views(tex: np.ndarray, w: int, h: int, max_disp: int, K: dict, baseline: float,
                 poses: np.ndarray, device) -> torch.Tensor:
    """(views, h, w) uint8 views of the ``slab_scene`` texture ``tex`` from
    the poses T_wc, on ``device``. The scene is the two planes that the
    keyframe (the identity pose) sees: the box's rectangle at depth
    fu b / (3D/4) and the background at fu b / (D/4), the left image's
    texture pinned to each. Each pixel's ray meets the box if it falls in
    its rectangle, else the background, and takes the texture there,
    bilinear, mirrored beyond its edges. The identity pose gives the pair's
    left image and the pose (b, 0, 0) its right image."""
    f64 = torch.float64
    fu, fv, u0, v0 = K["fu"], K["fv"], K["u0"], K["v0"]
    texture = torch.from_numpy(tex).to(device=device, dtype=f64)
    th, tw = texture.shape
    d_bg, d_box = max_disp // 4, (3 * max_disp) // 4
    bw, bh = w // 3, h // 3
    y, x = torch.meshgrid(torch.arange(h, dtype=f64, device=device),
                          torch.arange(w, dtype=f64, device=device), indexing="ij")
    ray = torch.stack([(x - u0) / fu, (y - v0) / fv, torch.ones_like(x)])
    T = torch.from_numpy(poses).to(device=device, dtype=f64)

    def mirror(i, n):  # ... 1 0 | 0 1 ... n-1 | n-1 n-2 ...
        i = torch.remainder(i, 2 * n)
        return torch.where(i < n, i, 2 * n - 1 - i)

    def hit(o, r, d):  # keyframe pixel where the ray o + l r meets disparity d's plane
        Z = fu * baseline / d
        lam = (Z - o[2]) / r[2]
        return fu * (o[0] + lam * r[0]) / Z + u0, fv * (o[1] + lam * r[1]) / Z + v0

    out = []
    for R, o in zip(T[:, :, :3], T[:, :, 3]):
        r = torch.einsum("ij,jhw->ihw", R, ray)
        xb, yb = hit(o, r, d_box)
        box = (xb >= bw - 0.5) & (xb < 2 * bw - 0.5) & (yb >= bh - 0.5) & (yb < 2 * bh - 0.5)
        xg, yg = hit(o, r, d_bg)
        col = torch.where(box, xb + (max_disp - d_box), xg + (max_disp - d_bg))
        row = torch.where(box, yb, yg)
        c0, r0 = torch.floor(col), torch.floor(row)
        fc, fr = col - c0, row - r0
        ca, cb = mirror(c0.long(), tw), mirror(c0.long() + 1, tw)
        ra, rb = mirror(r0.long(), th), mirror(r0.long() + 1, th)
        top = texture[ra, ca] * (1 - fc) + texture[ra, cb] * fc
        bot = texture[rb, ca] * (1 - fc) + texture[rb, cb] * fc
        out.append(torch.round(top * (1 - fr) + bot * fr).clamp(0, 255).to(torch.uint8))
    return torch.stack(out)


def handheld_track(w: int, h: int, max_disp: int, K: dict, baseline: float, views: int,
                   seed: int, device):
    """One keyframe's inputs on ``device``: the rectified pair (left uint8,
    right uint8, each (h, w)) of ``stereo_pair``, its left image being the
    keyframe at the identity pose, the ``views`` frames that follow it
    ((views, h, w) uint8) and their poses T_wc ((views, 3, 4) float32
    NumPy)."""
    tex, _ = slab_scene(w, h, max_disp, seed)
    poses = track_poses(views, seed)
    pair = render_views(tex, w, h, max_disp, K, baseline,
                        np.array([[[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]],
                                  [[1, 0, 0, baseline], [0, 1, 0, 0], [0, 0, 1, 0]]],
                                 np.float32), device)
    return pair[0], pair[1], render_views(tex, w, h, max_disp, K, baseline, poses, device), poses
