"""Synthetic input (``kangaroo_tpu/apps/synthetic.py``): textured stereo
pairs with ground-truth disparity, and raycast depth sequences of a
three-sphere TSDF scene for KinectFusion. Everything is made on the card
unless the caller asks for another device. ``multiview_track``,
``kinect_noise`` and ``noisy_stereo_pair`` are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..containers.bbox import BoundingBox
from ..containers.volume import TsdfVolume
from ..core import se3
from ..fusion import raycast as rc


def sphere_scene(res: int = 128, extent: float = 1.2, device="cuda") -> TsdfVolume:
    """Three-sphere TSDF scene (exact distances, weight 1) with full 6-dof
    observability."""
    bbox = BoundingBox.create((-extent,) * 3, (extent,) * 3, device=device)
    pos = TsdfVolume.create(res, res, res, bbox, trunc_dist=0.1).voxel_positions()

    def dist(c, r):
        d = pos - torch.tensor(c, dtype=torch.float32, device=pos.device)
        return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]) - r

    val = torch.minimum(torch.minimum(dist((0.25, 0.0, 0.0), 0.6), dist((-0.45, 0.35, 0.3), 0.4)),
                        dist((-0.2, -0.5, -0.3), 0.3))
    return TsdfVolume(val, torch.ones_like(val), bbox)


def orbit_pose(angle: float, radius: float = 3.0, device="cuda") -> torch.Tensor:
    """Camera on a y-axis orbit looking at the origin: T_wc (3, 4)."""
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return se3.make(R, R @ np.array([0.0, 0.0, -radius], np.float32), device=device)


def depth_sequence(n_frames: int, K, w: int, h: int, scene=None, step: float = 0.02,
                   radius: float = 3.0, device="cuda"):
    """Yield (T_wc, depth) frames orbiting the scene (``scene``'s device, or
    ``device`` for the default scene); depth is NaN where a ray misses."""
    vol = sphere_scene(device=device) if scene is None else scene
    for i in range(n_frames):
        T_wc = orbit_pose(i * step, radius, device=vol.val.device)
        depth, _, _ = rc.raycast_sdf(vol, T_wc, K, w, h, near=0.5, far=8.0)
        yield T_wc, depth


def stereo_pair(w: int = 640, h: int = 480, max_disp: int = 64, seed: int = 0,
                device="cuda"):
    """Textured fronto-parallel-slab stereo pair with ground-truth disparity:
    a box at disparity 3D/4 floating over a background plane at D/4.

    Built with NumPy from ``seed`` (the same arrays as ``kangaroo_tpu``);
    returns (left uint8, right uint8, gt float32) tensors on ``device``: the
    card unless the caller asks for another device (``device="cpu"``).
    """
    rng = np.random.default_rng(seed)
    # smooth texture: low-frequency noise + speckle so census has signal
    tex = rng.random((h, w + max_disp)).astype(np.float32)
    k = np.ones(7, np.float32) / 7.0
    for axis in (0, 1):
        tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), axis, tex)
    tex = tex + 0.35 * rng.random((h, w + max_disp)).astype(np.float32)
    tex = (255 * (tex - tex.min()) / (tex.max() - tex.min())).astype(np.uint8)

    disp = np.full((h, w), max_disp // 4, np.int32)
    bw, bh = w // 3, h // 3
    disp[bh : 2 * bh, bw : 2 * bw] = (3 * max_disp) // 4

    # disparity is defined on the left grid: left[x] = right[x - d(x)]
    right = np.ascontiguousarray(tex[:, max_disp : max_disp + w])
    xs = np.arange(w)[None, :] + max_disp - disp
    left = tex[np.arange(h)[:, None], xs]
    return tuple(torch.from_numpy(a).to(device)
                 for a in (left.astype(np.uint8), right, disp.astype(np.float32)))
