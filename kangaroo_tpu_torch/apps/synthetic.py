"""Synthetic stereo input (``kangaroo_tpu/apps/synthetic.py``, ``stereo_pair``)."""
from __future__ import annotations

import numpy as np
import torch


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
