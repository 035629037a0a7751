"""Synthetic input (``kangaroo_tpu/apps/synthetic.py``): textured stereo
pairs with ground-truth disparity, and raycast depth sequences of a
three-sphere TSDF scene for KinectFusion, and a posed lateral track over
the stereo pair's scene for ``MultiViewStereo``, and Kinect-like depth
noise and photometrically corrupted pairs; ``colour_texture`` (not in the
JAX package) is an rgb frame for colour fusion. Everything is made on the card
unless the caller asks for another device (the noise on its input's).
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


def colour_texture(w: int, h: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """A smooth rgb frame (h, w, 3) uint8 made with NumPy from ``seed``: per
    channel 127.5 plus two plane waves of amplitude 60 with random
    frequencies (2-6 cycles over the longer side), directions' signs and
    phases, so that a wrong colour projection shows as a shifted colour."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64) / max(w, h)
    img = np.full((h, w, 3), 127.5)
    for c in range(3):
        fx, fy = rng.uniform(2.0, 6.0, (2, 2)) * rng.choice((-1.0, 1.0), (2, 2))
        phase = rng.uniform(0.0, 2.0 * np.pi, 2)
        for k in range(2):
            img[..., c] += 60.0 * np.sin(2.0 * np.pi * (fx[k] * xx + fy[k] * yy) + phase[k])
    return torch.from_numpy(np.clip(np.rint(img), 0, 255).astype(np.uint8)).to(device)


def _slab_scene(w: int, h: int, max_disp: int, seed: int):
    """The pair's texture, (h, w + max_disp) uint8, and its integer
    disparity on the left grid: a box at 3D/4 over a background at D/4."""
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
    return tex, disp


def stereo_pair(w: int = 640, h: int = 480, max_disp: int = 64, seed: int = 0,
                device="cuda"):
    """Textured fronto-parallel-slab stereo pair with ground-truth disparity:
    a box at disparity 3D/4 floating over a background plane at D/4.

    Built with NumPy from ``seed`` (the same arrays as ``kangaroo_tpu``);
    returns (left uint8, right uint8, gt float32) tensors on ``device``: the
    card unless the caller asks for another device (``device="cpu"``).
    """
    tex, disp = _slab_scene(w, h, max_disp, seed)
    # disparity is defined on the left grid: left[x] = right[x - d(x)]
    right = np.ascontiguousarray(tex[:, max_disp : max_disp + w])
    xs = np.arange(w)[None, :] + max_disp - disp
    left = tex[np.arange(h)[:, None], xs]
    return tuple(torch.from_numpy(a).to(device)
                 for a in (left.astype(np.uint8), right, disp.astype(np.float32)))


def multiview_track(w: int = 320, h: int = 240, max_disp: int = 32, fractions=(0.5, 0.75, 1.0),
                    baseline: float = 0.1, seed: int = 0, device="cuda"):
    """Posed lateral camera track over the ``stereo_pair`` scene: the
    keyframe is the pair's left image at the identity pose; the view at
    fraction f sits at x = f * baseline and sees disparity f * d relative
    to the keyframe (f = 1 is the right image). Exact where (1 - f) * d is
    integral and locally constant, away from the box edges.

    Built with NumPy from ``seed`` (the same arrays as ``kangaroo_tpu``);
    returns (keyframe uint8, gt float32, [(view uint8, T_wc (3, 4)), ...])
    on ``device``: the card unless the caller asks for another device."""
    tex, disp = _slab_scene(w, h, max_disp, seed)
    rows = np.arange(h)[:, None]

    def view(f):
        shift = np.rint((1.0 - f) * disp).astype(np.int64)
        xs = np.clip(np.arange(w)[None, :] + max_disp - shift, 0, w + max_disp - 1)
        return torch.from_numpy(tex[rows, xs]).to(device)

    track = [(view(f), se3.make(np.eye(3), [f * baseline, 0.0, 0.0], device=device))
             for f in fractions]
    return view(0.0), torch.from_numpy(disp.astype(np.float32)).to(device), track


def kinect_noise(depth: torch.Tensor, seed: int = 0, sigma0: float = 0.0012,
                 sigma1: float = 0.0019, dropout: float = 0.07, quantize: bool = True,
                 f: float = 580.0, baseline: float = 0.075) -> torch.Tensor:
    """Kinect-like corruption of a clean metric depth image, made with NumPy
    from ``seed`` (the same arrays as ``kangaroo_tpu``): axial noise
    sigma0 + sigma1 (z - 0.4)^2, disparity quantised to 1/8 pixel (z =
    f b / (round(8 f b / z) / 8)), clumped dropout holes covering about
    ``dropout`` of the valid pixels, and everything nearer than 0.4 m
    invalid. float32 with NaN invalid, on ``depth``'s device."""
    rng = np.random.default_rng(seed)
    z = depth.detach().cpu().numpy().astype(np.float32).copy()
    valid = np.isfinite(z) & (z > 0)
    sig = sigma0 + sigma1 * (z - 0.4) ** 2
    z = z + sig * rng.standard_normal(z.shape).astype(np.float32)
    if quantize:
        fb = f * baseline
        with np.errstate(divide="ignore", invalid="ignore"):
            z = fb / (np.round(8.0 * fb / z) / 8.0)
    # a box-smoothed noise field thresholded at the dropout quantile: holes
    # come as blobs, not salt and pepper
    field = rng.random(z.shape).astype(np.float32)
    k = np.ones(9, np.float32) / 9.0
    for axis in (0, 1):
        field = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), axis, field)
    if dropout > 0:
        z[field < np.quantile(field[valid], dropout)] = np.nan
    z[~valid] = np.nan
    z[z < 0.4] = np.nan
    return torch.from_numpy(np.asarray(z, np.float32)).to(depth.device)


def noisy_stereo_pair(w: int = 640, h: int = 480, max_disp: int = 64, seed: int = 0,
                      sigma: float = 6.0, gain: float = 1.06, offset: float = 4.0,
                      device="cuda"):
    """``stereo_pair`` with Gaussian pixel noise (``sigma`` grey levels) on
    each image and a gain/offset mismatch on the right one, made with NumPy
    from ``seed``: (left uint8, right uint8, gt float32) on ``device``."""
    left, right, gt = stereo_pair(w, h, max_disp, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 1)
    l = left.numpy().astype(np.float32) + sigma * rng.standard_normal((h, w))
    r = gain * right.numpy().astype(np.float32) + offset + sigma * rng.standard_normal((h, w))
    to_u8 = lambda a: torch.from_numpy(np.clip(a, 0, 255).astype(np.uint8)).to(device)  # noqa: E731
    return to_u8(l), to_u8(r), gt.to(device)
