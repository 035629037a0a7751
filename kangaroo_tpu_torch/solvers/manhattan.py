"""Manhattan-frame rotation from image edges (``kangaroo_tpu/solvers/manhattan.py``).

Holoborodko 5x3 edge filters; each strong edge back-projects to the normal
of its interpretation plane, which is classified against the axes of the
rotation hypothesis; the classified edges build a Gauss-Newton system on
the 3-dof rotation update. Plain PyTorch on the image's device, with no
host read: the iteration keeps the rotation on the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..backend import f32_scalars
from ..core import se3
from .lss import LSS, reduce_system


def _holoborodko(img):
    """5x3 / 3x5 smooth-derivative filters over the edge-padded image,
    normalised by 32 * 255: (dx, dy)."""
    f = img.to(torch.float32)
    H, W = f.shape
    p = F.pad(f[None, None], (2, 2, 2, 2), mode="replicate")[0, 0]
    # a device scalar: a CUDA tensor divided by a Python scalar is
    # multiplied by its reciprocal, which rounds apart from the CPU's division
    norm, = f32_scalars(img.device, 32.0 * 255.0)

    def s(dx, dy):
        return p[2 + dy:2 + dy + H, 2 + dx:2 + dx + W]

    dx = (
        (s(2, -1) + 2 * s(1, -1) - 2 * s(-1, -1) - s(-2, -1))
        + (2 * s(2, 0) + 4 * s(1, 0) - 4 * s(-1, 0) - 2 * s(-2, 0))
        + (s(2, 1) + 2 * s(1, 1) - 2 * s(-1, 1) - s(-2, 1))
    ) / norm
    dy = (
        (s(-1, 2) + 2 * s(-1, 1) - 2 * s(-1, -1) - s(-1, -2))
        + (2 * s(0, 2) + 4 * s(0, 1) - 4 * s(0, -1) - 2 * s(0, -2))
        + (s(1, 2) + 2 * s(1, 1) - 2 * s(1, -1) - s(1, -2))
    ) / norm
    return dx, dy


def manhattan_line_cost(img, Rhat, K, cut=0.05, min_grad=0.05) -> LSS:
    """The LSS over so3 updates to ``Rhat`` (3, 3) from the (H, W) image's
    edges seen through the Intrinsics ``K``: edges stronger than
    ``min_grad`` and 3 pixels inside count; those whose normal lies within
    ``cut`` of an axis plane contribute rows."""
    H, W = img.shape
    dev = img.device
    dx, dy = _holoborodko(img)
    mag = torch.sqrt(dx * dx + dy * dy)

    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    fu, fv, u0, v0 = f32_scalars(dev, K.fu, K.fv, K.u0, K.v0)
    rayx = (u - u0) / fu
    rayy = (v - v0) / fv
    line = torch.stack([-dy, dx, torch.zeros_like(dx)], dim=-1)
    ray = torch.stack([rayx, rayy, torch.ones_like(rayx)], dim=-1)
    n = torch.linalg.cross(line, ray)
    m = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-20)

    dots = m @ Rhat.T  # (..., 3): (dotx, doty, dotz)
    d2 = dots * dots
    dxx, dyy, dzz = d2[..., 0], d2[..., 1], d2[..., 2]

    # dR/dw_k applied to m: Rhat (gen_k x m)
    mx, my, mz = m[..., 0], m[..., 1], m[..., 2]
    z = torch.zeros_like(mx)
    dRm = torch.stack([torch.stack([z, mz, -my], dim=-1), torch.stack([-mz, z, mx], dim=-1),
                       torch.stack([my, -mx, z], dim=-1)], dim=-2)  # (..., 3 params, 3 vec)
    dRRm = dRm @ Rhat.T  # (..., 3 params, 3 axes)

    is_x = dxx < cut * torch.minimum(dyy, dzz)
    is_y = ~is_x & (dyy < cut * torch.minimum(dxx, dzz))
    is_z = ~is_x & ~is_y & (dzz < cut * torch.minimum(dxx, dyy))
    axis = torch.where(is_x, 0, torch.where(is_y, 1, 2))
    classified = is_x | is_y | is_z

    f = mag * torch.gather(dots, -1, axis[..., None])[..., 0]
    Jsel = torch.gather(dRRm, -1, axis[..., None, None].expand(H, W, 3, 1))[..., 0]
    J = mag[..., None] * Jsel

    edge = mag > min_grad
    # every strong edge is observed; unclassified ones contribute zero J and f
    f = torch.where(classified, f, 0.0)
    J = torch.where(classified[..., None], J, 0.0)
    x_idx = torch.arange(W, device=dev)[None, :]
    y_idx = torch.arange(H, device=dev)[:, None]
    interior = (x_idx >= 3) & (x_idx < W - 3) & (y_idx >= 3) & (y_idx < H - 3)
    return reduce_system(J, f, torch.ones_like(f), edge & interior)


def estimate_manhattan_rotation(img, K, R0=None, iterations: int = 10, cut=0.05,
                                min_grad=0.05) -> torch.Tensor:
    """``iterations`` Gauss-Newton steps on the rotation from ``R0`` (the
    identity by default), on the image's device. A step whose system is
    singular (no classified edge: the solve gives NaN) holds the rotation."""
    dev = img.device
    R = (torch.eye(3, dtype=torch.float32, device=dev) if R0 is None
         else torch.as_tensor(R0, dtype=torch.float32).to(dev))
    zeros = torch.zeros(3, dtype=torch.float32, device=dev)
    for _ in range(iterations):
        dw = manhattan_line_cost(img, R, K, cut, min_grad).solve(damping=1e-6)
        dw = torch.where(torch.isfinite(dw), dw, 0.0)
        R = R @ se3.exp(torch.cat([zeros, -dw]))[:, :3]
    return R
