"""Robust plane fitting from a point image (``kangaroo_tpu/solvers/plane_fit.py``).

Tukey-weighted Gauss-Newton on the plane parameterisation n = Qinv z with
the plane n . P = -1, residual y = d (n . P + 1), d = 1/|n|, and the
reference's analytic Jacobian. The fit runs on the points' device and
reads nothing back to the host: a skipped step and the unit-norm clamp are
``torch.where``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..backend import f32_scalars
from .lss import LSS, reduce_system


def plane_fit_gn(points: torch.Tensor, Qinv: torch.Tensor, zhat: torch.Tensor, zmin=0.1,
                 zmax=100.0, c=0.1) -> LSS:
    """The normal equations of one GN step over the z update. points:
    (H, W, 4) point image; Qinv: (3, 3); zhat: (3,)."""
    P = points[..., :3]
    Pz = points[..., 2]
    nhat = Qinv @ zhat
    d = 1.0 / torch.sqrt(torch.dot(nhat, nhat))
    np_p1 = P @ nhat + 1.0
    y = d * np_p1
    (c,) = f32_scalars(points.device, c)
    roc = y / c
    om = 1.0 - roc * roc
    w = torch.where(y.abs() <= c, om * om, 0.0)
    # dn/dz_i = zhat[i] * Qinv[:, i]
    d3 = d * (d * d)
    J = []
    for i in range(3):
        dn = zhat[i] * Qinv[:, i]
        J.append((-d3 * np_p1) * torch.dot(nhat, dn) + d * (P @ dn))
    J = torch.stack(J, dim=-1)
    valid = torch.isfinite(Pz) & (Pz > zmin) & (Pz < zmax)
    return reduce_system(J, y, w, valid)


def make_q_inv(K, w: int, h: int, device="cuda") -> torch.Tensor:
    """The plane parameterisation's basis from three pixels below the
    horizon: Q = -(Kinv U)^T with U = [(w, h/2), (0, h), (w, h)]
    homogeneous; the plane is n = Qinv z, z the inverse depths along those
    rays. Computed with NumPy in float32, returned on ``device``."""
    U = np.array([[w, 0, w], [h / 2.0, h, h], [1.0, 1.0, 1.0]], np.float32)
    Kinv = K.inverse_matrix(device="cpu").numpy()
    Q = -(Kinv @ U).T
    return torch.from_numpy(np.linalg.inv(Q).astype(np.float32)).to(device)


def fit_plane(points: torch.Tensor, Qinv: torch.Tensor, z0=None, iterations: int = 10,
              zmin=0.1, zmax=100.0, c=0.1):
    """``iterations`` GN steps with the multiplicative update z *= exp(x),
    the step x clamped to unit norm and skipped where the solve is not
    finite (a degenerate point set). Returns (n, z), n = Qinv z with
    n . P = -1 on the plane."""
    dev = points.device
    z = (torch.full((3,), 0.2, dtype=torch.float32, device=dev) if z0 is None
         else z0.to(device=dev, dtype=torch.float32))
    for _ in range(iterations):
        x = -plane_fit_gn(points, Qinv, z, zmin, zmax, c).solve(damping=1e-9)
        x = torch.where(torch.isfinite(x), x, 0.0)
        nrm = torch.sqrt(torch.dot(x, x))
        x = torch.where(nrm > 1.0, x / nrm, x)
        z = z * torch.exp(x)
    return Qinv @ z, z


def plane_basis_wp(n: torch.Tensor) -> torch.Tensor:
    """(3, 4) pose of the fitted plane: origin at the plane point closest to
    the frame origin (-n/|n|^2), z axis along the normal, x and y an
    orthonormal tangent pair from Gram-Schmidt against the world axis least
    aligned with the normal (the first of equal components)."""
    n = n.to(torch.float32)
    nn = torch.dot(n, n)
    z_axis = n / torch.sqrt(torch.clamp(nn, min=1e-20))
    axes = torch.arange(3, device=n.device)
    seed = (axes == torch.argmin(z_axis.abs())).to(torch.float32)
    x_axis = seed - torch.dot(seed, z_axis) * z_axis
    x_axis = x_axis / torch.clamp(torch.linalg.vector_norm(x_axis), min=1e-20)
    y_axis = torch.linalg.cross(z_axis, x_axis)
    R = torch.stack([x_axis, y_axis, z_axis], dim=1)
    origin = -n / torch.clamp(nn, min=1e-20)
    return torch.cat([R, origin[:, None]], dim=1)
