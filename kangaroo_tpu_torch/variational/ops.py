"""TV operators for primal-dual solvers (``kangaroo_tpu/variational/ops.py``).

Forward gradient with zero boundary at the far edge, divergence with zero
boundary at the near edge (an adjoint pair), the TGV symmetrised gradient
Epsilon, its adjoint, and unit-ball projections. They act on (H, W)
scalars, (H, W, 2) vector fields and (H, W, 3) symmetric 2x2 tensor fields
stored as their three unique components (xx, yy, xy), in the same operation
order as the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _dx(a: torch.Tensor) -> torch.Tensor:
    """a[:, x+1] - a[:, x], zero at the last column."""
    return F.pad(a[:, 1:] - a[:, :-1], (0, 1))


def _dy(a: torch.Tensor) -> torch.Tensor:
    """a[y+1] - a[y], zero at the last row."""
    return F.pad(a[1:] - a[:-1], (0, 0, 0, 1))


def _prev_x(a: torch.Tensor) -> torch.Tensor:
    """a[:, x-1], zero at the first column."""
    return F.pad(a[:, :-1], (1, 0))


def _prev_y(a: torch.Tensor) -> torch.Tensor:
    """a[y-1], zero at the first row."""
    return F.pad(a[:-1], (0, 0, 1, 0))


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of a float32 tensor. It goes through
    float64 because PyTorch's vectorised float32 sqrt on the CPU can be one
    ulp off; rounding the float64 root to float32 is exact."""
    return torch.sqrt(a.double()).to(a.dtype)


def grad_forward(u: torch.Tensor) -> torch.Tensor:
    """Forward-difference gradient, zero at the far boundary.
    (H, W) -> (H, W, 2)."""
    return torch.stack([_dx(u), _dy(u)], dim=-1)


def divergence(p: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, adjoint of -grad_forward.
    (H, W, 2) -> (H, W)."""
    px, py = p[..., 0], p[..., 1]
    return px + py - _prev_x(px) - _prev_y(py)


def epsilon(v: torch.Tensor) -> torch.Tensor:
    """Symmetrised gradient of a vector field.
    (H, W, 2) -> (H, W, 3) storing (dx v0, dy v1, (dy v0 + dx v1)/2)."""
    v0, v1 = v[..., 0], v[..., 1]
    return torch.stack([_dx(v0), _dy(v1), (_dy(v0) + _dx(v1)) / 2.0], dim=-1)


def divergence_sym(q: torch.Tensor) -> torch.Tensor:
    """Adjoint "generalised divergence" of a symmetric tensor field.
    (H, W, 3) -> (H, W, 2): with q = (xx, yy, xy),
    div_x = dx- xx + dy- xy, div_y = dx- xy + dy- yy."""
    xx, yy, xy = q[..., 0], q[..., 1], q[..., 2]
    d0 = xx + xy - _prev_x(xx) - _prev_y(xy)
    d1 = xy + yy - _prev_x(xy) - _prev_y(yy)
    return torch.stack([d0, d1], dim=-1)


def project_unit_ball(p: torch.Tensor, maxrad: float = 1.0) -> torch.Tensor:
    """p / max(1, |p|/maxrad) over the last axis."""
    mag = _sqrt(torch.sum(p * p, dim=-1, keepdim=True))
    return p / torch.clamp(mag / maxrad, min=1.0)


def project_unit_ball_sym(q: torch.Tensor, maxrad: float = 1.0) -> torch.Tensor:
    """Unit-ball projection of the symmetric tensor field with the norm in
    which the off-diagonal appears twice."""
    mag = _sqrt(q[..., 0] ** 2 + q[..., 1] ** 2 + 2.0 * q[..., 2] ** 2)[..., None]
    return q / torch.clamp(mag / maxrad, min=1.0)


def project_unit_ball_scalar(r: torch.Tensor, maxrad: float = 1.0) -> torch.Tensor:
    return r / torch.clamp(torch.abs(r) / maxrad, min=1.0)
