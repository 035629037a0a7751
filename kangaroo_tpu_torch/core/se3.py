"""SE3/SO3 rigid transforms on (3, 4) pose tensors (``kangaroo_tpu/core/se3.py``).

A pose ``T_ba`` is a (3, 4) float32 tensor [R | t] mapping frame a to frame
b; point batches are (..., 3). ``exp`` and ``log`` run in float32 as the
JAX package's do.
"""
from __future__ import annotations

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def identity(device="cuda") -> torch.Tensor:
    return torch.cat([torch.eye(3, dtype=torch.float32, device=device),
                      torch.zeros((3, 1), dtype=torch.float32, device=device)], dim=1)


def make(R, t, device=None) -> torch.Tensor:
    return torch.cat([_f32(R, device).reshape(3, 3), _f32(t, device).reshape(3, 1)], dim=1)


def rotation(T):
    return T[:, :3]


def translation(T):
    return T[:, 3]


def transform(T, p):
    """T * p: rotate and translate points (..., 3)."""
    return p @ T[:, :3].T + T[:, 3]


def rotate(T, v):
    """R * v."""
    return v @ T[:, :3].T


def rotate_inv(T, v):
    """R^T * v."""
    return v @ T[:, :3]


def transform_inv(T, p):
    """T^-1 * p."""
    return (p - T[:, 3]) @ T[:, :3]


def inverse(T):
    R, t = T[:, :3], T[:, 3:]
    return torch.cat([R.T, -R.T @ t], dim=1)


def compose(T_cb, T_ba):
    """T_ca = T_cb * T_ba."""
    R = T_cb[:, :3] @ T_ba[:, :3]
    t = T_cb[:, :3] @ T_ba[:, 3:] + T_cb[:, 3:]
    return torch.cat([R, t], dim=1)


def generator_products(p):
    """gen_i * p for the 6 SE3 generators (tx, ty, tz, rx, ry, rz), stacked
    (..., 6, 3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    o, zz = torch.ones_like(x), torch.zeros_like(x)
    gens = ((o, zz, zz), (zz, o, zz), (zz, zz, o), (zz, -z, y), (z, zz, -x), (-y, x, zz))
    return torch.stack([torch.stack(g, dim=-1) for g in gens], dim=-2)


def plane_b_from_a(T_ab, n_a):
    """Transform the plane n.x = -1: n_b = R^T n_a / (t . n_a + 1)."""
    den = torch.dot(translation(T_ab), n_a) + 1.0
    return rotate_inv(T_ab, n_a) / den


def skew(w):
    wx, wy, wz = w[0], w[1], w[2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy]), torch.stack([wz, z, -wx]),
                        torch.stack([-wy, wx, z])])


def exp(xi):
    """SE3 exponential map: xi = (tx, ty, tz, rx, ry, rz) -> (3, 4) pose."""
    xi = xi.to(torch.float32).reshape(6)
    v, w = xi[:3], xi[3:]
    theta2 = torch.dot(w, w)
    theta = torch.sqrt(theta2 + 1e-32)
    W = skew(w)
    W2 = W @ W
    small = theta2 < 1e-10
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2)
    eye = torch.eye(3, dtype=torch.float32, device=xi.device)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    return torch.cat([R, (V @ v)[:, None]], dim=1)


def log(T):
    """SE3 log map: (3, 4) pose -> (tx, ty, tz, rx, ry, rz); inverse of :func:`exp`."""
    T = T.to(torch.float32)
    R, t = T[:, :3], T[:, 3]
    cos_theta = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    theta2 = theta * theta
    small = theta < 1e-5
    w_raw = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    scale = torch.where(small, 0.5 + theta2 / 12.0, theta / (2.0 * torch.sin(theta) + 1e-30))
    w = scale * w_raw
    W = skew(w)
    W2 = W @ W
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.clamp(theta, min=1e-30))
    coef = torch.where(small, 1.0 / 12.0, (1.0 - A / (2.0 * B)) / torch.clamp(theta2, min=1e-30))
    Vinv = torch.eye(3, dtype=torch.float32, device=T.device) - 0.5 * W + coef * W2
    return torch.cat([Vinv @ t, w])


def to_matrix4(T):
    """(3, 4) -> (4, 4) homogeneous."""
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32, device=T.device)
    return torch.cat([T, bottom], dim=0)
