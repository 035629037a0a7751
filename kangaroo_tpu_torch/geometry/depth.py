"""Depth-map utilities (``kangaroo_tpu/geometry/depth.py``): depth to a
point image ("vbo") and normals from it. ``disp_to_depth``,
``depth_from_disparity_vbo``, ``filter_bad_kinect_data``, ``colour_vbo``
and the keyframe texturing are not ported yet.
"""
from __future__ import annotations

import torch


def depth_to_vbo(depth: torch.Tensor, K, depth_scale=1.0) -> torch.Tensor:
    """Unproject a depth image to a (H, W, 4) point image with w = 1."""
    H, W = depth.shape
    P = K.unproject_grid(W, H, depth_scale * depth)
    return torch.cat([P, torch.ones((H, W, 1), dtype=torch.float32, device=depth.device)], dim=-1)


def normals_from_vbo(points: torch.Tensor) -> torch.Tensor:
    """Normals from forward differences of a point image -> (H, W, 4); w = 1
    marks valid, the last row and column get w = 0."""
    H, W = points.shape[:2]
    Vc = points[..., :3]
    a = torch.roll(Vc, -1, dims=1) - Vc
    b = torch.roll(Vc, -1, dims=0) - Vc
    axb = torch.linalg.cross(a, b, dim=-1)
    mag = torch.sqrt(axb[..., 0] * axb[..., 0] + axb[..., 1] * axb[..., 1]
                     + axb[..., 2] * axb[..., 2])[..., None]
    n = -axb / mag
    valid = torch.ones((H, W), dtype=torch.float32, device=points.device)
    valid[:, -1] = 0.0
    valid[-1, :] = 0.0
    n = torch.where(valid[..., None] > 0, n, 0.0)
    return torch.cat([n, valid[..., None]], dim=-1)
