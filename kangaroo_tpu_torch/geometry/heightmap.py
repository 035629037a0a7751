"""Heightmap fusion on a z = 0 grid (``kangaroo_tpu/geometry/heightmap.py``).

The heightmap is an (Hh, Wh, 4) float32 tensor per cell: (mean height,
count, mean colour, unused). A fuse bins points into cells and adds each
cell's samples with ``index_add_`` into Hh * Wh + 1 sums, the last one an
overflow cell for the rejected points, then updates the running means in
one step. On the card the sums' order is the atomics', so a mean may
differ from the CPU's in the last bits; the counts are exact.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import se3


def init_heightmap(w: int, h: int, device="cuda") -> torch.Tensor:
    hm = torch.zeros((h, w, 4), dtype=torch.float32, device=device)
    hm[..., 2] = 128.0
    return hm


def _cell_sums(idx: torch.Tensor, values: torch.Tensor, n_cells: int) -> torch.Tensor:
    out = torch.zeros(n_cells + 1, dtype=torch.float32, device=values.device)
    return out.index_add_(0, idx, values.reshape(-1).to(torch.float32))[:n_cells]


def update_heightmap(hm: torch.Tensor, points: torch.Tensor, image, T_hc: torch.Tensor,
                     min_height=-1e10, max_height=1e10, max_distance=1e10) -> torch.Tensor:
    """Bin camera-frame points (H, W, 4) into the grid through T_hc (3, 4,
    camera -> heightmap), updating the running mean height and, with an
    (H, W) ``image``, the mean colour of its non-zero pixels. Returns the
    new heightmap."""
    Hh, Wh = hm.shape[:2]
    p_h = se3.transform(T_hc, points[..., :3])
    z = torch.clamp(p_h[..., 2], min=min_height)
    x = torch.floor(p_h[..., 0] + 0.5)
    y = torch.floor(p_h[..., 1] + 0.5)
    ok = ((x >= 0) & (x < Wh) & (y >= 0) & (y < Hh) & torch.isfinite(points[..., 2])
          & (z >= min_height) & (z <= max_height) & (points[..., 2] < max_distance))
    n_cells = Hh * Wh
    # rejected points (NaN coordinates among them) go to the overflow cell
    idx = torch.where(ok, y * Wh + x, float(n_cells)).to(torch.int64).reshape(-1)
    counts = _cell_sums(idx, ok, n_cells).reshape(Hh, Wh)
    zsum = _cell_sums(idx, torch.where(ok, z, 0.0), n_cells).reshape(Hh, Wh)

    old_mean, old_n, old_col = hm[..., 0], hm[..., 1], hm[..., 2]
    n_new = old_n + counts
    mean = torch.where(n_new > 0, (old_n * old_mean + zsum) / torch.clamp(n_new, min=1e-9),
                       old_mean)
    colour = old_col
    if image is not None:
        col = image.to(torch.float32)
        col_ok = ok & (col > 0)
        csum = _cell_sums(idx, torch.where(col_ok, col, 0.0), n_cells).reshape(Hh, Wh)
        ccnt = _cell_sums(idx, col_ok, n_cells).reshape(Hh, Wh)
        ncol = old_n + ccnt
        colour = torch.where(ccnt > 0, (old_n * old_col + csum) / torch.clamp(ncol, min=1e-9),
                             old_col)
    return torch.stack([mean, n_new, colour, torch.zeros_like(mean)], dim=-1)


def _grid(hm: torch.Tensor):
    Hh, Wh = hm.shape[:2]
    return torch.meshgrid(torch.arange(Hh, dtype=torch.float32, device=hm.device),
                          torch.arange(Wh, dtype=torch.float32, device=hm.device), indexing="ij")


def vbo_from_heightmap(hm: torch.Tensor) -> torch.Tensor:
    """(u, v, height, 1) grid points; height NaN where the cell is empty."""
    v, u = _grid(hm)
    z = torch.where(hm[..., 1] > 0, hm[..., 0], float("nan"))
    return torch.stack([u, v, z, torch.ones_like(z)], dim=-1)


def vbo_world_from_heightmap(hm: torch.Tensor, T_wh: torch.Tensor) -> torch.Tensor:
    """World-frame grid points (x, y, z, 1) through T_wh (3, 4)."""
    v, u = _grid(hm)
    Pw = se3.transform(T_wh, torch.stack([u, v, hm[..., 0]], dim=-1))
    return torch.cat([Pw, torch.ones(hm.shape[:2] + (1,), dtype=torch.float32,
                                     device=hm.device)], dim=-1)


def _grey(hm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(hm[..., 2], 0, 255).to(torch.uint8)


def colour_heightmap(hm: torch.Tensor) -> torch.Tensor:
    """RGBA uint8 colour of each cell, alpha 0 where seen fewer than 2 times."""
    c = _grey(hm)
    a = torch.where(hm[..., 1] < 2, 0, 255).to(torch.uint8)
    return torch.stack([c, c, c, a], dim=-1)


def generate_world_vbo_and_image(hm: torch.Tensor, T_wh: torch.Tensor):
    """The world-frame vertex grid and the grey uint8 image of the cells."""
    return vbo_world_from_heightmap(hm, T_wh), _grey(hm)


def triangle_strip_index_buffer(w: int, h: int) -> np.ndarray:
    """Serpentine triangle-strip index buffer (uint32, NumPy) for an (h, w)
    grid of vertices: it feeds mesh export on the host."""
    idx = []
    for y in range(h - 1):
        xs = range(w) if y % 2 == 0 else range(w - 1, -1, -1)
        for x in xs:
            idx.append(y * w + x)
            idx.append((y + 1) * w + x)
    return np.asarray(idx, np.uint32)


class HeightmapFusion:
    """A heightmap with its world -> grid transform T_hw: cells are
    ``cell_size`` world units, and T_hw maps a world point to cell
    coordinates. Lives on ``device`` (the card unless the caller asks for
    another device)."""

    def __init__(self, width_units: float, height_units: float, cell_size: float, T_hw=None,
                 device="cuda"):
        self.cell_size = cell_size
        self.w = int(round(width_units / cell_size))
        self.h = int(round(height_units / cell_size))
        scale = 1.0 / cell_size
        S = np.diag([scale, scale, 1.0]).astype(np.float32)
        base = (np.eye(3, 4, dtype=np.float32) if T_hw is None
                else np.asarray(T_hw.cpu() if torch.is_tensor(T_hw) else T_hw, np.float32))
        self.T_hw = torch.from_numpy(
            np.concatenate([S @ base[:, :3], S @ base[:, 3:]], 1)).to(device)
        self.hm = init_heightmap(self.w, self.h, device=device)

    def fuse(self, points_world: torch.Tensor, image=None, min_height=-1e10, max_height=1e10,
             max_distance=1e10) -> torch.Tensor:
        """Bin world-frame points (H, W, 4) into the grid."""
        self.hm = update_heightmap(self.hm, points_world, image, self.T_hw, min_height,
                                   max_height, max_distance)
        return self.hm

    def world_vbo(self):
        """World-frame vertex grid and grey image of the cells."""
        T = self.T_hw.cpu().numpy()
        Rinv = np.linalg.inv(T[:, :3])
        T_wh = np.concatenate([Rinv, -(Rinv @ T[:, 3])[:, None]], 1).astype(np.float32)
        return generate_world_vbo_and_image(self.hm, torch.from_numpy(T_wh).to(self.hm.device))

    def save_mesh(self, path: str) -> int:
        """Export the world-frame vertex grid as a binary PLY triangle soup:
        the serpentine triangle strip's triangles, degenerate ones dropped.
        Returns the triangle count."""
        from ..fusion.marching_cubes import save_ply

        vbo, _ = self.world_vbo()
        verts = vbo[..., :3].reshape(-1, 3).cpu().numpy()
        idx = triangle_strip_index_buffer(self.w, self.h).astype(np.int64)
        a, b, c = idx[:-2], idx[1:-1], idx[2:]
        keep = (a != b) & (b != c) & (a != c)
        tris = np.stack([verts[a[keep]], verts[b[keep]], verts[c[keep]]], axis=1)
        save_ply(path, tris.astype(np.float32).reshape(-1, 3, 3))
        return len(tris)
