"""Host-side isosurface extraction and mesh export
(``kangaroo_tpu/fusion/marching_cubes.py``).

Marching tetrahedra (6 tets a cube sharing the main diagonal): the case
table is derivable and unambiguous and the mesh watertight, at about twice
the triangles of classic marching cubes (``marching_cubes256``). The volume
may lie on the card: ``volume_arrays`` copies its data and weight to the
host once, and the extraction runs there, as in the JAX package.

Two extractors with the same output:
  * the native C++ core (``native/marching_tets.cpp``, the port's own copy
    of the JAX package's), built with g++ at first use into ``_build/``
    (``_build.host_library``) and called through ctypes: the default. A
    failed build raises with g++'s output; nothing falls back;
  * a vectorised NumPy extractor (``use_native=False``), the golden model,
    line for line the JAX package's.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build

_PF = ctypes.POINTER(ctypes.c_float)

# Same tetrahedral decomposition as the C++ (kTets)
_TETS = np.array(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]],
    np.int32,
)

# triangle emission table: for each 4-bit inside-code, the edges (pairs of
# tet-vertex indices) of its triangles; mirrors the C++ switch. Every kTets
# entry is positively oriented, and each case's triangles are ordered so
# their normals point toward the val > iso side.
_CASES = {
    1: [(0, 1), (0, 2), (0, 3)],
    14: [(0, 2), (0, 1), (0, 3)],
    2: [(1, 0), (1, 3), (1, 2)],
    13: [(1, 3), (1, 0), (1, 2)],
    4: [(2, 0), (2, 1), (2, 3)],
    11: [(2, 1), (2, 0), (2, 3)],
    8: [(3, 0), (3, 2), (3, 1)],
    7: [(3, 2), (3, 0), (3, 1)],
    3: [(0, 2), (1, 3), (1, 2), (0, 2), (0, 3), (1, 3)],
    12: [(1, 2), (1, 3), (0, 2), (1, 3), (0, 3), (0, 2)],
    5: [(0, 1), (2, 1), (2, 3), (0, 1), (2, 3), (0, 3)],
    10: [(2, 3), (2, 1), (0, 1), (0, 3), (2, 3), (0, 1)],
    6: [(1, 0), (2, 3), (2, 0), (1, 0), (1, 3), (2, 3)],
    9: [(2, 0), (2, 3), (1, 0), (2, 3), (1, 3), (1, 0)],
}


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a NumPy array on the host."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def native_library() -> ctypes.CDLL:
    """The marching-tetrahedra core, built on first call; raises if g++ fails."""
    lib = _build.host_library("marching_tets")
    lib.mt_extract.restype = ctypes.c_int64
    lib.mt_extract.argtypes = [
        _PF, _PF,  # vol, weight (nullable)
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # d h w
        _PF, _PF,  # lo, hi
        ctypes.c_float, ctypes.c_float,  # iso, wmin
        ctypes.POINTER(_PF),
    ]
    lib.mt_free.argtypes = [_PF]
    return lib


def volume_arrays(vol):
    """(data, weight or None, lo, hi) of a TsdfVolume (val and weight) or a
    BoundedVolume (data, no weight) as float32 NumPy arrays: one copy of
    each tensor to the host."""
    from ..containers.volume import TsdfVolume

    f32 = lambda x: _host(x).astype(np.float32, copy=False)  # noqa: E731
    if isinstance(vol, TsdfVolume):
        data, weight = f32(vol.val), f32(vol.weight)
    else:
        data, weight = f32(vol.data), None
    return data, weight, f32(vol.bbox.lo), f32(vol.bbox.hi)


def _as_float_ptr(a: np.ndarray):
    return a.ctypes.data_as(_PF)


def native_extract(extract, free, data, weight, lo, hi, iso, wmin, *tables) -> np.ndarray:
    """Call a native core ``extract`` on host arrays and copy its malloc'd
    triangles into an (ntri, 3, 3) float32 array (``free`` releases them)."""
    data_c = np.ascontiguousarray(data, np.float32)
    weight_c = None if weight is None else np.ascontiguousarray(weight, np.float32)
    lo_c = np.ascontiguousarray(lo, np.float32)
    hi_c = np.ascontiguousarray(hi, np.float32)
    out = _PF()
    wptr = _as_float_ptr(weight_c) if weight_c is not None else _PF()
    d, h, w = data_c.shape
    n = extract(_as_float_ptr(data_c), wptr, d, h, w, _as_float_ptr(lo_c), _as_float_ptr(hi_c),
                ctypes.c_float(iso), ctypes.c_float(wmin), *tables, ctypes.byref(out))
    try:
        if n == 0:
            return np.zeros((0, 3, 3), np.float32)
        return np.ctypeslib.as_array(out, shape=(n, 3, 3)).copy()
    finally:
        free(out)


def _extract_numpy(vol, weight, lo, hi, iso, wmin):
    D, H, W = vol.shape
    sx = (hi[0] - lo[0]) / (W - 1)
    sy = (hi[1] - lo[1]) / (H - 1)
    sz = (hi[2] - lo[2]) / (D - 1)

    # gather cube corner values/positions for all cells: (Ncell, 8)
    z, y, x = np.mgrid[0 : D - 1, 0 : H - 1, 0 : W - 1]
    z, y, x = z.ravel(), y.ravel(), x.ravel()
    corners = np.array([(i & 1, (i >> 1) & 1, (i >> 2) & 1) for i in range(8)])
    cx = x[:, None] + corners[None, :, 0]
    cy = y[:, None] + corners[None, :, 1]
    cz = z[:, None] + corners[None, :, 2]
    cv = vol[cz, cy, cx]  # (N, 8)
    if weight is not None:
        valid = (weight[cz, cy, cx] > wmin).all(axis=1)
    else:
        valid = np.ones(len(cv), bool)
    px = lo[0] + sx * cx
    py = lo[1] + sy * cy
    pz = lo[2] + sz * cz
    cp = np.stack([px, py, pz], axis=-1)  # (N, 8, 3)

    tris = []
    for tet in _TETS:
        tv = cv[:, tet]  # (N, 4)
        tp = cp[:, tet]  # (N, 4, 3)
        code = ((tv < iso) << np.arange(4)).sum(axis=1)
        for c, edges in _CASES.items():
            sel = valid & (code == c)
            if not sel.any():
                continue
            v = tv[sel]
            p = tp[sel]
            pts = []
            for a, b in edges:
                t = (iso - v[:, a]) / (v[:, b] - v[:, a])
                t = np.clip(t, 0.0, 1.0)[:, None]
                pts.append(p[:, a] + t * (p[:, b] - p[:, a]))
            tri = np.stack(pts, axis=1).reshape(len(v), -1, 3, 3)
            tris.append(tri.reshape(-1, 3, 3))
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(tris, axis=0).astype(np.float32)


def extract_arrays(data, weight, lo, hi, iso=0.0, weight_min=0.0,
                   use_native: bool | None = None) -> np.ndarray:
    """The isosurface of host arrays (``volume_arrays``' output): (ntri, 3, 3)
    float32 triangle soup in world units; voxels whose weight is at most
    ``weight_min`` count as empty. ``use_native`` None or True runs the C++
    core (raising if it cannot be built), False the NumPy extractor."""
    if use_native is False:
        return _extract_numpy(data, weight, lo, hi, iso, weight_min)
    lib = native_library()
    return native_extract(lib.mt_extract, lib.mt_free, data, weight, lo, hi, iso, weight_min)


def extract_mesh(vol, iso=0.0, weight_min=0.0, use_native: bool | None = None) -> np.ndarray:
    """Extract the isosurface of a TsdfVolume / BoundedVolume (on any device):
    (ntri, 3, 3) float32 NumPy triangle soup in world units. TSDF weights
    gate empty voxels."""
    return extract_arrays(*volume_arrays(vol), iso, weight_min, use_native)


def save_ply(path: str, tris: np.ndarray) -> None:
    """Write a triangle soup as binary little-endian PLY: every triangle its
    own three vertices."""
    verts = tris.reshape(-1, 3)
    nf = len(tris)
    with open(path, "wb") as f:
        f.write(
            (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {nf}\n"
                "property list uchar int vertex_indices\nend_header\n"
            ).encode()
        )
        f.write(verts.astype("<f4").tobytes())
        faces = np.empty(nf, dtype=[("n", "u1"), ("i", "<i4", 3)])
        faces["n"] = 3
        faces["i"] = np.arange(nf * 3, dtype=np.int32).reshape(nf, 3)
        f.write(faces.tobytes())


def load_ply(path: str):
    """Read back a PLY written by :func:`save_ply`: (vertices (n, 3) float32,
    faces (m, 3) int32)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header in the PLY header")
            header += line
        lines = header.decode().splitlines()
        nv = int(next(l.split()[-1] for l in lines if l.startswith("element vertex")))
        nf = int(next(l.split()[-1] for l in lines if l.startswith("element face")))
        verts = np.frombuffer(f.read(nv * 12), "<f4").reshape(nv, 3)
        faces = np.frombuffer(f.read(nf * 13), dtype=[("n", "u1"), ("i", "<i4", 3)])
    return verts, faces["i"]


def save_vbo_ply(path: str, points, colors=None) -> None:
    """Export a point image / vertex grid (..., 3|4) as a PLY point cloud of
    its finite points, coloured by ``colors`` (..., 3) uint8 if given.
    Tensors on any device are copied to the host."""
    points = _host(points)
    pts = np.asarray(points, np.float32).reshape(-1, points.shape[-1])[:, :3]
    ok = np.isfinite(pts).all(axis=1)
    pts = pts[ok]
    cols = None
    if colors is not None:
        colors = _host(colors)
        cols = np.asarray(colors).reshape(-1, colors.shape[-1])[:, :3][ok]
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(pts)}",
               "property float x", "property float y", "property float z"]
        if cols is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += ["end_header", ""]
        f.write("\n".join(hdr).encode())
        if cols is None:
            f.write(pts.astype("<f4").tobytes())
        else:
            rec = np.empty(len(pts), dtype=[("p", "<f4", 3), ("c", "u1", 3)])
            rec["p"] = pts
            rec["c"] = cols
            f.write(rec.tobytes())


def save_meshlab_project(path: str, mesh_files) -> None:
    """Write a minimal MeshLab project that references the exported meshes."""
    layers = "\n".join(
        f'  <MLMesh label="{os.path.basename(m)}" filename="{m}">\n  </MLMesh>'
        for m in mesh_files
    )
    with open(path, "w") as f:
        f.write(
            "<!DOCTYPE MeshLabDocument>\n<MeshLabProject>\n <MeshGroup>\n"
            f"{layers}\n </MeshGroup>\n</MeshLabProject>\n"
        )
