"""Classic 256-case marching cubes with a case table derived at import
(``kangaroo_tpu/fusion/marching_cubes256.py``).

The mesh-level alternative to the marching-tetrahedra extractor
(``fusion/marching_cubes.py``): one triangle fan per surface loop through
each cube, so triangles follow the cube's case, about a third of the
tetrahedra's count. The 256-case tables are derived at import
(``_build_tables``), as in the JAX package:

1. For each corner-sign case, every cube face contributes one surface
   segment per maximal cyclic run of inside corners along its boundary (the
   segment joins the two sign-change edges that bound the run). The rule
   depends only on the face's own corner signs, so two cubes that share a
   face agree and the mesh is watertight, the ambiguous faces included (on
   those the outside corners are always separated).
2. The segments chain into closed loops (every active edge lies on two
   faces, hence in two segments).
3. Each loop is fan-triangulated from its first vertex, its orientation
   fixed against the trilinear gradient of a representative field
   (inside -1, outside +1), so triangles face the val > iso side, the tet
   mesher's convention.

Two extractors with the same output: a vectorised NumPy one (the golden
model, line for line the JAX package's) and the native C++ core
(``native/marching_cubes256.cpp``, the port's copy), built with g++ at
first use and handed the derived tables through ctypes, so Python stays the
single source of the cases. ``use_native`` None or True runs the core and
raises if it cannot be built; nothing falls back.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import _build
from . import marching_cubes as _mt

# corner i sits at (x, y, z) = (i & 1, (i >> 1) & 1, (i >> 2) & 1) — the
# same corner indexing as the tet mesher (marching_cubes._TETS).
_CORNERS = np.array([(i & 1, (i >> 1) & 1, (i >> 2) & 1) for i in range(8)],
                    np.int32)

# the 12 cube edges as (corner, corner), grouped x-, y-, z-aligned
_EDGES = [(0, 1), (2, 3), (4, 5), (6, 7),
          (0, 2), (1, 3), (4, 6), (5, 7),
          (0, 4), (1, 5), (2, 6), (3, 7)]
_EDGE_INDEX = {e: i for i, e in enumerate(_EDGES)}
_EDGE_INDEX.update({(b, a): i for (a, b), i in list(_EDGE_INDEX.items())})

# the 6 faces, corners in CCW order viewed from OUTSIDE the cube
_FACES = [
    (4, 5, 7, 6),  # z = 1, outward +z
    (0, 2, 3, 1),  # z = 0, outward -z
    (1, 3, 7, 5),  # x = 1, outward +x
    (0, 4, 6, 2),  # x = 0, outward -x
    (2, 6, 7, 3),  # y = 1, outward +y
    (0, 1, 5, 4),  # y = 0, outward -y
]


def _face_segments(face, inside):
    """Surface segments on one face: for each maximal cyclic run of inside
    corners, the (edge, edge) pair bounding the run. Depends only on this
    face's corner signs -> adjacent cubes always agree (watertight)."""
    ins = [inside[c] for c in face]
    if all(ins) or not any(ins):
        return []
    segs = []
    for s in range(4):
        # s starts a run: inside, and predecessor outside
        if ins[s] and not ins[s - 1]:
            e = s
            while ins[(e + 1) % 4]:
                e = (e + 1) % 4
            start_edge = _EDGE_INDEX[(face[s - 1], face[s])]
            end_edge = _EDGE_INDEX[(face[e], face[(e + 1) % 4])]
            segs.append((start_edge, end_edge))
    return segs


def _trace_loops(segs):
    """Chain undirected (edge, edge) segments into closed loops of edge
    indices. Every active edge appears in exactly two segments (one per
    adjacent face), so the graph is a disjoint union of cycles."""
    adj = {}
    for a, b in segs:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    unused = {k: list(v) for k, v in adj.items()}
    loops = []
    while any(unused.values()):
        start = next(k for k, v in unused.items() if v)
        loop = [start]
        prev, cur = None, start
        while True:
            nxt = next(n for n in unused[cur] if n != prev or
                       unused[cur].count(n) > 1)
            unused[cur].remove(nxt)
            unused[nxt].remove(cur)
            if nxt == start:
                break
            loop.append(nxt)
            prev, cur = cur, nxt
        loops.append(loop)
    return loops


def _build_tables():
    """Derive the 256-case triangle table: tri_table[case] is a flat list
    of edge indices, 3 per triangle. Winding is fixed against the
    trilinear gradient of the representative field (inside=-1, out=+1)."""
    corner_pos = _CORNERS.astype(np.float64)
    edge_mid = np.array([(corner_pos[a] + corner_pos[b]) / 2.0
                         for a, b in _EDGES])
    table = []
    for case in range(256):
        inside = [(case >> i) & 1 == 1 for i in range(8)]
        segs = []
        for face in _FACES:
            segs += _face_segments(face, inside)
        tris = []
        vals = np.where([inside[i] for i in range(8)], -1.0, 1.0)
        for loop in _trace_loops(segs):
            pts = edge_mid[loop]
            centroid = pts.mean(axis=0)
            # Newell normal of the loop polygon
            nrm = np.zeros(3)
            for i in range(len(loop)):
                p, q = pts[i], pts[(i + 1) % len(loop)]
                nrm += np.cross(p, q)
            # trilinear gradient at the centroid points inside -> outside
            x, y, z = centroid
            g = np.zeros(3)
            for ci in range(8):
                cx, cy, cz = corner_pos[ci]
                wx = cx * x + (1 - cx) * (1 - x)
                wy = cy * y + (1 - cy) * (1 - y)
                wz = cz * z + (1 - cz) * (1 - z)
                dv = vals[ci]
                g += dv * np.array([(2 * cx - 1) * wy * wz,
                                    (2 * cy - 1) * wx * wz,
                                    (2 * cz - 1) * wx * wy])
            if np.dot(nrm, g) < 0:
                loop = loop[::-1]
            for k in range(1, len(loop) - 1):
                tris += [loop[0], loop[k], loop[k + 1]]
        table.append(tris)
    return table


_TRI_TABLE = _build_tables()
# flat/packed form for the native core and the vectorized extractor
_TRI_FLAT = np.concatenate(
    [np.asarray(t, np.int32) if t else np.zeros(0, np.int32)
     for t in _TRI_TABLE]).astype(np.int32)
_TRI_OFFSET = np.zeros(257, np.int32)
for _c in range(256):
    _TRI_OFFSET[_c + 1] = _TRI_OFFSET[_c] + len(_TRI_TABLE[_c])
_MAX_TRIS = max(len(t) // 3 for t in _TRI_TABLE)

_EDGE_A = np.array([a for a, _ in _EDGES], np.int32)
_EDGE_B = np.array([b for _, b in _EDGES], np.int32)


def native_library() -> ctypes.CDLL:
    """The 256-case core, built on first call; raises if g++ fails."""
    lib = _build.host_library("marching_cubes256")
    pf = ctypes.POINTER(ctypes.c_float)
    pi = ctypes.POINTER(ctypes.c_int32)
    lib.mc_extract.restype = ctypes.c_int64
    lib.mc_extract.argtypes = [
        pf, pf,                                      # vol, weight|null
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,   # d h w
        pf, pf, ctypes.c_float, ctypes.c_float,      # lo hi iso wmin
        pi, pi, pi, pi,                              # tri_flat offs ea eb
        ctypes.POINTER(pf),
    ]
    lib.mc_free.argtypes = [pf]
    return lib


def _extract_numpy(vol, weight, lo, hi, iso, wmin):
    """Vectorized table-driven extraction; the golden model for the C++
    core (same structure as marching_cubes._extract_numpy)."""
    D, H, W = vol.shape
    sx = (hi[0] - lo[0]) / (W - 1)
    sy = (hi[1] - lo[1]) / (H - 1)
    sz = (hi[2] - lo[2]) / (D - 1)
    z, y, x = np.mgrid[0:D - 1, 0:H - 1, 0:W - 1]
    z, y, x = z.ravel(), y.ravel(), x.ravel()
    cx = x[:, None] + _CORNERS[None, :, 0]
    cy = y[:, None] + _CORNERS[None, :, 1]
    cz = z[:, None] + _CORNERS[None, :, 2]
    cv = vol[cz, cy, cx]  # (N, 8)
    if weight is not None:
        valid = (weight[cz, cy, cx] > wmin).all(axis=1)
    else:
        valid = np.ones(len(cv), bool)
    code = ((cv < iso) << np.arange(8)).sum(axis=1)
    # pure float32, same expression order as the C++ core -> bit-identical
    # (int index arrays would silently promote the products to float64)
    sx32, sy32, sz32 = np.float32(sx), np.float32(sy), np.float32(sz)
    px = np.float32(lo[0]) + sx32 * cx.astype(np.float32)
    py = np.float32(lo[1]) + sy32 * cy.astype(np.float32)
    pz = np.float32(lo[2]) + sz32 * cz.astype(np.float32)
    cp = np.stack([px, py, pz], axis=-1)  # (N, 8, 3)

    tris = []
    for case in range(1, 255):
        edges = _TRI_TABLE[case]
        if not edges:
            continue
        sel = valid & (code == case)
        if not sel.any():
            continue
        v = cv[sel]
        p = cp[sel]
        pts = []
        for e in edges:
            a, b = _EDGES[e]
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
    """Classic-MC isosurface of host arrays (``marching_cubes.volume_arrays``'
    output): (ntri, 3, 3) float32 triangle soup in world units. ``use_native``
    None or True runs the C++ core (raising if it cannot be built), False
    the NumPy extractor."""
    if use_native is False:
        return _extract_numpy(data, weight, lo, hi, iso, weight_min)
    lib = native_library()
    pi = ctypes.POINTER(ctypes.c_int32)
    tables = [t.ctypes.data_as(pi) for t in (_TRI_FLAT, _TRI_OFFSET, _EDGE_A, _EDGE_B)]
    return _mt.native_extract(lib.mc_extract, lib.mc_free, data, weight, lo, hi, iso, weight_min,
                              *tables)


def extract_mesh(vol, iso=0.0, weight_min=0.0, use_native: bool | None = None) -> np.ndarray:
    """Classic-MC isosurface of a TsdfVolume / BoundedVolume (on any device):
    the drop-in alternative to ``marching_cubes.extract_mesh`` with one
    triangulation a cube case."""
    return extract_arrays(*_mt.volume_arrays(vol), iso, weight_min, use_native)
