"""Meshing and mesh files of kangaroo_tpu_torch against kangaroo_tpu's on the
CPU: marching tetrahedra and the 256-case marching cubes (both the native
C++ cores, built by each package from its own copy of the same source with
the same g++ flags, and the NumPy extractors), and the PLY and MeshLab
writers, on seeded 16^3-32^3 volumes.

Tolerances: triangles bit-equal, native against native and NumPy against
NumPy; files byte-equal. The port's native core against its NumPy
extractor is held to the JAX package's own bar for the same pair: the
256-case cores the same triangles in another order (exactly, as sorted
sets), the tetrahedra the same count and sorted vertex coordinates within
1e-5 (its NumPy extractor forms the corners' positions in float64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kangaroo_tpu as kt
from kangaroo_tpu.fusion import marching_cubes as jmc
from kangaroo_tpu.fusion import marching_cubes256 as jmc256
from kangaroo_tpu.fusion import sdf as jsdf
from kangaroo_tpu_torch import _build
from kangaroo_tpu_torch.containers import BoundedVolume, BoundingBox, TsdfVolume
from kangaroo_tpu_torch.fusion import marching_cubes as tmc
from kangaroo_tpu_torch.fusion import marching_cubes256 as tmc256

MESHERS = {"tet": (jmc, tmc), "mc": (jmc256, tmc256)}


def volumes(shape=(20, 24, 28), seed=0):
    """A sphere TSDF on an off-centre box (D, H, W) with a patch of
    unobserved (weight 0) voxels and seeded noise on the values, in both
    packages: (JAX TsdfVolume, port TsdfVolume)."""
    rng = np.random.default_rng(seed)
    bbox = kt.BoundingBox.create((-1.0, -0.8, -0.6), (1.1, 0.9, 1.3))
    jv = jsdf.sdf_sphere(kt.TsdfVolume.create(shape[2], shape[1], shape[0], bbox, trunc_dist=0.3),
                         (0.05, 0.0, 0.3), 0.55)
    val = np.asarray(jv.val) + rng.normal(0, 0.01, shape).astype(np.float32)
    weight = np.asarray(jv.weight).copy()
    weight[: shape[0] // 3, : shape[1] // 2] = 0.0
    jv = kt.TsdfVolume(jnp.asarray(val), jnp.asarray(weight), bbox)
    box = BoundingBox.create(np.asarray(bbox.lo), np.asarray(bbox.hi), device="cpu")
    return jv, TsdfVolume(torch.from_numpy(val), torch.from_numpy(weight), box)


def canonical(tris):
    flat = tris.reshape(len(tris), 9)
    return flat[np.lexsort(flat.T[::-1])]


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("method", list(MESHERS))
def test_extract_mesh_matches_jax(method, use_native):
    jm, tm = MESHERS[method]
    jv, tv = volumes()
    for iso, wmin in ((0.0, 0.0), (0.05, 0.5)):
        want = jm.extract_mesh(jv, iso, wmin, use_native=use_native)
        got = tm.extract_mesh(tv, iso, wmin, use_native=use_native)
        assert got.dtype == np.float32 and got.shape[1:] == (3, 3) and len(got) > 200
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", list(MESHERS))
def test_bounded_volume_mesh_matches_jax(method):
    """A BoundedVolume (no weight gate), on a 16^3 grid."""
    jm, tm = MESHERS[method]
    jv, _ = volumes((16, 16, 16), seed=1)
    data = np.array(jv.val)
    jb = kt.BoundedVolume(jnp.asarray(data), jv.bbox)
    tb = BoundedVolume(torch.from_numpy(data),
                       BoundingBox.create(np.asarray(jv.bbox.lo), np.asarray(jv.bbox.hi),
                                          device="cpu"))
    for use_native in (True, False):
        np.testing.assert_array_equal(tm.extract_mesh(tb, use_native=use_native),
                                      jm.extract_mesh(jb, use_native=use_native))


def test_native_matches_numpy_extractor():
    _, tv = volumes((32, 32, 32), seed=2)
    mc_native, mc_numpy = (tmc256.extract_mesh(tv, use_native=n) for n in (True, False))
    np.testing.assert_array_equal(canonical(mc_native), canonical(mc_numpy))
    tet_native, tet_numpy = (tmc.extract_mesh(tv, use_native=n) for n in (None, False))
    assert len(tet_native) == len(tet_numpy) > 3 * len(mc_native) / 2
    np.testing.assert_allclose(np.sort(tet_native.reshape(-1, 3), axis=0),
                               np.sort(tet_numpy.reshape(-1, 3), axis=0), atol=1e-5, rtol=0)
    # the default (use_native=None) is the native core
    np.testing.assert_array_equal(tmc.extract_mesh(tv), tet_native)
    np.testing.assert_array_equal(tmc256.extract_mesh(tv), mc_native)


def test_split_copy_and_extract_equals_extract_mesh():
    _, tv = volumes()
    arrays = tmc.volume_arrays(tv)
    assert [a.dtype for a in arrays] == [np.float32] * 4
    np.testing.assert_array_equal(tmc.extract_arrays(*arrays), tmc.extract_mesh(tv))
    np.testing.assert_array_equal(tmc256.extract_arrays(*arrays), tmc256.extract_mesh(tv))
    empty = TsdfVolume(tv.val, torch.zeros_like(tv.weight), tv.bbox)
    for tm in (tmc, tmc256):
        for use_native in (True, False):
            assert tm.extract_mesh(empty, use_native=use_native).shape == (0, 3, 3)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No quiet NumPy fallback: a core that does not compile raises with
    g++'s output, for use_native None and True alike."""
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "marching_tets.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path / "native")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_host_libs", {})
    _, tv = volumes((8, 8, 8))
    for use_native in (None, True):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            tmc.extract_mesh(tv, use_native=use_native)
    assert len(tmc.extract_mesh(tv, use_native=False)) > 0


@pytest.mark.parametrize("method", list(MESHERS))
def test_ply_files_match_jax(method, tmp_path):
    jm, tm = MESHERS[method]
    jv, tv = volumes((16, 18, 20), seed=3)
    tris = tm.extract_mesh(tv)
    tmc.save_ply(str(tmp_path / "t.ply"), tris)
    jmc.save_ply(str(tmp_path / "j.ply"), jm.extract_mesh(jv))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    verts, faces = tmc.load_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(verts.reshape(-1, 3, 3), tris)
    np.testing.assert_array_equal(faces, np.arange(3 * len(tris)).reshape(-1, 3))
    jverts, jfaces = jmc.load_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)


@pytest.mark.parametrize("colour", [False, True])
def test_vbo_ply_matches_jax(colour, tmp_path):
    """A (H, W, 4) point image with NaN holes, optionally coloured; the port
    takes tensors."""
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 1, (12, 16, 4)).astype(np.float32)
    pts[rng.random((12, 16)) < 0.2] = np.nan
    cols = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8) if colour else None
    tmc.save_vbo_ply(str(tmp_path / "t.ply"), torch.from_numpy(pts),
                     None if cols is None else torch.from_numpy(cols))
    jmc.save_vbo_ply(str(tmp_path / "j.ply"), jnp.asarray(pts),
                     None if cols is None else jnp.asarray(cols))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_meshlab_project_matches_jax(tmp_path):
    files = [str(tmp_path / "a.ply"), "meshes/b.ply"]
    tmc.save_meshlab_project(str(tmp_path / "t.mlp"), files)
    jmc.save_meshlab_project(str(tmp_path / "j.mlp"), files)
    assert (tmp_path / "t.mlp").read_bytes() == (tmp_path / "j.mlp").read_bytes()


def test_tables_match_jax():
    """The derived 256-case tables, their packed form and the tet cases."""
    assert tmc256._TRI_TABLE == jmc256._TRI_TABLE
    for name in ("_TRI_FLAT", "_TRI_OFFSET", "_EDGE_A", "_EDGE_B"):
        np.testing.assert_array_equal(getattr(tmc256, name), getattr(jmc256, name))
    assert tmc256._MAX_TRIS == jmc256._MAX_TRIS
    np.testing.assert_array_equal(tmc._TETS, jmc._TETS)
    assert tmc._CASES == jmc._CASES
